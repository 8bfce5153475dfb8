"""K-e + K-f: detect's per-read core after K1, packed (reference:
find_circ2_tpu/models/pipeline.py detect_core and its packing,
find_circ2_tpu/ops/breakpoint.py breakpoint_search; SPEC.md §3, §4 and
§6 fix the semantics).

Given both anchors' hits, each read gets the §6 contiguous prefilter at
both anchor placements, pairing and strand canonicalization, its
chromosome, K2's best split over two (Lp+2)-wide genome windows, the
frozen status priority and `multi`, as one int32 row in PACK_FIELDS
order. On the card that is one hand-written CUDA kernel per batch
(csrc/detect.cu, sixteen lanes per read; its header says why), which
builds each read's reverse complement from the read's own row; a CPU
tensor takes the plain version, `detect_core_packed_ref` (`detect_core`
on the reverse complements of `_revcomp_device`, then `_pack`).
`detect_core` is also the unpacked entries' core. The fallback-overflow
flag of K1 v4 is a 0-d device bool that the kernel ORs into `multi` bit
3, so no host sync is added.
"""

from __future__ import annotations

import torch

from find_circ2_tpu_torch import _build
from find_circ2_tpu_torch.config import (
    RPAD_CODE,
    Config,
    KIND_CIRCULAR,
    KIND_LINEAR,
    ST_ANCHOR_OVERLAP,
    ST_DIFF_CHROM,
    ST_DIFF_STRAND,
    ST_JUNCTION,
    ST_NO_JUNCTION,
    ST_PREFILTERED,
    ST_UNALIGNED_A,
    ST_UNALIGNED_B,
)
from find_circ2_tpu_torch.index.hashtable import M32
from find_circ2_tpu_torch.ops.breakpoint import as_int32, breakpoint_search
from find_circ2_tpu_torch.ops.packed import SPARE_WORDS, gather_window

# The kernel's limit on the padded read length: its packed split keys
# stay below 2^31.
MAX_READ_LEN = 4096

# Kernel launches of detect_core_packed since the last reset (set to 0 to
# reset).
launches = 0

# What the kernel reads of each anchor's hits, in DetectArgs order, with
# the dtypes it takes.
_HIT_FIELDS = (("pos", torch.int64), ("strand", torch.int32),
               ("aligned", torch.bool), ("n_best", torch.int32),
               ("qual", torch.int32))


def _revcomp_device(reads: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """models/pipeline.revcomp_batch on the tensors' device: each read's
    left-aligned reverse complement, RPAD past its length."""
    Lp = reads.shape[1]
    pos = torch.arange(Lp, device=reads.device)[None, :]
    lens = lens.to(torch.int64)[:, None]
    r = torch.gather(reads, 1, torch.clamp(lens - 1 - pos, 0, Lp - 1))
    r = torch.where(r < 4, 3 - r, r)
    return torch.where(pos < lens, r, RPAD_CODE).to(torch.uint8)


def _full_read_mm(words, nbases: int, query, start, lens) -> torch.Tensor:
    """Hamming(query[:l], genome[start:start+l]) per row (SPEC.md §6)."""
    Lp = query.shape[1]
    pos = torch.arange(Lp, device=query.device)[None, :]
    win = gather_window(words, torch.clamp(start, 0, nbases - Lp), Lp)
    q = query.to(torch.int32)
    neq = ((q != win) | (q >= 4) | (win >= 4)) & (pos < lens[:, None])
    return neq.sum(1, dtype=torch.int32)


def detect_core(words, nbases: int, chrom_offsets, reads, lens, hits_a,
                hits_b, cfg: Config, prefilter: bool, rc=None) -> dict:
    """Pairing, prefilter, K2 and status resolution given anchor hits.

    Row status follows the oracle's priority order exactly [FROZEN]:
    prefiltered > unaligned_A > unaligned_B > diff_strand > diff_chrom >
    anchors_overlap > no_junction > junction. `rc` is each read's
    left-aligned reverse complement (revcomp_batch); None builds it with
    `_revcomp_device`.
    """
    if rc is None:
        rc = _revcomp_device(reads, lens)
    B = reads.shape[0]
    a = cfg.anchor_len
    dev = reads.device
    lens_u = lens.to(torch.int64)

    # Pass-1 contiguous prefilter (SPEC.md §6).
    if prefilter:
        fwd_a = (hits_a.strand == 0)
        qa = torch.where(fwd_a[:, None], reads, rc)
        sa = torch.where(fwd_a, hits_a.pos, (hits_a.pos + a - lens_u) & M32)
        mma = _full_read_mm(words, nbases, qa, sa, lens)
        fwd_b = (hits_b.strand == 0)
        qb = torch.where(fwd_b[:, None], reads, rc)
        sb = torch.where(fwd_b, (hits_b.pos + a - lens_u) & M32, hits_b.pos)
        mmb = _full_read_mm(words, nbases, qb, sb, lens)
        contig = ((hits_a.aligned & (mma <= cfg.prefilter_mm))
                  | (hits_b.aligned & (mmb <= cfg.prefilter_mm)))
    else:
        contig = torch.zeros(B, dtype=torch.bool, device=dev)

    # Pairing + canonicalization (SPEC.md §3).
    chrom_a = torch.searchsorted(chrom_offsets, hits_a.pos, right=True) - 1
    chrom_b = torch.searchsorted(chrom_offsets, hits_b.pos, right=True) - 1
    same_strand = hits_a.strand == hits_b.strand
    same_chrom = chrom_a == chrom_b
    s = hits_a.strand
    minus = s == 1
    R = torch.where(minus[:, None], rc, reads)
    pA = torch.where(minus, hits_b.pos, hits_a.pos)
    pB = torch.where(minus, hits_a.pos, hits_b.pos)
    qual_left = torch.where(minus, hits_b.qual, hits_a.qual)
    qual_right = torch.where(minus, hits_a.qual, hits_b.qual)
    endB = (pB + a) & M32
    linear = ((pA + a) & M32) <= pB
    circular = endB <= pA
    kind = torch.where(circular, KIND_CIRCULAR, KIND_LINEAR).to(torch.int32)

    bp = breakpoint_search(words, nbases, R, lens, pA, endB, kind, s, cfg)

    # Status resolution [FROZEN priority].
    status = torch.full((B,), ST_JUNCTION, dtype=torch.int32, device=dev)
    for cond, st in ((bp["no_junction"], ST_NO_JUNCTION),
                     (~(linear | circular), ST_ANCHOR_OVERLAP),
                     (~same_chrom, ST_DIFF_CHROM),
                     (~same_strand, ST_DIFF_STRAND),
                     (~hits_b.aligned, ST_UNALIGNED_B),
                     (~hits_a.aligned, ST_UNALIGNED_A),
                     (contig, ST_PREFILTERED)):
        status = torch.where(cond, st, status)

    i32 = torch.int32
    return dict(
        status=status, kind=kind, chrom=chrom_a.to(i32),
        start=bp["start"], end=bp["end"], sense=bp["sense"],
        align_strand=s.to(i32), edits=bp["edits"], n_bp=bp["n_bp"],
        overlap=bp["overlap"], qual_left=qual_left, qual_right=qual_right,
        # Bit 0 (SPEC §2b): anchor best-hit tie -> host multi-hit
        # re-call. Bit 1: rescuable — exactly one anchor unaligned, the
        # §2 2-mm rescue's mate gate.
        multi=(((hits_a.n_best > 1) | (hits_b.n_best > 1)).to(i32)
               | ((hits_a.aligned ^ hits_b.aligned).to(i32) << 1)),
        signal=bp["signal"],
    )


# Column order of the packed per-read result row (host readback format).
PACK_FIELDS = ("status", "kind", "chrom", "start", "end", "sense",
               "align_strand", "edits", "n_bp", "overlap", "qual_left",
               "qual_right", "multi", "signal")


def _pack(res: dict) -> torch.Tensor:
    """One int32 [B, 14] row per read in PACK_FIELDS order: start/end as
    their uint32 bit patterns, the 4 signal codes (each < 8) as
    s0 | s1<<3 | s2<<6 | s3<<9."""
    sig = res["signal"]
    sig_packed = (sig[:, 0] | (sig[:, 1] << 3) | (sig[:, 2] << 6)
                  | (sig[:, 3] << 9))
    cols = [as_int32(res[k]) if k in ("start", "end")
            else res[k].to(torch.int32) for k in PACK_FIELDS[:-1]]
    return torch.stack(cols + [sig_packed.to(torch.int32)], dim=1)


def detect_core_packed_ref(words, nbases: int, chrom_offsets, reads, lens,
                           hits_a, hits_b, overflow, cfg: Config,
                           prefilter: bool) -> torch.Tensor:
    """Plain version of detect_core_packed: detect_core on the reverse
    complements `_revcomp_device` builds, the overflow flag ORed into
    `multi` bit 3, and the packing."""
    res = detect_core(words, nbases, chrom_offsets, reads, lens, hits_a,
                      hits_b, cfg, prefilter)
    if overflow is not None:
        res["multi"] = res["multi"] | (overflow.to(torch.int32) << 3)
    return _pack(res)


def _check(words, nbases: int, chrom_offsets, reads, lens, hits_a, hits_b,
           overflow) -> list:
    """Every tensor the kernel reads, in DetectArgs order (None for an
    absent overflow), after checking that it is what the kernel takes;
    raises otherwise."""
    B, Lp = reads.shape
    want = [(words, torch.int32, (words.shape[0],)),
            (chrom_offsets, torch.int64, (chrom_offsets.shape[0],)),
            (reads, torch.uint8, (B, Lp)), (lens, torch.int32, (B,)),
            (overflow, torch.bool, ())]
    for hits in (hits_a, hits_b):
        want += [(getattr(hits, f), dt, (B,)) for f, dt in _HIT_FIELDS]
    dev = reads.device
    for t, dtype, shape in want:
        if t is None and dtype is torch.bool:  # no overflow flag
            continue
        if t.device != dev:
            raise ValueError(f"detect_core_packed: a tensor on {t.device}, "
                             f"reads on {dev}; all must be on one CUDA "
                             "device")
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"detect_core_packed: want a contiguous {dtype} "
                             f"{list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"detect_core_packed: tensors on {dev}; the kernel "
                         "takes one CUDA device (CPU tensors take the plain "
                         "version)")
    if not 1 <= Lp <= MAX_READ_LEN or chrom_offsets.shape[0] < 1:
        raise ValueError(f"detect_core_packed: Lp = {Lp} (kernel: 1..."
                         f"{MAX_READ_LEN}), {chrom_offsets.shape[0]} "
                         "chromosomes")
    if not Lp + 2 <= nbases < 2 ** 32 \
            or words.shape[0] < -(-nbases // 8) + SPARE_WORDS:
        raise ValueError(f"detect_core_packed: genome of {nbases} bases in "
                         f"{words.shape[0]} words; the kernel needs "
                         f"{Lp + 2} <= n < 2^32 and ceil(n / 8) + "
                         f"{SPARE_WORDS} words (ops/packed.pack_words)")
    return [t for t, _, _ in want]


def detect_core_packed(words, nbases: int, chrom_offsets, reads, lens,
                       hits_a, hits_b, overflow, cfg: Config,
                       prefilter: bool = True) -> torch.Tensor:
    """Detect's core after K1 as int32 [B, 14] rows in PACK_FIELDS order.
    `reads` uint8 [B, Lp], `lens` int32 [B] (each in [0, Lp]),
    `hits_a`/`hits_b` the anchors' AnchorHits, `overflow` a 0-d bool ORed
    into `multi` bit 3 (or None). Each read's reverse complement is built
    from its row, by the kernel as by the plain version. CPU tensors take
    the plain version; CUDA tensors launch csrc/detect.cu on the current
    stream (one launch, no wait) or raise."""
    args = (words, nbases, chrom_offsets, reads, lens, hits_a, hits_b,
            overflow)
    tensors = [t for t in (words, chrom_offsets, reads, lens, overflow,
                           *hits_a, *hits_b) if t is not None]
    if all(t.is_cpu for t in tensors):
        return detect_core_packed_ref(*args, cfg, prefilter)
    return _launch(args, cfg, prefilter)


def _launch(args: tuple, cfg: Config, prefilter: bool,
            lib=None) -> torch.Tensor:
    """detect_core_packed on CUDA tensors: one C call into `lib` (default:
    the kernel library), made with the tensors' device current (the C
    entry refuses any other, and the default stream's null handle launches
    on the current device)."""
    global launches
    ptrs = [0 if t is None else t.data_ptr() for t in _check(*args)]
    words, nbases, chrom_offsets, reads = args[:4]
    B, Lp = reads.shape
    out = torch.empty((B, 14), dtype=torch.int32, device=reads.device)
    if B == 0:
        return out
    dev = reads.get_device()
    lib = lib or _build.load()
    with torch.cuda.device(dev):
        got = lib.fc2t_detect(_build.DETECT_ARGS.pack(
            *ptrs[:4], out.data_ptr(), *ptrs[4:],
            torch._C._cuda_getCurrentRawStream(dev), nbases, B, Lp,
            chrom_offsets.shape[0], cfg.anchor_len, cfg.prefilter_mm,
            int(prefilter), dev, 0))
    if got < 0:
        _build.check(-got, "detect_core_packed launch")
    launches += got
    return out


# The stages of csrc/detect.cu between its stage clocks
# (FC2T_DETECT_STAMPS), a warp's, and the reads a warp takes.
STAGES = ("hit-field loads", "read and window loads", "split scan",
          "finish", "row writes")
READS_PER_WARP = 2


def detect_stage_cycles(words, nbases: int, chrom_offsets, reads, lens,
                        hits_a, hits_b, overflow, cfg: Config,
                        prefilter: bool = True):
    """detect_core_packed on CUDA tensors through the measurement build of
    csrc/detect.cu: (its rows, int64 [warps, len(STAGES)] SM clock cycles
    of each warp's stages, its first lane's clock64 at the start and where
    each stage's results are first used; a warp takes READS_PER_WARP
    reads). One launch, counted on `launches`."""
    args = (words, nbases, chrom_offsets, reads, lens, hits_a, hits_b,
            overflow)
    warps = -(-reads.shape[0] // READS_PER_WARP)
    return _build.stamped("fc2t_detect_stamps", warps, len(STAGES), reads,
                          lambda lib: _launch(args, cfg, prefilter, lib))
