"""`find_circ` — the junction caller CLI on the PyTorch device path
(reference: find_circ2_tpu/cli/find_circ.py, its single-device branch).

Same flags and output as the reference, plus `--device {cuda,cpu}`.
Routed §2b multi-hit reads run on the device explore program
(pipeline.DeviceExplorer), as in the reference; only the 2-mm anchor
rescue runs on the host. The sharded (`--mesh`), multi-process
(`--nproc`) and oracle (`--backend oracle`) runs are not ported yet and
exit with an error.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

from find_circ2_tpu_torch.config import Config
from find_circ2_tpu_torch.index.build import build_index, load_index
from find_circ2_tpu_torch.io.bed import write_bed
from find_circ2_tpu_torch.io.fastq import decode_anchor_name, read_fastq
from find_circ2_tpu_torch.io.genome import Genome
from find_circ2_tpu_torch.models.aggregate import Aggregator


def reads_from_anchor_fastq(path):
    """Recover unique original reads from anchor records (codec names)."""
    seen = set()
    for rec in read_fastq(path):
        name, seq, _qual, _side = decode_anchor_name(rec.name)
        if name in seen:
            continue
        seen.add(name)
        yield name, seq


def reads_from_fastq(path):
    for rec in read_fastq(path):
        yield rec.name, rec.seq


def reads_from_sam_file(path, pe: bool, fmt: str = "sam"):
    """Unmapped primary records from SAM text or BAM; with --pe, mate-2
    reads are reverse-complemented to mate-1 orientation (SPEC.md §7)."""
    from find_circ2_tpu_torch.io.twobit import revcomp_seq
    if fmt == "bam":
        from find_circ2_tpu_torch.io.bam import reads_from_bam as reader
    else:
        from find_circ2_tpu_torch.io.sam import reads_from_sam as reader
    for name, seq, _qual, mate2 in reader(path):
        yield name, revcomp_seq(seq) if pe and mate2 else seq


def rc_stream(it):
    """Reverse-complement every read of a (name, seq) stream."""
    from find_circ2_tpu_torch.io.twobit import revcomp_seq
    for name, seq in it:
        yield name, revcomp_seq(seq)


def resolve_device(name: str):
    """torch.device for --device; cuda without a card is an error."""
    import torch
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("find_circ: --device cuda but no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    return torch.device(name)


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(
        prog="find_circ", description="detect circRNA junctions")
    p.add_argument("input", nargs="+",
                   help="anchor FASTQ from unmapped2anchors, or plain "
                   "FASTQ with --reads-format fastq; several files "
                   "(e.g. paired-end mates R1 R2) are processed as one "
                   "stream")
    p.add_argument("-G", "--genome", default=None,
                   help="genome FASTA(.gz)")
    p.add_argument("-x", "--index", default=None,
                   help="prebuilt .npz index from `index` (replaces -G)")
    p.add_argument("-o", "--output", default="-",
                   help="junction BED output (default stdout)")
    p.add_argument("-s", "--stats", default=None, help="stats file")
    p.add_argument("-p", "--prefix", default="",
                   help="prefix for junction names")
    p.add_argument("-n", "--name", default="unknown",
                   help="sample/tissue name for the tissues column")
    p.add_argument("-a", "--anchor", type=int, default=d.anchor_len)
    p.add_argument("--reads-format",
                   choices=("anchors", "fastq", "sam", "bam"),
                   default="anchors",
                   help="anchors: unmapped2anchors output; fastq: plain "
                   "reads; sam: SAM text (.gz ok); bam: binary BAM — "
                   "for sam/bam, unmapped primary records are taken")
    p.add_argument("--pe", action="store_true",
                   help="paired-end mate handling (SPEC.md §7): mate-2 "
                   "reads are reverse-complemented to mate-1 orientation "
                   "before detection. With fastq/anchors input, files "
                   "alternate R1 R2 R1 R2...; with sam input, mate 2 "
                   "comes from the 0x80 flag")
    p.add_argument("--stranded", action="store_true",
                   help="library is stranded: fill strandmatch column")
    p.add_argument("--no-prefilter", action="store_true",
                   help="input reads are already unmapped; skip the "
                   "contiguous-alignment prefilter")
    p.add_argument("--backend", choices=("device", "oracle"),
                   default="device",
                   help="device = the PyTorch path; oracle is not ported "
                   "(use find_circ2_tpu)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the detect path (cuda needs a "
                   "card; cpu runs the kernels' plain versions)")
    p.add_argument("--filter", action="store_true",
                   help="emit only junctions passing the frozen filter "
                   "stack: CIRCULAR & UNAMBIGUOUS_BP & ANCHOR_UNIQUE, "
                   ">= --min-support reads, <= --max-edits edits, "
                   "span <= --max-span (SPEC.md §5)")
    p.add_argument("--max-span", type=int, default=d.max_span)
    p.add_argument("--min-support", type=int, default=d.min_support)
    p.add_argument("--max-edits", type=int, default=d.filter_max_edits)
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--mesh", default=None, metavar="DATAxINDEX",
                   help="sharded multi-device run: not ported yet")
    p.add_argument("--nproc", type=int, default=None,
                   help="multi-process run: not ported yet")
    p.add_argument("--journal", default=None,
                   help="JSONL resume journal: completed batches replay "
                   "from disk on rerun")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timings to stderr")
    return p


def run(args) -> int:
    for flag, given in (("--mesh", args.mesh), ("--nproc", args.nproc),
                        ("--backend oracle", args.backend == "oracle")):
        if given:
            raise SystemExit(f"find_circ: {flag} is not yet ported to the "
                             "PyTorch package; use find_circ2_tpu")
    t_setup = time.perf_counter()
    device = resolve_device(args.device)
    cfg = Config(anchor_len=args.anchor,
                 prefix_len=min(12, args.anchor - 8),
                 stranded=args.stranded, batch_size=args.batch_size)
    if args.index:
        if os.path.isdir(args.index):
            from find_circ2_tpu_torch.index.build import load_index_dir
            genome, index = load_index_dir(args.index)
        else:
            genome, index = load_index(args.index)
        if index.anchor_len != cfg.anchor_len:
            raise SystemExit(f"index was built with -a {index.anchor_len}, "
                             f"run requested -a {cfg.anchor_len}")
    elif args.genome:
        genome = Genome.from_fasta(args.genome, cfg)
        index = build_index(genome, cfg)
    else:
        raise SystemExit("one of -G/--genome or -x/--index is required")
    if (args.pe and args.reads_format not in ("sam", "bam")
            and len(args.input) % 2):
        raise SystemExit("--pe expects an even number of input files "
                         "(R1 R2 pairs); SAM/BAM input carries mate "
                         "flags instead")

    def file_stream(fi: int, f: str):
        if args.reads_format in ("sam", "bam"):
            return reads_from_sam_file(f, args.pe, args.reads_format)
        reader = (reads_from_anchor_fastq if args.reads_format == "anchors"
                  else reads_from_fastq)
        it = reader(f)
        # --pe: odd-indexed files are mate-2 -> mate-1 orientation.
        return rc_stream(it) if args.pe and fi % 2 else it

    prefilter = not args.no_prefilter
    agg = Aggregator(genome, cfg)
    journal = times = None
    if args.journal:
        from find_circ2_tpu_torch.utils.journal import RunJournal
        journal = RunJournal(args.journal)
    from find_circ2_tpu_torch import native
    from find_circ2_tpu_torch.models.pipeline import DeviceIndex, run_reads
    dindex = DeviceIndex.build(genome, index, cfg, device=device)
    slowpath = (genome, index)
    if args.profile:
        from find_circ2_tpu_torch.utils.profiling import StageTimes
        times = StageTimes()
        t_stream = time.perf_counter()
        print(f"setup\t{t_stream - t_setup:.3f}s\tgenome, index and "
              "device tables", file=sys.stderr)
    if args.reads_format == "fastq" and native.available():
        # Native C FASTQ scanning + batch encoding; multi-file runs use
        # one journal per input so batch ids stay per-file.
        from find_circ2_tpu_torch.models.stream import run_fastq
        for fi, f in enumerate(args.input):
            jr = journal
            if journal is not None and len(args.input) > 1:
                from find_circ2_tpu_torch.utils.journal import RunJournal
                jr = RunJournal(f"{journal.path}.{fi}", meta=journal.meta)
            run_fastq(dindex, f, agg, cfg, prefilter, times=times,
                      slowpath=slowpath, journal=jr,
                      revcomp=bool(args.pe and fi % 2))
    else:
        if args.reads_format == "fastq":
            print("find_circ: WARNING: native loader unavailable; "
                  "falling back to the per-read Python path",
                  file=sys.stderr)
        src = itertools.chain.from_iterable(
            file_stream(fi, f) for fi, f in enumerate(args.input))
        for call in run_reads(dindex, src, cfg, prefilter, journal=journal,
                              times=times, slowpath=slowpath):
            agg.add(call)
    if times is not None:
        print(times.report(wall=time.perf_counter() - t_stream),
              file=sys.stderr)
    rows = agg.rows(sample_name=args.name, prefix=args.prefix)
    if args.filter:
        from find_circ2_tpu_torch.io.bed import passes_filter
        rows = [r for r in rows
                if passes_filter(r, args.max_span, args.min_support,
                                 args.max_edits)]
    out = sys.stdout if args.output == "-" else open(args.output, "wt")
    try:
        write_bed(out, rows)
    finally:
        if out is not sys.stdout:
            out.close()
    if args.stats:
        with open(args.stats, "wt") as fh:
            fh.write("\n".join(agg.stats.lines()) + "\n")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
