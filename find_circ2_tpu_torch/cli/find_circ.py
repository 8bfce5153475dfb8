"""`find_circ` — the junction caller CLI on the PyTorch device path
(reference: find_circ2_tpu/cli/find_circ.py).

Same flags and output as the reference, with `--device {cuda,cpu}` in
place of `--platform`. Routed §2b multi-hit reads run on the device
explore program (pipeline.DeviceExplorer), as in the reference; only the
2-mm anchor rescue runs on the host. `--mesh DATAxINDEX` runs the
sharded engine (parallel/sharded.py) over D·I slots filled round-robin
with the visible devices of `--device` (so one card holds four index
shards with `--mesh 2x2`); its §2b reads go to the host twin, as in the
reference. `--nproc N --proc-id i` runs one of N processes joined over
gloo: each detects every N-th batch on its own device, and process 0
merges the junction tables and the summed stats. `--backend oracle` is
the numpy reference caller.
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
from find_circ2_tpu_torch.utils.profiling import StageTimes, timed


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


def resolve_device(name: str, proc_id: int | None = None):
    """torch.device for --device; cuda without a card is an error. Rank
    `proc_id` of a --nproc run takes the card proc_id mod the visible
    cards, so the ranks of a host with several cards detect each on its
    own; with one card they share it."""
    import torch
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("find_circ: --device cuda but no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    if name == "cuda" and proc_id is not None:
        return torch.device("cuda", proc_id % torch.cuda.device_count())
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
                   help="device = the PyTorch path, oracle = numpy "
                   "reference")
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
                   help="run the sharded engine over a DATAxINDEX mesh "
                   "(e.g. 2x4: data-parallel reads, k-mer-range-sharded "
                   "index), its slots filled in turn with the visible "
                   "devices of --device; output is byte-identical to the "
                   "single-device path")
    p.add_argument("--nproc", type=int, default=None,
                   help="multi-process run: total number of processes. "
                   "Each process streams every --nproc'th batch (or "
                   "read), detects on its own device, and process 0 "
                   "merges the junction tables; stats are summed over "
                   "gloo. Requires --proc-id and a real -o path; output "
                   "is byte-identical to a single-process run")
    p.add_argument("--proc-id", type=int, default=None,
                   help="this process's rank in [0, --nproc)")
    p.add_argument("--coordinator", default="localhost:9377",
                   help="host:port where process 0 hosts the gloo "
                   "rendezvous")
    p.add_argument("--journal", default=None,
                   help="JSONL resume journal: completed batches replay "
                   "from disk on rerun")
    p.add_argument("--profile", action="store_true",
                   help="print the set-up seconds and, once the outputs "
                   "are written, the seconds of every stage from the "
                   "stream to the writers (rows, filter, write) to "
                   "stderr")
    return p


def parse_mesh(spec: str) -> tuple[int, int]:
    """DATAxINDEX -> (data, index)."""
    try:
        shape = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise SystemExit("--mesh expects DATAxINDEX, e.g. 2x4")
    return shape


def run(args) -> int:
    nproc = args.nproc or 1
    if nproc > 1:
        # Detection is per process on its own device; only the stats sum
        # and the file-based junction merge synchronize the processes.
        if args.proc_id is None or not 0 <= args.proc_id < nproc:
            raise SystemExit("--nproc requires --proc-id in [0, nproc)")
        if args.output == "-":
            raise SystemExit("--nproc requires -o FILE "
                             "(process 0 writes the merged table)")
        if args.mesh:
            raise SystemExit("--mesh shards within one process; combine "
                             "processes with --nproc OR devices with "
                             "--mesh, not both")
    mesh = parse_mesh(args.mesh) if args.mesh else None
    from find_circ2_tpu_torch.parallel.distributed import (close_distributed,
                                                           init_distributed)
    init_distributed(args.coordinator, nproc, args.proc_id)
    try:
        return _run(args, nproc, mesh)
    finally:
        close_distributed()


def _run(args, nproc: int, mesh) -> int:
    t_setup = time.perf_counter()
    device = resolve_device(args.device, args.proc_id if nproc > 1
                            else None) if args.backend == "device" else None
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

    src = itertools.chain.from_iterable(
        file_stream(fi, f) for fi, f in enumerate(args.input))
    if nproc > 1:
        # Round-robin read sharding for the per-read paths: deterministic,
        # streaming, and the junction merge is order-free.
        src = itertools.islice(src, args.proc_id, None, nproc)
    prefilter = not args.no_prefilter
    agg = Aggregator(genome, cfg)
    journal = times = None
    if args.journal:
        from find_circ2_tpu_torch.utils.journal import RunJournal
        if nproc > 1:
            # Per-rank journal: batch ids mean something only within one
            # (nproc, proc_id) sharding, which the header pins, so a
            # resume under another --nproc fails instead of replaying
            # another rank's batches.
            journal = RunJournal(
                f"{args.journal}.r{args.proc_id}",
                meta={"nproc": nproc, "proc_id": args.proc_id})
        else:
            journal = RunJournal(args.journal)
    from find_circ2_tpu_torch import native
    from find_circ2_tpu_torch.models.pipeline import DeviceIndex
    from find_circ2_tpu_torch.models.stream import run_fastq, run_reads
    slowpath = (genome, index)
    native_fastq = args.reads_format == "fastq" and native.available()
    if args.backend == "device" and not native_fastq \
            and args.reads_format == "fastq":
        print("find_circ: WARNING: native loader unavailable; falling "
              "back to the per-read Python path", file=sys.stderr)

    def journals():
        # Multi-file runs use one journal per input (keeping the
        # sharding-pinned header), so batch ids stay per file.
        for fi, f in enumerate(args.input):
            jr = journal
            if journal is not None and len(args.input) > 1:
                from find_circ2_tpu_torch.utils.journal import RunJournal
                jr = RunJournal(f"{journal.path}.{fi}", meta=journal.meta)
            yield fi, f, jr

    if args.backend == "device" and mesh is not None:
        # The sharded engine in place of the single-device step; same
        # streaming loop and aggregation.
        from find_circ2_tpu_torch.parallel.mesh import make_mesh, round_robin
        from find_circ2_tpu_torch.parallel.sharded import ShardedEngine
        n = mesh[0] * mesh[1]
        eng = ShardedEngine(genome, index,
                            make_mesh(n, mesh, round_robin(n, device.type)),
                            cfg, prefilter)
        bs = -(-cfg.batch_size // eng.n_data) * eng.n_data
        times, t_stream = _profile_start(args, t_setup)
        if native_fastq:
            for fi, f, jr in journals():
                run_fastq(None, f, agg, cfg, prefilter, batch_size=bs,
                          times=times, slowpath=slowpath, journal=jr,
                          revcomp=bool(args.pe and fi % 2),
                          dispatch=eng.dispatch_packed,
                          redo=eng.redo_packed)
        else:
            for call in run_reads(None, src, cfg, prefilter, batch_size=bs,
                                  journal=journal, times=times,
                                  slowpath=slowpath,
                                  dispatch=eng.dispatch_packed,
                                  redo=eng.redo_packed):
                agg.add(call)
    elif args.backend == "device":
        dindex = DeviceIndex.build(genome, index, cfg, device=device)
        times, t_stream = _profile_start(args, t_setup)
        if native_fastq:
            # Each process owns every --nproc'th batch (shard=).
            shard = (args.proc_id, nproc) if nproc > 1 else None
            for fi, f, jr in journals():
                run_fastq(dindex, f, agg, cfg, prefilter, times=times,
                          slowpath=slowpath, journal=jr,
                          revcomp=bool(args.pe and fi % 2), shard=shard)
        else:
            for call in run_reads(dindex, src, cfg, prefilter,
                                  journal=journal, times=times,
                                  slowpath=slowpath):
                agg.add(call)
    else:
        from find_circ2_tpu_torch.models.oracle import call_read
        times, t_stream = _profile_start(args, t_setup)
        for name, seq in src:
            agg.add(call_read(genome, index, name, seq, cfg, prefilter))
    if nproc > 1 and not _merge_processes(args, agg, nproc):
        _profile_end(times, t_stream)
        return 0
    with timed(times, "rows"):
        rows = agg.rows(sample_name=args.name, prefix=args.prefix)
    if args.filter:
        from find_circ2_tpu_torch.io.bed import passes_filter
        with timed(times, "filter"):
            rows = [r for r in rows
                    if passes_filter(r, args.max_span, args.min_support,
                                     args.max_edits)]
    with timed(times, "write"):
        out = sys.stdout if args.output == "-" else open(args.output, "wt")
        try:
            write_bed(out, rows)
        finally:
            if out is not sys.stdout:
                out.close()
        if args.stats:
            with open(args.stats, "wt") as fh:
                fh.write("\n".join(agg.stats.lines()) + "\n")
    _profile_end(times, t_stream)
    return 0


def _profile_start(args, t_setup: float):
    """(StageTimes, stream start) under --profile, after printing the
    set-up seconds; (None, None) without it."""
    if not args.profile:
        return None, None
    t_stream = time.perf_counter()
    print(f"setup\t{t_stream - t_setup:.3f}s\tgenome, index and "
          "device tables", file=sys.stderr)
    return StageTimes(), t_stream


def _profile_end(times, t_stream: float) -> None:
    """Under --profile, the stage table from the stream's start to now
    on stderr."""
    if times is not None:
        print(times.report(wall=time.perf_counter() - t_stream),
              file=sys.stderr)


def _merge_processes(args, agg: Aggregator, nproc: int) -> bool:
    """Every process writes its junction reads' columns
    (Aggregator.read_columns) to {output}.part{rank};
    the stats counters are summed over gloo, which is also the barrier
    before process 0 reads the parts. Returns True on process 0, whose
    `agg` then holds the merged table and the summed stats."""
    import pickle
    from find_circ2_tpu_torch.models.aggregate import Stats
    from find_circ2_tpu_torch.parallel.distributed import (allreduce_counts,
                                                           stats_to_vec)
    order = Stats.REDUCE_ORDER
    part = f"{args.output}.part{args.proc_id}"
    with open(part, "wb") as fh:
        pickle.dump(agg.read_columns(), fh)
    total = allreduce_counts(stats_to_vec(agg.stats, order))
    if args.proc_id != 0:
        return False
    for i in range(1, nproc):
        pi = f"{args.output}.part{i}"
        with open(pi, "rb") as fh:
            agg.merge_from(pickle.load(fh))
        os.remove(pi)
    os.remove(part)
    # Replace only the summed per-read counters; any other counter stays.
    for k in order:
        agg.stats.counts.pop(k, None)
    agg.stats.counts.update({k: int(v) for k, v in zip(order, total) if v})
    return True


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
