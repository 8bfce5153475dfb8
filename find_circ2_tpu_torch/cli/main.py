"""Umbrella CLI of the PyTorch package (reference:
find_circ2_tpu/cli/main.py):

    python -m find_circ2_tpu_torch.cli.main run reads.fastq -G genome.fa -o out/
    python -m find_circ2_tpu_torch.cli.main find_circ ...
    python -m find_circ2_tpu_torch.cli.main index genome.fa -o index.npz

`run` and `find_circ` detect on the PyTorch device path (`--device
cuda` by default); the other subcommands are the reference's host-only
tools.
"""

from __future__ import annotations

import argparse
import os
import sys

from find_circ2_tpu_torch.cli import (cmp_bed, find_circ, maxlength,
                                     merge_bed, unmapped2anchors)


def run_cmd(argv) -> int:
    p = argparse.ArgumentParser(prog="run",
                                description="full pipeline in one command")
    p.add_argument("reads", help="FASTQ(.gz) of RNA-seq reads")
    p.add_argument("-G", "--genome", default=None)
    p.add_argument("-x", "--index", default=None,
                   help="prebuilt index .npz (`index`); alternative to -G")
    p.add_argument("-o", "--outdir", default="tpu_circ_out")
    p.add_argument("-n", "--name", default="sample")
    p.add_argument("-p", "--prefix", default="")
    p.add_argument("--backend", choices=("device", "oracle"),
                   default="device")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--stranded", action="store_true")
    p.add_argument("--no-prefilter", action="store_true")
    p.add_argument("--filter", action="store_true",
                   help="also write circ_candidates.bed with the frozen "
                   "quality filters applied")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timings to stderr")
    args = p.parse_args(argv)
    if not args.genome and not args.index:
        p.error("one of -G/--genome or -x/--index is required")
    os.makedirs(args.outdir, exist_ok=True)
    bed = os.path.join(args.outdir, "splice_sites.bed")
    stats = os.path.join(args.outdir, "stats.txt")
    fc_args = [args.reads, "-o", bed, "-s", stats,
               "-n", args.name, "-p", args.prefix,
               "--reads-format", "fastq", "--backend", args.backend,
               "--device", args.device]
    fc_args += ["-x", args.index] if args.index else ["-G", args.genome]
    for flag in ("stranded", "no_prefilter", "profile"):
        if getattr(args, flag):
            fc_args.append("--" + flag.replace("_", "-"))
    rc = find_circ.main(fc_args)
    if rc:
        return rc
    if args.filter:
        rc = _filter_existing(bed, os.path.join(args.outdir,
                                                "circ_candidates.bed"))
    print(f"run: wrote {bed} and {stats}", file=sys.stderr)
    return rc


def _filter_existing(bed_path: str, out_path: str) -> int:
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.io.bed import passes_filter, read_bed, write_bed
    cfg = Config()
    rows = [r for r in read_bed(bed_path)
            if passes_filter(r, cfg.max_span, cfg.min_support,
                             cfg.filter_max_edits)]
    write_bed(out_path, rows)
    return 0


def index_cmd(argv) -> int:
    p = argparse.ArgumentParser(prog="index",
                                description="build and save the genome "
                                "seed index (bowtie2-build analog)")
    p.add_argument("genome", help="genome FASTA(.gz)")
    p.add_argument("-o", "--output", required=True,
                   help="output .npz index path")
    args = p.parse_args(argv)
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.index.build import build_index, save_index
    from find_circ2_tpu_torch.index.hashtable import build_query_table
    from find_circ2_tpu_torch.io.genome import Genome
    cfg = Config()
    genome = Genome.from_fasta(args.genome, cfg)
    index = build_index(genome, cfg)
    # Precompute the query table so runs loading this artifact skip the
    # cuckoo construction.
    index.qtable = build_query_table(index, cfg)
    save_index(args.output, genome, index)
    print(f"index: {len(genome)} bases, {index.positions.size} windows "
          f"-> {args.output}", file=sys.stderr)
    return 0


COMMANDS = {
    "run": run_cmd,
    "index": index_cmd,
    "unmapped2anchors": unmapped2anchors.main,
    "find_circ": find_circ.main,
    "merge_bed": merge_bed.main,
    "cmp_bed": cmp_bed.main,
    "maxlength": maxlength.main,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m find_circ2_tpu_torch.cli.main <command> "
              "[...]\ncommands: " + ", ".join(COMMANDS), file=sys.stderr)
        return 0 if argv else 2
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; commands: {', '.join(COMMANDS)}",
              file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
