"""The control of a cell's comparison, and the program's readings beside
it, at the cell's own size in one process:

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed: the cell's library, one pass of the program as the
configuration states it (the sound reading), one pass of the program
with the cell's `control` settings (its workload file: the contiguous
prefilter switched off, a guarantee the configuration states), the plain
reference once, and each pass's numbers as the benchmark compares them.
One JSON line a seed, then one with the largest sound and the smallest
control reading of each number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root: str, workload: str, seeds: list[int],
             device: str = "cuda") -> list[dict]:
    """Per seed, the sound pass's and the control pass's numbers."""
    from find_circ2_tpu_torch.utils.profiling import StageTimes
    from portbench import harness
    from portbench.reference import compare
    cell, cfg, garr, genome, index, dindex = harness.setup(root, workload,
                                                           device)
    fc = cell.conf["find_circ"]
    control = {**fc, **cell.params["control"]}
    out = []
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            fastqs, n_reads = harness.write_library(
                garr, cell.traffic, seed, cfg.anchor_len, tmp)
            rec = {"seed": seed, "reads": n_reads}
            passes = {}
            for name, settings in (("sound", fc), ("control", control)):
                prog = harness.Program(genome, index, dindex, cfg, settings,
                                       fastqs, tmp)
                passes[name] = prog.one_pass(StageTimes())
            ref = compare.reference(garr, fastqs, fc, seed,
                                    harness.REFERENCE_WORKERS)
            rec["oracle_calls_differing"] = ref.oracle_calls_differing
            for name, (bed, stats) in passes.items():
                d = compare.differences(bed, stats, ref)
                rec[name] = {k: d[k] for k in harness.PASS_NUMBERS}
        harness.log(f"control {workload} seed {seed}: {json.dumps(rec)}")
        out.append(rec)
    return out


def summary(recs: list[dict]) -> dict:
    """Largest sound reading and smallest control reading per number."""
    from portbench.harness import PASS_NUMBERS
    out = {k: {"sound_max": max(r["sound"][k] for r in recs),
               "control_min": min(r["control"][k] for r in recs)}
           for k in PASS_NUMBERS}
    out["oracle_calls_differing"] = {
        "sound_max": max(r["oracle_calls_differing"] for r in recs)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("portbench: control needs a CUDA card", file=sys.stderr)
        return 2
    recs = readings(ROOT, args.workload,
                    [int(s) for s in args.seeds.split(",")])
    for r in recs:
        print(json.dumps(r))
    print(json.dumps({"workload": args.workload, **summary(recs)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
