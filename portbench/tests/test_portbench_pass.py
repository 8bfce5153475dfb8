"""Whole runs of a tiny cell on the CPU through the function the command
calls (the port's plain versions take CPU tensors): sound, with the timed
path broken underneath, and with the control's settings; a paired-end
cell against `find_circ --pe` itself; a cell and a metric added as new
files; the index cache; the command without a card and without the
program."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import control, harness, index_cache
from portbench.tests import tiny

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(str(tmp_path_factory.mktemp("bench")))


def run(tree, seconds=0.5, trace=False, seed=SEED):
    return harness.run_cell(tree, tiny.CELL, seed, seconds, trace,
                            time.perf_counter(), device="cpu")


def test_sound_run_is_correct(tree):
    r = run(tree)
    assert r["correct"] is True
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert r["metrics"]["reads_per_s"]["value"] > 0
    assert r["attempted"] > 0 and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    with open(os.path.join(tree, "BENCHMARK.json")) as fh:
        units = {m["name"]: m["unit"] for m in json.load(fh)["end_to_end"]}
    assert r["metrics"]["setup_s"]["unit"] == units["setup_s"]


def _library(tree, seed=SEED):
    """The tiny cell's genome arrays, the number of reads of its library
    for `seed` and the library's FASTQ paths."""
    cell = harness.Cell(tree, tiny.CELL)
    g = harness.setup(tree, tiny.CELL, "cpu")[2]
    out = os.path.join(tree, f"ref_{seed}")
    os.makedirs(out, exist_ok=True)
    paths, n_reads = harness.write_library(g, cell.traffic, seed, 20, out)
    return g, n_reads, paths


def _reference(tree, seed=SEED):
    from portbench.reference import compare
    g, n_reads, paths = _library(tree, seed)
    fc = harness.Cell(tree, tiny.CELL).conf["find_circ"]
    return compare.reference(g, paths, fc, seed, 2), n_reads


def test_reference_finds_junctions(tree):
    from portbench.reference import compare
    ref, n_reads = _reference(tree)
    assert ref.bed.count("\n") > 20
    assert f"reads_total\t{n_reads}" in ref.stats
    d = compare.differences(ref.bed, ref.stats, ref)
    assert d["bytes_differ"] == 0
    assert all(d[k] == 0 for k in harness.PASS_NUMBERS)
    assert ref.oracle_sampled == min(compare.ORACLE_SAMPLE, n_reads)
    assert ref.oracle_calls_differing == 0


def test_oracle_sample_takes_rescued_and_routed_reads_first(tree):
    from portbench.reference import compare
    from portbench.reference.seedindex import build_index
    cell = harness.Cell(tree, tiny.CELL)
    cfg = compare.reference_config(cell.conf["find_circ"])
    g, _, paths = _library(tree)
    genome = compare.Genome(**{k: g[k] for k in (
        "codes", "chrom_names", "chrom_offsets", "chrom_lengths")})
    index = build_index(genome, cfg)
    items = compare.read_fastq(paths[0])
    s1 = compare.oracle_sample(genome, index, items, cfg, SEED)
    assert s1 == compare.oracle_sample(genome, index, items, cfg, SEED)
    assert s1 != compare.oracle_sample(genome, index, items, cfg, SEED + 1)
    assert len(set(s1)) == len(s1) == min(compare.ORACLE_SAMPLE, len(items))
    a = cfg.anchor_len
    q = np.stack([compare.seq_to_codes(items[i][1])[:a] for i in s1]
                 + [compare.seq_to_codes(items[i][1])[-a:] for i in s1])
    hits, _ = compare.anchor_candidates_batch(genome, index, q, cfg)
    n = len(s1)
    rescue = [hits[m].aligned != hits[n + m].aligned for m in range(n)]
    k = sum(rescue)
    assert k > 0 and all(rescue[:min(k, compare.ORACLE_SAMPLE // 3)])


def test_oracle_finds_a_fault_in_the_vectorised_caller(tree, monkeypatch):
    """The vectorised caller is the code the program's host re-calls run:
    a fault in it shows against the per-read oracle, whatever the
    program does."""
    from portbench.reference import compare
    orig = compare.call_reads_multi_batch

    def off_by_one(*a, **k):
        calls = orig(*a, **k)
        for c in calls:
            if c.status == 0:
                c.qual_left += 1
        return calls
    monkeypatch.setattr(compare, "call_reads_multi_batch", off_by_one)
    ref, _ = _reference(tree)
    assert ref.oracle_calls_differing > 0


def test_recount_finds_a_fault_the_program_and_its_copy_share(
        tree, monkeypatch):
    """A fault in the final table that the program and the frozen copy
    of its aggregator share leaves the bytes equal, and the plain
    recount finds it."""
    from find_circ2_tpu_torch.models import aggregate as port_agg
    from portbench.reference import aggregate as ref_agg

    def wrap(orig):
        return lambda *a: orig(*a).replace(",CANONICAL", "")
    monkeypatch.setattr(port_agg, "category_flags",
                        wrap(port_agg.category_flags))
    monkeypatch.setattr(ref_agg, "category_flags",
                        wrap(ref_agg.category_flags))
    r = run(tree)
    assert r["checks"]["bed_rows_differing"]["value"] == 0
    assert r["checks"]["table_rows_differing"]["value"] > 0
    assert r["correct"] is False and r["failed"] > 0


def _unchanged(monkeypatch):
    from find_circ2_tpu_torch.models import stream
    monkeypatch.setattr(stream, "run_fastq", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from find_circ2_tpu_torch.models import stream
    orig = stream.dispatch_packed

    def half(dindex, arr, lens, cfg, prefilter=True):
        lens = lens.copy()
        lens[int((lens > 0).sum()) // 2:] = 0
        return orig(dindex, arr, lens, cfg, prefilter)
    monkeypatch.setattr(stream, "dispatch_packed", half)


def _altered(monkeypatch):
    from find_circ2_tpu_torch.models import stream
    orig = stream.unpack_results

    def altered(packed):
        res = orig(packed)
        res["end"] = np.where(res["status"] == 0, res["end"] + 1,
                              res["end"]).astype(res["end"].dtype)
        return res
    monkeypatch.setattr(stream, "unpack_results", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch_left_out",
                              "answer_altered"])
def test_broken_timed_path_is_not_correct(tree, monkeypatch, fault):
    fault(monkeypatch)
    r = run(tree)
    assert r["correct"] is False
    assert r["failed"] > 0


def test_control_fails_and_sound_passes(tree):
    recs = control.readings(tree, tiny.CELL, [SEED, SEED + 1], "cpu")
    s = control.summary(recs)
    assert all(v["sound_max"] == 0 for v in s.values())
    assert max(s[k]["control_min"] for k in harness.PASS_NUMBERS) > 0


def _revcomp_args(monkeypatch) -> list:
    """The `revcomp` of every later run_fastq call, bound by name."""
    import inspect
    from find_circ2_tpu_torch.models import stream
    orig = stream.run_fastq
    sig = inspect.signature(orig)
    seen = []

    def recorded(*a, **k):
        bound = sig.bind(*a, **k)
        bound.apply_defaults()
        seen.append(bound.arguments["revcomp"])
        return orig(*a, **k)
    monkeypatch.setattr(stream, "run_fastq", recorded)
    return seen


@pytest.mark.parametrize("cell,want", [(tiny.CELL, [False]),
                                       (tiny.PE_CELL, [False, True])],
                         ids=["single_end", "paired"])
def test_pass_calls_run_fastq_once_a_file(tree, monkeypatch, cell, want):
    """A single-end pass makes the one call it always made; a paired
    pass one a mate file, mate 2's reverse-complemented."""
    from find_circ2_tpu_torch.utils.profiling import StageTimes
    program = _program(tree, cell, os.path.join(tree, "calls"))
    seen = _revcomp_args(monkeypatch)
    program.one_pass(StageTimes())
    assert seen == want


@pytest.mark.parametrize("pe,files", [(True, 1), (False, 2)],
                         ids=["pe_single_end_library", "pairs_without_pe"])
def test_pe_and_the_library_must_agree(tmp_path, pe, files):
    """A `pe` configuration over one file, or two mate files under a
    configuration without `pe`, is refused before any pass."""
    paths = [str(tmp_path / f"library_{k + 1}.fastq") for k in range(files)]
    with pytest.raises(SystemExit, match="pe"):
        harness.Program(None, None, None, None, {"pe": pe}, paths,
                        str(tmp_path))


def _fasta(genome, path) -> None:
    with open(path, "wb") as fh:
        for name, off, n in zip(genome.chrom_names, genome.chrom_offsets,
                                genome.chrom_lengths):
            seq = np.frombuffer(b"ACGTN", np.uint8)[
                genome.codes[off:off + n]]
            fh.write(b">%s\n%s\n" % (name.encode(), seq.tobytes()))


def test_paired_pass_writes_what_find_circ_pe_writes(tree, tmp_path):
    """The paired cell's pass against the port's own command,
    `find_circ --pe --stranded --filter`, over the same two files; the
    strandmatch column is filled."""
    from find_circ2_tpu_torch.cli import find_circ
    from find_circ2_tpu_torch.utils.profiling import StageTimes
    program = _program(tree, tiny.PE_CELL, str(tmp_path / "lib"))
    bed, stats = program.one_pass(StageTimes())
    fc = program.fc
    _fasta(program.genome, tmp_path / "genome.fa")
    out = tmp_path / "cli.bed"
    rc = find_circ.main([
        *program.fastqs, "-G", str(tmp_path / "genome.fa"),
        "--reads-format", "fastq", "--pe", "--stranded", "--filter",
        "--device", "cpu", "-a", str(fc["anchor_len"]),
        "--batch-size", str(fc["batch_size"]),
        "--max-span", str(fc["max_span"]),
        "--min-support", str(fc["min_support"]),
        "--max-edits", str(fc["max_edits"]), "-n", fc["name"],
        "-p", fc["prefix"], "-o", str(out), "-s", str(tmp_path / "cli.st")])
    assert rc == 0
    assert bed == out.read_text()
    assert stats == (tmp_path / "cli.st").read_text()
    rows = [ln.split("\t") for ln in bed.splitlines()
            if ln and not ln.startswith("#")]
    assert len(rows) > 20
    assert {r[16] for r in rows} - {"NA"}


def _pe_run(tree, seconds=0.5):
    return harness.run_cell(tree, tiny.PE_CELL, SEED, seconds, False,
                            time.perf_counter(), device="cpu")


def test_paired_run_is_correct(tree):
    from portbench import library
    r = _pe_run(tree)
    assert r["correct"] is True and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    cell = harness.Cell(tree, tiny.PE_CELL)
    mates = library.make_library(
        harness.setup(tree, tiny.PE_CELL, "cpu")[2], cell.traffic, SEED, 20)
    assert len(mates) == 2
    n_reads = sum(m.shape[0] for m in mates)
    assert r["attempted"] % n_reads == 0 and r["attempted"] >= 2 * n_reads


def test_paired_mate2_left_unflipped_is_not_correct(tree, monkeypatch):
    """Mate 2 read in its sequenced orientation: the junctions are the
    same, their strandmatch is not."""
    from find_circ2_tpu_torch.models import stream
    orig = stream.run_fastq
    monkeypatch.setattr(stream, "run_fastq",
                        lambda *a, **k: orig(*a, **{**k, "revcomp": False}))
    r = _pe_run(tree)
    assert r["correct"] is False and r["failed"] > 0
    assert r["checks"]["bed_rows_differing"]["value"] > 0


def test_new_cell_and_metric_as_files(tmp_path, monkeypatch):
    root = tiny.make_tree(str(tmp_path))
    pb = os.path.join(root, "portbench")
    tiny.write(os.path.join(pb, "traffic", "tiny_unique.json"),
               tiny.tiny_traffic("unique_flanks"))
    tiny.write(os.path.join(pb, "workloads", "tiny.unique.json"),
               {"config": "tiny", "traffic": "tiny_unique",
                "control": {"prefilter": False}})
    with open(os.path.join(pb, "metrics", "tiny.passes.py"), "w") as fh:
        fh.write("def read(run):\n    return float(run.passes)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append(dict(name="tiny.unique", config="tiny",
                                   traffic="tiny_unique", chips=1, why="t"))
    bench["per_layer"].append(dict(
        name="tiny.passes", unit="passes", better="higher",
        source="program_counter", layer="streaming loop",
        moves="reads_per_s", workloads=["tiny.unique"]))
    tiny.write(os.path.join(root, "BENCHMARK.json"), bench)

    prof = dict(device_s={"detect": 1e-3, "explore": 1e-3, "other": 0.0},
                busy_s=1e-3, window_s=1.0, activities=3,
                device_ops=[["k", 1e-3]], idle_gaps=[["aggregate", 0.5]])
    tallies = dict(detect_s=1e-5, explore_s=1e-5, detect_batches=2,
                   slices=2, explore_chunks=2)
    monkeypatch.setattr(harness, "take_profile",
                        lambda program, n, cfg, keep: (prof, tallies))
    r = harness.run_cell(root, "tiny.unique", SEED, 0.3, True,
                         time.perf_counter(), device="cpu")
    assert r["correct"] is True
    names = {m["name"] for m in bench["per_layer"]}
    assert set(r["metrics"]) == names
    assert r["metrics"]["tiny.passes"]["value"] >= 1
    assert r["breakdown"]["idle_gaps"] == [["aggregate", 0.5]]
    assert r["device"]["busy_s"] == 1e-3
    other = harness.Cell(root, tiny.CELL)
    assert "tiny.passes" not in {m["name"] for m in other.per_layer}


def _program(tree, cell_name, out):
    """The cell's Program after its set-up, over its library for SEED
    written under `out`."""
    cell, cfg, garr, genome, index, dindex = harness.setup(tree, cell_name,
                                                           "cpu")
    os.makedirs(out, exist_ok=True)
    paths, _ = harness.write_library(garr, cell.traffic, SEED,
                                     cfg.anchor_len, out)
    return harness.Program(genome, index, dindex, cfg,
                           cell.conf["find_circ"], paths, out)


def _captured(tree, sabotage=lambda: None, cell=tiny.CELL):
    """One pass of a tiny cell under the traced run's captures, with
    `sabotage` called once they are in place: check_capture's arguments."""
    from find_circ2_tpu_torch.utils.profiling import StageTimes
    program = _program(tree, cell, os.path.join(tree, "capture"))
    work, counts, times = {}, {}, StageTimes()
    with harness.capture_work(work), harness.count_routed(counts):
        sabotage()
        program.one_pass(times)
    return harness.tally_bounds(work, program.cfg), counts, times.counts


@pytest.mark.parametrize("cell,chunk", [(tiny.CELL, None),
                                        (tiny.CELL, 100_000),
                                        (tiny.PE_CELL, None)],
                         ids=["one_chunk", "batches_cut_at_chunks",
                              "paired"])
def test_captures_agree_with_the_program(tree, monkeypatch, cell, chunk):
    """Also where the FASTQ reader's chunks cut the library into more
    batches than its reads fill, and where each mate file's loop times
    its own stages."""
    from find_circ2_tpu_torch.models import stream
    if chunk:
        monkeypatch.setattr(stream, "CHUNK", chunk)
    tallies, counts, stage_n = _captured(tree, cell=cell)
    harness.check_capture(tallies, counts, stage_n)
    assert tallies["detect_batches"] == stage_n["device_dispatch"] > 0
    if chunk:
        assert stage_n["device_dispatch"] > 1
    assert tallies["explore_chunks"] >= counts["dispatches"] > 0
    assert tallies["detect_s"] > 0 and tallies["explore_s"] > 0
    assert counts["routed"] > 0
    assert stage_n["stream_start"] == (2 if cell == tiny.PE_CELL else 1)


def _owner(path: str):
    """The module or class of the port at a dotted path."""
    import importlib
    mod, _, cls = path.partition(":")
    obj = importlib.import_module("find_circ2_tpu_torch." + mod)
    return getattr(obj, cls) if cls else obj


@pytest.mark.parametrize("owner,name", [
    ("models.pipeline", "detect_batch_packed_fast"),
    ("ops.anchor_align", "fallback_slice"),
    ("models.pipeline:DeviceExplorer", "dispatch_arrays")],
    ids=["detect", "slice", "routing"])
def test_capture_that_never_fired_fails_the_traced_run(tree, owner, name):
    """A wrapped function that the program no longer reaches through the
    module's attribute (renamed, or imported by name) is found out."""
    obj = _owner(owner)
    orig = getattr(obj, name)
    args = _captured(tree, lambda: setattr(obj, name, orig))
    with pytest.raises(SystemExit, match="disagree"):
        harness.check_capture(*args)


def test_captures_bind_arguments_by_name(tree):
    """A call that passes the tallied arguments by keyword is captured as
    one that passes them by position."""
    import torch
    from find_circ2_tpu_torch.ops import anchor_align
    work = {}
    resolved = torch.tensor([True, False, False, True])
    with harness.capture_work(work):
        anchor_align.fallback_slice(resolved, 2)
        anchor_align.fallback_slice(k=2, resolved=resolved)
    assert [k for _, k in work["slice"]] == [2, 2]
    assert all(r is resolved for r, _ in work["slice"])


def test_index_cache_written_once_and_keyed(tmp_path):
    from find_circ2_tpu_torch.config import Config
    conf = tiny.tiny_conf(genome_bp=100_000, n_circ=10, n_linear=2)
    raw = json.dumps(conf).encode()
    logs = []
    g1, idx1, i1 = index_cache.load_or_build(str(tmp_path), conf, raw,
                                             Config(), logs.append)
    files = sorted(os.listdir(i1["dir"]))
    mtimes = {f: os.path.getmtime(os.path.join(i1["dir"], f))
              for f in files}
    g2, idx2, i2 = index_cache.load_or_build(str(tmp_path), conf, raw,
                                             Config(), logs.append)
    assert i1["built"] and not i2["built"] and not logs
    assert {f: os.path.getmtime(os.path.join(i1["dir"], f))
            for f in files} == mtimes
    np.testing.assert_array_equal(g1["codes"], g2["codes"])
    np.testing.assert_array_equal(idx1.qtable.ntable, idx2.qtable.ntable)
    np.testing.assert_array_equal(idx1.positions, idx2.positions)
    np.testing.assert_array_equal(g1["loci"]["circular"]["clean"],
                                  g2["loci"]["circular"]["clean"])
    conf["genome"]["seed"] += 1
    g3, _, i3 = index_cache.load_or_build(
        str(tmp_path), conf, json.dumps(conf).encode(), Config(),
        logs.append)
    assert i3["built"] and logs and "rebuilding" in logs[0]
    assert not np.array_equal(g1["codes"], g3["codes"])


def test_run_that_loaded_jax_prints_no_result(tree, monkeypatch):
    import types as t
    monkeypatch.setitem(sys.modules, "jaxlib", t.ModuleType("jaxlib"))
    with pytest.raises(SystemExit, match="jaxlib"):
        run(tree)


def test_command_refuses_without_a_card():
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "rnase_r_16mb.enriched", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=300)
    if "CUDA" not in r.stderr:
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_alone_cannot_run(tmp_path):
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(tiny.REPO, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from portbench import "
            "harness; r = harness.run_cell('.', 'rnase_r_16mb.enriched', 1,"
            " 1, False, 0.0, device='cpu'); print(r)")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "find_circ2_tpu_torch" in r.stderr
