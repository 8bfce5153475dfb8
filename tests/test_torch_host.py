"""The PyTorch port's own copies of the host modules (find_circ2_tpu_torch/
{config, io, native, index, models/oracle, models/aggregate,
models/multihit, utils, cli}) against the JAX package's originals on the
CPU: the same seeded inputs through both, tolerance 0, BED and stats
compared as bytes and dataclasses through `astuple` (the two packages'
dataclasses are distinct classes, so `==` between them is always
False)."""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from find_circ2_tpu import config as rconfig
from find_circ2_tpu import native as rnative
from find_circ2_tpu.cli import cmp_bed as rcmp_bed
from find_circ2_tpu.cli import maxlength as rmaxlength
from find_circ2_tpu.cli import merge_bed as rmerge_bed
from find_circ2_tpu.cli import unmapped2anchors as runmapped2anchors
from find_circ2_tpu.index import build as rbuild
from find_circ2_tpu.index import hashtable as rhashtable
from find_circ2_tpu.index import shard as rshard
from find_circ2_tpu.io import bam as rbam
from find_circ2_tpu.io import bed as rbed
from find_circ2_tpu.io import fasta as rfasta
from find_circ2_tpu.io import fastq as rfastq
from find_circ2_tpu.io import genome as rgenome
from find_circ2_tpu.io import sam as rsam
from find_circ2_tpu.io import twobit as rtwobit
from find_circ2_tpu.models import aggregate as raggregate
from find_circ2_tpu.models import multihit as rmultihit
from find_circ2_tpu.models import oracle as roracle
from find_circ2_tpu.utils import journal as rjournal
from find_circ2_tpu.utils import profiling as rprofiling
from find_circ2_tpu.utils import simulate as rsimulate
from find_circ2_tpu_torch import config as pconfig
from find_circ2_tpu_torch import native as pnative
from find_circ2_tpu_torch.cli import cmp_bed as pcmp_bed
from find_circ2_tpu_torch.cli import maxlength as pmaxlength
from find_circ2_tpu_torch.cli import merge_bed as pmerge_bed
from find_circ2_tpu_torch.cli import unmapped2anchors as punmapped2anchors
from find_circ2_tpu_torch.index import build as pbuild
from find_circ2_tpu_torch.index import hashtable as phashtable
from find_circ2_tpu_torch.index import shard as pshard
from find_circ2_tpu_torch.io import bam as pbam
from find_circ2_tpu_torch.io import bed as pbed
from find_circ2_tpu_torch.io import fasta as pfasta
from find_circ2_tpu_torch.io import fastq as pfastq
from find_circ2_tpu_torch.io import genome as pgenome
from find_circ2_tpu_torch.io import sam as psam
from find_circ2_tpu_torch.io import twobit as ptwobit
from find_circ2_tpu_torch.models import aggregate as paggregate
from find_circ2_tpu_torch.models import multihit as pmultihit
from find_circ2_tpu_torch.models import oracle as poracle
from find_circ2_tpu_torch.utils import journal as pjournal
from find_circ2_tpu_torch.utils import profiling as pprofiling
from find_circ2_tpu_torch.utils import simulate as psimulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "test_data")
astuple = dataclasses.astuple
# SAM flags of the records made from test_data/reads.fastq, in turn:
# unmapped, unmapped reverse, mapped, paired mate 1 / mate 2, secondary.
SAM_FLAGS = (4, 20, 0, 77, 141, 260)


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _tuples(xs):
    return [astuple(x) for x in xs]


@pytest.fixture(scope="module")
def sim():
    """The same small simulated library from both packages' simulators,
    with each package's own index of its own genome."""
    kw = dict(seed=7, n_circ=8, n_linear=6, reads_per_junction=3,
              n_contiguous=20, n_random=10, err_rate=0.35)
    r = rsimulate.simulate(**kw)
    p = psimulate.simulate(**kw)
    return (r, rbuild.build_index(r.genome, rconfig.Config()),
            p, pbuild.build_index(p.genome, pconfig.Config()))


@pytest.fixture(scope="module")
def repeat_tables():
    """Index, query table with §2b extras and neighbour table of one
    repeat-planted 100 kbp genome, built by each package."""
    out = {}
    for name, sim_m, genome_m, build_m, ht_m, cfg in (
            ("ref", rsimulate, rgenome, rbuild, rhashtable,
             rconfig.Config()),
            ("port", psimulate, pgenome, pbuild, phashtable,
             pconfig.Config())):
        rng = np.random.default_rng(23)
        _, seqs = sim_m.random_genome(rng, {"c1": 60_000, "c2": 40_000}, cfg)
        for s in seqs.values():
            sim_m.plant_repeats(rng, s, 0.4)
        genome = genome_m.Genome.from_records(list(seqs.items()), cfg)
        index = build_m.build_index(genome, cfg)
        index.qtable = ht_m.build_query_table(index, cfg)
        ntable = ht_m.build_neighbor_table(index, cfg)
        out[name] = (genome, index, ntable)
    return out


@pytest.mark.parametrize("name", sorted(
    n for n in vars(rconfig) if n.isupper() and n != "DEFAULT"))
def test_config_constants_match(name):
    assert getattr(pconfig, name) == getattr(rconfig, name)


@pytest.mark.parametrize("kw", [{}, dict(anchor_len=18, prefix_len=10),
                                dict(stranded=True, batch_size=64)])
def test_config_fields_match(kw):
    assert astuple(pconfig.Config(**kw)) == astuple(rconfig.Config(**kw))
    assert [f.name for f in dataclasses.fields(pconfig.Config)] == \
        [f.name for f in dataclasses.fields(rconfig.Config)]


def test_fasta_and_genome_parse_test_data():
    fa = os.path.join(DATA, "genome.fa")
    assert list(pfasta.read_fasta(fa)) == list(rfasta.read_fasta(fa))
    rg = rgenome.Genome.from_fasta(fa)
    pg = pgenome.Genome.from_fasta(fa)
    assert pg.chrom_names == rg.chrom_names
    for f in ("codes", "chrom_offsets", "chrom_lengths"):
        assert np.array_equal(getattr(pg, f), getattr(rg, f)), f


def test_fastq_parse_test_data(tmp_path):
    fq = os.path.join(DATA, "reads.fastq")
    want = list(rfastq.read_fastq(fq))
    got = list(pfastq.read_fastq(fq))
    assert len(got) > 50 and _tuples(got) == _tuples(want)
    outs = []
    for m in (rfastq, pfastq):
        buf = io.StringIO()
        for rec in want[:40]:
            for anc in m.anchors_for_read(rec, 20):
                m.write_fastq(buf, anc)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    name = pfastq.encode_anchor_name("r", "ACGT", "IIII", "A")
    assert name == rfastq.encode_anchor_name("r", "ACGT", "IIII", "A")
    assert pfastq.decode_anchor_name(name) == rfastq.decode_anchor_name(name)


def _sam_records(module):
    recs = list(rfastq.read_fastq(os.path.join(DATA, "reads.fastq")))[:60]
    return [module.SamRecord(r.name, SAM_FLAGS[i % len(SAM_FLAGS)], r.seq,
                             r.qual) for i, r in enumerate(recs)]


def _write_sam(path, recs):
    with open(path, "wt") as fh:
        fh.write("@HD\tVN:1.6\n")
        for r in recs:
            fh.write(f"{r.name}\t{r.flag}\t*\t0\t0\t*\t*\t0\t0\t{r.seq}\t"
                     f"{r.qual or '*'}\n")


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_sam_and_bam_parse(tmp_path, fmt):
    """test_data's reads as SAM text and as BAM (each package's writer
    gives the same bytes): records, the unmapped primary reads, and the
    format sniffer agree."""
    path = tmp_path / f"r.{fmt}"
    if fmt == "sam":
        _write_sam(path, _sam_records(rsam))
        rrecs, precs = rsam.read_sam(path), psam.read_sam(path)
        rreads, preads = rsam.reads_from_sam(path), psam.reads_from_sam(path)
    else:
        other = tmp_path / "p.bam"
        rbam.write_bam(path, _sam_records(rsam), refs=[("chr1", 1000)],
                       header_text="@HD\tVN:1.6\n")
        pbam.write_bam(other, _sam_records(psam), refs=[("chr1", 1000)],
                       header_text="@HD\tVN:1.6\n")
        assert _bytes(other) == _bytes(path)
        rrecs, precs = rbam.read_bam(path), pbam.read_bam(path)
        rreads, preads = rbam.reads_from_bam(path), pbam.reads_from_bam(path)
    assert _tuples(list(precs)) == _tuples(list(rrecs))
    want = list(rreads)
    assert list(preads) == want and len(want) > 10
    assert pbam.sniff_format(path) == rbam.sniff_format(path) == fmt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twobit_round_trips(seed):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGTNacgtn"), size=1000 + seed * 333))
    codes = ptwobit.seq_to_codes(seq)
    assert np.array_equal(codes, rtwobit.seq_to_codes(seq))
    assert ptwobit.codes_to_seq(codes) == rtwobit.codes_to_seq(codes)
    assert ptwobit.revcomp_seq(seq) == rtwobit.revcomp_seq(seq)
    assert np.array_equal(ptwobit.revcomp_codes(codes),
                          rtwobit.revcomp_codes(codes))
    packed, nmask = ptwobit.pack_2bit(codes)
    rpacked, rnmask = rtwobit.pack_2bit(codes)
    assert np.array_equal(packed, rpacked) and np.array_equal(nmask, rnmask)
    back = ptwobit.unpack_2bit(packed, nmask, codes.size)
    assert np.array_equal(back, rtwobit.unpack_2bit(packed, nmask,
                                                    codes.size))
    assert np.array_equal(back, codes)


@pytest.mark.parametrize("name", ["splice_sites.bed", "circ_candidates.bed"])
def test_bed_read_write_bytes(tmp_path, name):
    path = os.path.join(DATA, name)
    rows_r, rows_p = list(rbed.read_bed(path)), list(pbed.read_bed(path))
    assert _tuples(rows_p) == _tuples(rows_r)
    pbed.write_bed(tmp_path / "p.bed", rows_p)
    rbed.write_bed(tmp_path / "r.bed", rows_r)
    assert _bytes(tmp_path / "p.bed") == _bytes(tmp_path / "r.bed") \
        == _bytes(path)
    assert [pbed.passes_filter(r) for r in rows_p] == \
        [rbed.passes_filter(r) for r in rows_r]
    assert _tuples(pbed.renumber(rows_p, "x")) == \
        _tuples(rbed.renumber(rows_r, "x"))


@pytest.mark.parametrize("what", ["index", "index_chunked", "qtable",
                                  "ntable"])
def test_index_and_tables_match(repeat_tables, what):
    rg, ri, rnt = repeat_tables["ref"]
    pg, pi, pnt = repeat_tables["port"]
    if what == "index_chunked":
        ri = rbuild.build_index_chunked(rg, rconfig.Config(), chunk=1 << 16)
        pi = pbuild.build_index_chunked(pg, pconfig.Config(), chunk=1 << 16)
    if what.startswith("index"):
        for f in ("positions", "suffix_vals", "offsets"):
            assert np.array_equal(getattr(pi, f), getattr(ri, f)), f
        assert (pi.anchor_len, pi.prefix_len, pi.bsearch_iters) == \
            (ri.anchor_len, ri.prefix_len, ri.bsearch_iters)
    elif what == "qtable":
        for f in ("table", "meta", "ext", "ext_id"):
            assert np.array_equal(getattr(pi.qtable, f),
                                  getattr(ri.qtable, f)), f
        assert (pi.qtable.ext_id > 0).any()
    else:
        assert np.array_equal(pnt, rnt)
    assert phashtable.TABLE_FORMAT == rhashtable.TABLE_FORMAT


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_shard_builders_match(repeat_tables, n_shards):
    """The prefix-range shard builders of the sharded engine on the same
    index: shards carved from the full table (`_shard_from_table`) with
    their relocated neighbour tables, shards built from the distinct
    k-mers with §2b extras, and the sorted-index ShardedIndex."""
    outs = {}
    for name, ht, sh, cfg in (("ref", rhashtable, rshard, rconfig.Config()),
                              ("port", phashtable, pshard,
                               pconfig.Config())):
        _, index, ntable = repeat_tables[name]
        qt = dataclasses.replace(index.qtable, ntable=ntable)
        tables, metas = ht.shard_query_table(
            dataclasses.replace(index, qtable=qt), n_shards, cfg)
        outs[name] = (
            tables, metas, ht.shard_neighbor_tables(qt, tables),
            *ht.shard_query_table(dataclasses.replace(index, qtable=None),
                                  n_shards, cfg, extras=True),
            *astuple(sh.shard_index(index, n_shards)))
    assert len(outs["port"]) == len(outs["ref"]) == 13
    for i, (got, want) in enumerate(zip(outs["port"], outs["ref"])):
        assert np.array_equal(got, want), i
    tables, _, ntables = outs["port"][:3]
    assert tables.shape[0] == ntables.shape[0] == n_shards
    assert (tables[..., 0] != phashtable.EMPTY_KEY).sum() > 0


@pytest.mark.parametrize("salt", [0, 0x80000001, 0xDEADBEEF, 0xFFFFFFFF])
def test_mix_hash_numpy_torch_and_reference_agree(salt):
    """Keys across the whole uint32 range (above 2^31 included): the
    port's numpy mixer (the builders) and torch mixer (the device
    probes) give the reference's hash."""
    rng = np.random.default_rng(salt & 0xFFFF)
    p12 = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    p12[:3] = (2 ** 31, 2 ** 32 - 1, 2 ** 31 + 7)
    p12 = p12.astype(np.uint32)
    s8 = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(
        np.uint32)
    want = rhashtable.mix_hash(p12, s8, np.uint32(salt))
    got_np = phashtable.mix_hash(p12, s8, np.uint32(salt))
    got_t = phashtable.mix_hash(torch.from_numpy(p12.astype(np.int64)),
                                torch.from_numpy(s8.astype(np.int64)),
                                torch.tensor(salt, dtype=torch.int64))
    assert got_np.dtype == np.uint32 and np.array_equal(got_np, want)
    assert np.array_equal(got_t.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_save_load_across_packages(tmp_path, repeat_tables, direction):
    """An index saved by either package (with its query table) loads in
    the other with equal arrays."""
    (save_m, load_m, key) = ((rbuild, pbuild, "ref")
                             if direction == "ref_to_port"
                             else (pbuild, rbuild, "port"))
    genome, index, _ = repeat_tables[key]
    path = tmp_path / "g.npz"
    save_m.save_index(path, genome, index)
    g2, i2 = load_m.load_index(path)
    assert g2.chrom_names == genome.chrom_names
    assert np.array_equal(g2.codes, genome.codes)
    for f in ("positions", "suffix_vals", "offsets"):
        assert np.array_equal(getattr(i2, f), getattr(index, f)), f
    assert i2.qtable is not None
    assert np.array_equal(i2.qtable.table, index.qtable.table)
    assert np.array_equal(i2.qtable.meta, index.qtable.meta)


@pytest.mark.parametrize("prefilter", [True, False])
def test_oracle_and_multihit_calls_match(sim, prefilter):
    r, ri, p, pi = sim
    rcfg, pcfg = rconfig.Config(), pconfig.Config()
    assert p.reads == r.reads
    want = [roracle.call_read(r.genome, ri, n, s, rcfg, prefilter)
            for n, s in r.reads]
    got = [poracle.call_read(p.genome, pi, n, s, pcfg, prefilter)
           for n, s in p.reads]
    assert _tuples(got) == _tuples(want)
    statuses = {c.status for c in got}
    assert 0 in statuses and (3 in statuses) == prefilter
    got_m = pmultihit.call_reads_multi_batch(p.genome, pi, p.reads, pcfg,
                                             prefilter)
    want_m = rmultihit.call_reads_multi_batch(r.genome, ri, r.reads, rcfg,
                                              prefilter)
    assert _tuples(got_m) == _tuples(want_m)
    assert astuple(pmultihit.call_read_multi(
        p.genome, pi, *p.reads[0], pcfg, prefilter)) == astuple(want_m[0])


def test_objects_cross_packages_by_duck_typing(sim):
    """Each package's oracle takes the other's Genome, SeedIndex and
    Config and gives the same calls."""
    r, ri, p, pi = sim
    for name, seq in r.reads[:40]:
        a = poracle.call_read(r.genome, ri, name, seq, rconfig.Config())
        b = roracle.call_read(p.genome, pi, name, seq, pconfig.Config())
        assert astuple(a) == astuple(b)


def test_aggregator_bed_and_stats_text(sim):
    r, ri, p, pi = sim
    texts = []
    for m_agg, m_bed, m_or, s, idx, cfg in (
            (raggregate, rbed, roracle, r, ri, rconfig.Config()),
            (paggregate, pbed, poracle, p, pi, pconfig.Config())):
        agg = m_agg.Aggregator(s.genome, cfg)
        for name, seq in s.reads:
            agg.add(m_or.call_read(s.genome, idx, name, seq, cfg))
        buf = io.StringIO()
        m_bed.write_bed(buf, agg.rows(sample_name="s", prefix="p"))
        texts.append((buf.getvalue(), agg.stats.lines()))
    assert texts[0] == texts[1] and texts[1][0].count("\n") >= 8


# Chromosomes whose names sort otherwise than their index order
# ("chr1" < "chr10" < "chr2" < "chrX").
CHROMS = (("chr2", 3_000), ("chr10", 2_000), ("chrX", 2_500), ("chr1", 1_500))


def _junction_calls(module, genome, seed, n_reads=600):
    """Junction ReadCalls (of `module`'s oracle) over CHROMS: 60 keys,
    among them a circular and a linear junction at the same coordinates
    and strand on every chromosome, each key with its own signal and
    reads drawn from four sequences of its own; and 40 non-junction
    calls."""
    rng = np.random.default_rng(seed)
    keys = []
    for c, (_, length) in enumerate(CHROMS):
        off = int(genome.chrom_offsets[c])
        start = off + int(rng.integers(100, length // 2))
        end = start + int(rng.integers(50, length // 2 - 10))
        sense = int(rng.integers(0, 2))
        keys += [(1, c, start, end, sense), (0, c, start, end, sense)]
    while len(keys) < 60:
        c = int(rng.integers(0, len(CHROMS)))
        off = int(genome.chrom_offsets[c])
        start = off + int(rng.integers(100, CHROMS[c][1] // 2))
        keys.append((int(rng.integers(0, 2)), c, start,
                     start + int(rng.integers(50, 500)),
                     int(rng.integers(0, 2))))
    signals = [("GTAG", "CTAC", "ATAC", "GCAG", "ANNT")[i % 5]
               for i in range(len(keys))]
    seqs = ["".join(rng.choice(list("ACGT"), int(rng.integers(60, 101))))
            for _ in range(4 * len(keys))]
    calls = []
    for i in range(n_reads):
        j = int(rng.integers(0, len(keys)))
        kind, c, start, end, sense = keys[j]
        calls.append(module.ReadCall(
            name=f"r{i}", seq=seqs[4 * j + int(rng.integers(0, 4))],
            status=rconfig.ST_JUNCTION, kind=kind, chrom_idx=c,
            start=start, end=end, sense=sense,
            align_strand=int(rng.integers(0, 2)),
            edits=int(rng.integers(0, 3)), n_bp=int(rng.integers(1, 3)),
            overlap=int(rng.integers(0, 4)),
            qual_left=int(rng.integers(0, 21)),
            qual_right=int(rng.integers(0, 21)), signal=signals[j]))
    for i in range(40):
        calls.append(module.ReadCall(name=f"x{i}", seq="ACGT" * 20,
                                     status=int(rng.integers(1, 10))))
    rng.shuffle(calls)
    return calls


def _port_feed(agg, calls, cfg, n_scalar, batch=97):
    """The port's Aggregator fed the first `n_scalar` calls through add
    and the junction calls after them through add_batch, `batch` rows of
    unpacked result columns at a time, hashed as run_fastq hashes them."""
    for call in calls[:n_scalar]:
        agg.add(call)
    rest = [c for c in calls[n_scalar:] if c.status == rconfig.ST_JUNCTION]
    agg.stats.add("reads_total", len(calls) - n_scalar - len(rest))
    for c in calls[n_scalar:]:
        if c.status != rconfig.ST_JUNCTION:
            agg.stats.add_status(c.status)
    for lo in range(0, len(rest), batch):
        part = rest[lo:lo + batch]
        res = {f: np.array([getattr(c, a) for c in part], np.int32)
               for f, a in (("kind", "kind"), ("chrom", "chrom_idx"),
                            ("sense", "sense"), ("align_strand",
                                                 "align_strand"),
                            ("qual_left", "qual_left"),
                            ("qual_right", "qual_right"),
                            ("edits", "edits"), ("overlap", "overlap"),
                            ("n_bp", "n_bp"))}
        for f in ("start", "end"):
            res[f] = np.array([getattr(c, f) for c in part], np.uint32)
        res["signal"] = np.stack([ptwobit.seq_to_codes(c.signal)
                                  for c in part])
        arr = np.full((len(part), cfg.max_read_len), pconfig.RPAD_CODE,
                      np.uint8)
        for i, c in enumerate(part):
            arr[i, :len(c.seq)] = ptwobit.seq_to_codes(c.seq)
        agg.add_batch(res, np.arange(len(part)),
                      paggregate.seq_hash_batch(arr))


def _bed(bed_m, rows):
    buf = io.StringIO()
    bed_m.write_bed(buf, rows)
    return buf.getvalue()


def _text(bed_m, agg, prefix):
    return _bed(bed_m, agg.rows(sample_name="s", prefix=prefix)), \
        agg.stats.lines()


def _three_beds(bed_m, agg, prefix):
    """The BED written from the rows untouched (the port writes its
    table's columns), from the same rows once iterated (the port writes
    its row objects), and from the rows passes_filter keeps."""
    rows = agg.rows(sample_name="s", prefix=prefix)
    beds = [_bed(bed_m, rows)]
    every = list(rows)
    beds.append(_bed(bed_m, rows))
    kept = [r for r in rows if bed_m.passes_filter(r)]
    assert 0 < len(kept) < len(every)
    beds.append(_bed(bed_m, kept))
    return beds, agg.stats.lines()


@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("prefix", ["", "T_"])
@pytest.mark.parametrize("n_scalar", [0, 250, 640])
def test_columnar_table_matches_reference_aggregator(stranded, prefix,
                                                     n_scalar):
    """The port's table fed through add and add_batch in turns (the same
    junction across batches and across both paths) against the
    reference's fed every call through add: BED and stats as text, the
    BED written from the rows untouched, from the rows once iterated and
    from the filter's rows (`_three_beds`)."""
    texts = []
    for m_agg, m_bed, m_or, m_cfg, m_genome in (
            (raggregate, rbed, roracle, rconfig, rgenome),
            (paggregate, pbed, poracle, pconfig, pgenome)):
        cfg = m_cfg.Config(stranded=stranded)
        genome = m_genome.Genome.from_records(
            [(n, "ACGT" * (ln // 4)) for n, ln in CHROMS], cfg)
        calls = _junction_calls(m_or, genome, seed=5)
        agg = m_agg.Aggregator(genome, cfg)
        if m_agg is raggregate:
            for call in calls:
                agg.add(call)
        else:
            _port_feed(agg, calls, cfg, n_scalar)
        texts.append(_three_beds(m_bed, agg, prefix))
    assert texts[0] == texts[1]
    bed = texts[1][0][0]
    assert texts[1][0][1] == bed
    rows = [line.split("\t") for line in bed.splitlines()[1:]]
    assert [r[0] for r in rows] == sorted(r[0] for r in rows)
    assert any(int(r[6]) < int(r[4]) for r in rows)        # n_uniq < n_reads
    same = [(r[1], r[2], r[5]) for r in rows]
    assert len(set(same)) < len(same)       # circular and linear coincide


def test_merge_from_equals_one_joint_run():
    """Two processes' tables, sharing junctions and sequences, merged
    through read_columns (pickled, as find_circ --nproc hands them over)
    and merge_from: the same table, BED and stats as one joint run."""
    import pickle
    cfg = pconfig.Config(stranded=True)
    genome = pgenome.Genome.from_records(
        [(n, "ACGT" * (ln // 4)) for n, ln in CHROMS], cfg)
    calls = _junction_calls(poracle, genome, seed=9)
    joint = paggregate.Aggregator(genome, cfg)
    _port_feed(joint, calls, cfg, 300)
    ranks = [paggregate.Aggregator(genome, cfg) for _ in range(2)]
    _port_feed(ranks[0], calls[0::2], cfg, 150)
    _port_feed(ranks[1], calls[1::2], cfg, 40)
    ranks[0].merge_from(pickle.loads(pickle.dumps(ranks[1].read_columns())))
    for k, v in ranks[1].stats.counts.items():
        ranks[0].stats.add(k, v)
    want, got = joint.table(), ranks[0].table()
    assert set(want) == set(got)
    for f in want:
        assert np.array_equal(want[f], got[f]), f
    assert (got["n_uniq"] < got["n_reads"]).any()
    assert _text(pbed, joint, "p") == _text(pbed, ranks[0], "p")


def test_table_order_is_renumbers():
    """The table's one sort gives io/bed.renumber's order, and the
    category table its strings: rows sorted and named again by renumber
    come out unchanged."""
    cfg = pconfig.Config(stranded=True)
    genome = pgenome.Genome.from_records(
        [(n, "ACGT" * (ln // 4)) for n, ln in CHROMS], cfg)
    agg = paggregate.Aggregator(genome, cfg)
    _port_feed(agg, _junction_calls(poracle, genome, seed=3), cfg, 100)
    rows = agg.rows(prefix="q")
    want = [astuple(r) for r in rows]
    again = pbed.renumber([dataclasses.replace(r, name="") for r in
                           reversed(rows)], "q")
    assert [astuple(r) for r in again] == want
    for r in rows:
        assert r.category == paggregate.category_flags(
            r.category.startswith("CIRCULAR"), r.breakpoints,
            r.uniq_bridges, r.signal, r.strandmatch)
    empty = paggregate.Aggregator(genome, cfg)
    assert empty.rows() == []
    assert empty.stats.lines() == ["circular_junctions\t0",
                                   "linear_junctions\t0"]


@pytest.mark.parametrize("first", ["len", "index", "iter", "reversed",
                                   "eq", "write"])
def test_junction_rows_behave_as_their_list(first):
    """`rows()`'s JunctionRows against the list of JunctionRow it stands
    for, whichever of its list operations a caller asks for first: the
    rows are built once, on the first that needs a row, and each line
    written from the columns is that row's to_line."""
    cfg = pconfig.Config(stranded=True)
    genome = pgenome.Genome.from_records(
        [(n, "ACGT" * (ln // 4)) for n, ln in CHROMS], cfg)
    agg = paggregate.Aggregator(genome, cfg)
    _port_feed(agg, _junction_calls(poracle, genome, seed=4), cfg, 60)
    want = list(agg.rows(sample_name="s", prefix="q"))
    assert type(want[0]) is pbed.JunctionRow and len(want) > 10
    rows = agg.rows(sample_name="s", prefix="q")
    assert isinstance(rows, pbed.JunctionRows) and rows.built is None
    ops = {"len": lambda: len(rows) == len(want),
           "index": lambda: (rows[0], rows[-1], rows[2:5])
           == (want[0], want[-1], want[2:5]),
           "iter": lambda: [r for r in rows] == want,
           "reversed": lambda: list(reversed(rows)) == want[::-1],
           "eq": lambda: rows == want and want == rows
           and rows != want[:-1] and rows != tuple(want),
           "write": lambda: _bed(pbed, rows).splitlines()[1:]
           == [r.to_line() for r in want]}
    assert ops[first]()
    assert (rows.built is None) == (first in ("len", "write"))
    built = rows.built
    for name, op in ops.items():
        assert op(), name
    assert rows.built is not None and (built is None
                                       or rows.built is built)
    assert rows == agg.rows(sample_name="s", prefix="q")
    empty = paggregate.Aggregator(genome, cfg).rows()
    assert empty == [] and len(empty) == 0 and list(empty) == []
    assert _bed(pbed, empty) == pbed.HEADER + "\n"


def test_journal_records_match(tmp_path, sim):
    """Both packages' journals write the same bytes for the same calls,
    and each replays the other's."""
    r, ri, p, pi = sim
    calls = {m: [m_or.call_read(s.genome, idx, n, q, m_cfg.Config())
                 for n, q in s.reads[:30]]
             for m, m_or, s, idx, m_cfg in (
                 ("r", roracle, r, ri, rconfig), ("p", poracle, p, pi,
                                                  pconfig))}
    for m, m_j in (("r", rjournal), ("p", pjournal)):
        j = m_j.RunJournal(tmp_path / f"{m}.jsonl", meta={"nproc": 1})
        j.record(0, calls[m])
        j.record_fast(1, m_j.FastBatch(n_reads=40, counts={3: 10},
                                       calls=calls[m][:5]))
    assert _bytes(tmp_path / "r.jsonl") == _bytes(tmp_path / "p.jsonl")
    got = pjournal.RunJournal(tmp_path / "r.jsonl").completed_batches()
    assert _tuples(got[0]) == _tuples(calls["r"])
    assert got[1].counts == {3: 10} and got[1].n_reads == 40


def test_native_loader_matches(tmp_path):
    """parse_fastq, encode_reads and segsearch of the port's native
    library (built under build/native/) against the reference's."""
    assert pnative.available() and rnative.available()
    assert os.path.dirname(pnative.library_path()) == pnative.BUILD_DIR
    data = _bytes(os.path.join(DATA, "reads.fastq"))
    spans, resume = pnative.parse_fastq(data)
    rspans, rresume = rnative.parse_fastq(data)
    assert np.array_equal(spans, rspans) and resume == rresume
    n, lp = spans.shape[0], 120
    outs = []
    for m, lut in ((pnative, ptwobit._CODE_LUT), (rnative,
                                                  rtwobit._CODE_LUT)):
        out = np.full((n, lp), 6, np.uint8)
        lens = np.zeros(n, np.int32)
        m.encode_reads(data, spans[:, 2], spans[:, 3], out, lens, lut)
        outs.append((out, lens))
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    assert (outs[0][1] < 0).any() and (outs[0][1] > 0).any()
    rng = np.random.default_rng(4)
    sv = np.sort(rng.integers(0, 2 ** 16, 5000).astype(np.uint16))
    lo = rng.integers(0, 2500, 300)
    hi = lo + rng.integers(0, 2500, 300)
    keys = rng.integers(0, 2 ** 16, 300)
    got = pnative.segsearch(sv, lo, hi, keys)
    want = rnative.segsearch(sv, lo, hi, keys)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("which", ["simulate", "rnase_r_library"])
def test_simulators_match(which):
    if which == "simulate":
        kw = dict(seed=3, n_circ=5, n_linear=3)
    else:
        kw = dict(seed=5, chrom_lengths={"chrR": 80_000}, n_circ=10,
                  n_linear=2, depth_mean=3.0)
    r = getattr(rsimulate, which)(**kw)
    p = getattr(psimulate, which)(**kw)
    assert np.array_equal(p.genome.codes, r.genome.codes)
    assert p.genome.chrom_names == r.genome.chrom_names
    assert p.reads == r.reads and len(p.reads) > 20
    assert _tuples(p.truths) == _tuples(r.truths)


def test_stage_times_report():
    reports = []
    for m in (rprofiling, pprofiling):
        t = m.StageTimes(totals={"encode": 0.5, "device_detect": 1.25},
                         counts={"encode": 3, "device_detect": 4})
        t.add_reads(12345)
        reports.append((t.report(), t.report(wall=2.0)))
    assert reports[0] == reports[1]


def _cli_args(which, tmp_path):
    bed = os.path.join(DATA, "splice_sites.bed")
    cand = os.path.join(DATA, "circ_candidates.bed")
    if which == "cmp_bed":
        return [bed, cand]
    if which == "merge_bed":
        return [bed, cand, "-p", "m", "-o", str(tmp_path / "out")]
    if which == "maxlength":
        return [bed, "300", "-o", str(tmp_path / "out")]
    if which == "unmapped2anchors_sam":
        sam = tmp_path / "in.sam"
        if not sam.exists():
            _write_sam(sam, _sam_records(rsam))
        return [str(sam), "-o", str(tmp_path / "out")]
    return [os.path.join(DATA, "reads.fastq"), "-o", str(tmp_path / "out")]


@pytest.mark.parametrize("which", ["cmp_bed", "merge_bed", "maxlength",
                                   "unmapped2anchors",
                                   "unmapped2anchors_sam"])
def test_aux_clis_match(tmp_path, capsys, which):
    """The four auxiliary CLIs on test_data/: same exit code, standard
    output and output bytes."""
    mods = {"cmp_bed": (rcmp_bed, pcmp_bed),
            "merge_bed": (rmerge_bed, pmerge_bed),
            "maxlength": (rmaxlength, pmaxlength)}.get(
        which, (runmapped2anchors, punmapped2anchors))
    got = []
    for m in mods:
        rc = m.main(_cli_args(which, tmp_path))
        out = tmp_path / "out"
        got.append((rc, capsys.readouterr().out,
                    _bytes(out) if out.exists() else None))
        if out.exists():
            out.unlink()
    assert got[0] == got[1]
    assert got[1][1] or got[1][2]
