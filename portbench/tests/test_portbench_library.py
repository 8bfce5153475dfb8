"""The genome generator and the traffic generator: the configuration fixes
the genome and its loci, `--seed` draws only the library, the
unique-flanks mix draws no locus whose flanks touch a planted repeat,
and a paired library's mates are the two ends of one fragment."""

import numpy as np
import pytest

from portbench import genome as pg
from portbench import library
from portbench.tests.tiny import pe_traffic, tiny_conf, tiny_traffic

A = 20


@pytest.fixture(scope="module")
def g():
    return pg.make_genome(tiny_conf(n_circ=150, n_linear=30))


def test_layout_is_the_ports_genome(g):
    from find_circ2_tpu_torch.config import Config
    from find_circ2_tpu_torch.io.genome import Genome
    off = g["chrom_offsets"][0]
    seq = g["codes"][off:off + g["chrom_lengths"][0]]
    port = Genome.from_records([("chrT", seq)], Config())
    np.testing.assert_array_equal(port.codes, g["codes"])
    np.testing.assert_array_equal(port.chrom_offsets, g["chrom_offsets"])


def test_genome_and_loci_do_not_depend_on_the_library_seed(g):
    again = pg.make_genome(tiny_conf(n_circ=150, n_linear=30))
    np.testing.assert_array_equal(g["codes"], again["codes"])
    for kind in ("circular", "linear"):
        for f in ("chrom", "j1", "j2", "clean"):
            np.testing.assert_array_equal(g["loci"][kind][f],
                                          again["loci"][kind][f])
    before = g["codes"].copy()
    library.make_reads(g, tiny_traffic(), 5, A)
    np.testing.assert_array_equal(before, g["codes"])


def test_loci_carry_their_splice_signals(g):
    """AG before a circle's start, GT at its end; a locus planted later
    may overwrite an earlier one's, as in rnase_r_library, so most, not
    all."""
    off = g["chrom_offsets"][0]
    c = g["loci"]["circular"]
    s, e = c["j1"] + off, c["j2"] + off
    codes = g["codes"]
    ok = ((codes[s - 2] == 0) & (codes[s - 1] == 2) & (codes[e] == 2)
          & (codes[e + 1] == 3))
    assert ok.mean() > 0.95


@pytest.mark.parametrize("kind", ["enriched", "unique_flanks", "mixed"])
def test_same_seed_same_library_other_seed_other(g, kind):
    t = tiny_traffic(kind) if kind != "mixed" else dict(
        tiny_traffic("mixed"), n_reads=2000)
    big = 2 ** 31 + 12345
    a = library.make_reads(g, t, big, A)
    b = library.make_reads(g, t, big, A)
    c = library.make_reads(g, t, big + 1, A)
    np.testing.assert_array_equal(a, b)
    assert a.shape[1] == t["read_len"] and a.max() < 4
    assert a.shape == c.shape and not np.array_equal(a, c)
    fq = library.fastq_bytes(a[:3])
    assert fq.count(b"\n") == 12 and fq.startswith(b"@r0\n")


def test_clean_flags_match_the_repeat_mask(g):
    m = g["repeat_mask"][0]
    flank = tiny_conf()["loci"]["flank"]
    for lk in g["loci"].values():
        for i in range(lk["chrom"].size):
            touched = any(m[max(0, j - flank):j + flank].any()
                          for j in (lk["j1"][i], lk["j2"][i]))
            assert lk["clean"][i] == (not touched)
    assert 0 < g["loci"]["circular"]["clean"].sum() < \
        g["loci"]["circular"]["clean"].size


def _junction_kmers(g, kind, idx):
    """The 2A bases every read over circle i holds: A before its end, A
    from its start (an intron: A before the donor, A from the acceptor);
    and their reverse complements."""
    off = g["chrom_offsets"][0]
    lk = g["loci"][kind]
    out = set()
    for i in idx:
        j1, j2 = lk["j1"][i] + off, lk["j2"][i] + off
        left, right = (j2, j1) if kind == "circular" else (j1, j2)
        k = np.concatenate([g["codes"][left - A:left],
                            g["codes"][right:right + A]])
        out.add(k.tobytes())
        out.add((3 - k[::-1]).tobytes())
    return out


def _found(reads, kmers) -> bool:
    for r in reads:
        b = r.tobytes()
        for s in range(r.size - 2 * A + 1):
            if b[s:s + 2 * A] in kmers:
                return True
    return False


def test_unique_flanks_draws_no_locus_in_repeats(g):
    dirty = np.flatnonzero(~g["loci"]["circular"]["clean"])
    kmers = _junction_kmers(g, "circular", dirty)
    unique = library.make_reads(g, tiny_traffic("unique_flanks"), 9, A)
    assert not _found(unique, kmers)
    enriched = library.make_reads(g, tiny_traffic("enriched"), 9, A)
    assert _found(enriched, kmers)


def _fragment(codes, info, i) -> np.ndarray:
    """Pair i's fragment from its geometry, base by base."""
    src, n, bp, j1, j2 = (int(info[k][i])
                          for k in ("source", "ins", "bp", "j1", "j2"))
    if src == 0:
        return np.array([codes[j1 + (j2 - j1 - bp + k) % (j2 - j1)]
                         for k in range(n)])
    if src == 1:
        return np.array([codes[j1 - bp + k] if k < bp else codes[j2 + k - bp]
                         for k in range(n)])
    return codes[j1:j1 + n]


@pytest.fixture(scope="module")
def g_short():
    """Circles of 100 to 400 bases, many shorter than their fragments."""
    conf = tiny_conf(n_circ=150, n_linear=30)
    conf["loci"]["circ_span"] = [100, 400]
    return pg.make_genome(conf)


@pytest.mark.parametrize("revcomp_frac", [1.0, 0.5],
                         ids=["dutp", "either_strand"])
def test_mates_are_the_ends_of_one_fragment(g_short, revcomp_frac):
    """Mate 1 the fragment's first read_len bases and mate 2 the reverse
    complement of its last, or the two the other way round on a fragment
    read from its other strand; the junction in mate 1, mate 2, both or
    neither; every circle base from the circle, short circles read round
    again."""
    t = dict(pe_traffic(), errors_per_read=0.0, revcomp_frac=revcomp_frac)
    g = g_short
    m1, m2, info = library.make_pairs(g, t, 2 ** 31 + 3, A)
    L = t["read_len"]
    assert m1.shape == m2.shape and m1.shape[1] == L
    for i in range(m1.shape[0]):
        if info["source"][i] == 3:
            continue
        f = _fragment(g["codes"], info, i)
        head, tail = f[:L], 3 - f[-L:][::-1]
        pair = (tail, head) if info["flip"][i] else (head, tail)
        np.testing.assert_array_equal(m1[i], pair[0])
        np.testing.assert_array_equal(m2[i], pair[1])
    assert info["flip"].all() == (revcomp_frac == 1.0)
    assert info["flip"].any()
    j = info["bp"] >= 0
    ins, bp = info["ins"][j], info["bp"][j]
    assert (ins >= L).all() and ((bp >= A) & (bp <= ins - A)).all()
    in1, in2 = bp < L, bp > ins - L
    for where in (in1 & ~in2, ~in1 & in2, in1 & in2, ~in1 & ~in2):
        assert where.sum() > 10
    circ = info["source"] == 0
    assert (info["ins"][circ] > info["j2"][circ] - info["j1"][circ]).any()
    fq = library.fastq_files([m1[:2], m2[:2]])
    assert fq[0].startswith(b"@r0/1\n") and b"\n@r1/1\n" in fq[0]
    assert fq[1].startswith(b"@r0/2\n") and b"\n@r1/2\n" in fq[1]


def test_pair_counts_do_not_move_with_the_seed(g):
    """Every seed makes as many fragments of each source with the same
    depths; the same seed the same library, another seed another."""
    t = pe_traffic()
    big = 2 ** 31 + 12345
    a, b, c = (library.make_pairs(g, t, s, A) for s in (big, big, big + 1))
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == c[0].shape
    np.testing.assert_array_equal(np.bincount(a[2]["source"]),
                                  np.bincount(c[2]["source"]))
    for src in (0, 1):
        depth = [np.sort(np.unique(r[2]["j1"][r[2]["source"] == src],
                                   return_counts=True)[1])
                 for r in (a, c)]
        np.testing.assert_array_equal(*depth)
    assert [m.shape for m in library.make_library(g, t, big, A)] == \
        [a[0].shape, a[1].shape]


def test_pairs_need_loci_traffic(g):
    t = dict(tiny_traffic("mixed"), n_reads=2000, mates=2, read_len=150,
             insert_mean=300, insert_sd=60)
    with pytest.raises(ValueError, match="loci"):
        library.make_library(g, t, 7, A)
