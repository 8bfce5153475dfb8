"""The genome generator and the traffic generator: the configuration fixes
the genome and its loci, `--seed` draws only the library, and the
unique-flanks mix draws no locus whose flanks touch a planted repeat."""

import numpy as np
import pytest

from portbench import genome as pg
from portbench import library
from portbench.tests.tiny import tiny_conf, tiny_traffic

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
