"""The one traffic generator: a library of reads from a configuration's
genome, drawn from `--seed` by the parameters of a traffic file
(`portbench/traffic/<traffic>.json`).

Two sources of junction reads, named by the file's `junctions`:

- `"loci"`: the configuration's planted loci, as the port's
  `utils/simulate.rnase_r_library` reads them (vectorised here).
  `circ_draws` circular and `linear_draws` linear draws go over the
  eligible loci (`loci`: `"all"`, or `"unique_flanks"`: only loci whose
  flanks lie outside the planted repeats) as evenly as their numbers
  allow, and each draw takes a depth from the quantiles of 1 +
  geometric(mean `*_depth_mean`). Contiguous and noise reads are then
  added as the shares `contiguous_frac` and `noise_frac` of the whole
  library. The seed orders the loci and the depths: every seed gets the
  same numbers of reads and the same depths, on other loci, so that the
  work of a pass does not move with the seed.
- `"random"`: backsplice junctions drawn per read anywhere in the genome,
  as `bench.py`'s `make_bench_data` draws them (span in `span`), the
  share `backsplice_frac` of `n_reads`, the rest contiguous reads.

Every junction read crosses its junction at a breakpoint uniform in
[anchor, read_len - anchor]. A read takes a Poisson number of
substitutions with mean `errors_per_read` (independent base errors; the
port's rnase_r_library gives at most one), and a junction read is
reverse-complemented with probability `revcomp_frac`. The reads are
shuffled, named `r<i>`, and written as FASTQ with quality `I`.

`mates: 2` makes a paired-end library (`make_pairs`, loci traffic
only), two files as `find_circ --pe` reads them. A draw's depth and the
shares then count fragments. A fragment is `insert_mean` +- `insert_sd`
bases long (normal, clipped to at least `read_len`); a junction fragment
crosses its junction at an offset uniform in [anchor, length - anchor],
so the junction lies in mate 1, in mate 2, in both (a fragment shorter
than two reads) or in neither, and a circle shorter than its fragment is
read around again. Mate 1 reads the fragment's first `read_len` bases,
mate 2 the reverse complement of its last; a fragment is read from its
other strand, mate 1 antisense and mate 2 sense, with probability
`revcomp_frac` (1.0: dUTP / TruSeq Stranded libraries). Each mate takes
its own substitutions. Pair i is `r<i>/1` in the first file and `r<i>/2`
in the second (SPEC.md §7).
"""

from __future__ import annotations

import numpy as np

_ASCII = np.frombuffer(b"ACGTN", np.uint8)


def _junction_reads(rng, codes, offs, chrom, j1, j2, circular, L, a):
    """Reads of length L over junctions (j1, j2), chromosome-local: a
    circle's [j2 - bp, j2) + [j1, j1 + L - bp), an intron's [j1 - bp,
    j1) + [j2, j2 + L - bp)."""
    n = chrom.size
    bp = rng.integers(a, L - a + 1, size=n)
    left_end = np.where(circular, j2, j1) + offs[chrom]
    right_start = np.where(circular, j1, j2) + offs[chrom]
    cols = np.arange(L)[None, :]
    idx = np.where(cols < bp[:, None],
                   left_end[:, None] - bp[:, None] + cols,
                   right_start[:, None] + cols - bp[:, None])
    return codes[idx]


def _contiguous(rng, codes, offs, lens, n, L):
    c = rng.integers(0, lens.size, size=n)
    p = rng.integers(0, lens[c] - L) + offs[c]
    return codes[p[:, None] + np.arange(L)[None, :]]


def _depths(n: int, mean: float) -> np.ndarray:
    """n depths at the midpoint quantiles of 1 + geometric(1 / mean)."""
    u = (np.arange(n) + 0.5) / n
    p = 1.0 / mean
    return 1 + np.ceil(np.log1p(-u) / np.log1p(-p)).astype(np.int64)


def _locus_draws(rng, genome, traffic):
    """Per junction kind, (circular, chrom, j1, j2) of every draw over the
    eligible loci, each repeated by its depth. A generator: the caller
    draws from `rng` between the kinds, in the order make_reads always
    has."""
    for kind, draws, mean in (
            ("circular", traffic["circ_draws"], traffic["circ_depth_mean"]),
            ("linear", traffic["linear_draws"],
             traffic["linear_depth_mean"])):
        lk = genome["loci"][kind]
        ok = (np.flatnonzero(lk["clean"])
              if traffic["loci"] == "unique_flanks"
              else np.arange(lk["chrom"].size))
        if draws and not ok.size:
            raise ValueError(f"no eligible {kind} locus")
        pick = np.tile(ok, -(-int(draws) // max(ok.size, 1)))
        pick = rng.permutation(pick)[:int(draws)]
        depth = rng.permutation(_depths(pick.size, float(mean)))
        at = np.repeat(pick, depth)
        yield kind == "circular", lk["chrom"][at], lk["j1"][at], lk["j2"][at]


def _shares(traffic, n_junction: int) -> tuple[int, int]:
    """Contiguous and noise counts that make up their shares of the
    library beside n_junction junction reads (or fragments)."""
    rest = 1.0 - traffic["contiguous_frac"] - traffic["noise_frac"]
    return (int(traffic["contiguous_frac"] * n_junction / rest),
            int(traffic["noise_frac"] * n_junction / rest))


def _mutate(rng, reads, rate):
    """Poisson(`rate`) substitutions in each read, each at a uniform
    position and to one of the three other bases (the port's `_mutate`
    per substitution; a position may be drawn twice)."""
    n, L = reads.shape
    count = rng.poisson(rate, size=n)
    for k in range(int(count.max(initial=0))):
        hit = np.flatnonzero(count > k)
        at = rng.integers(0, L, size=hit.size)
        shift = 1 + rng.integers(0, 3, size=hit.size)
        reads[hit, at] = (reads[hit, at] + shift) % 4


def _revcomp(rng, reads, rate):
    flip = rng.random(reads.shape[0]) < rate
    reads[flip] = 3 - reads[flip, ::-1]


def make_reads(genome: dict, traffic: dict, seed: int,
               anchor_len: int) -> np.ndarray:
    """uint8 codes [n_reads, read_len] of the library for `seed`."""
    rng = np.random.default_rng(seed)
    codes, offs = genome["codes"], genome["chrom_offsets"]
    lens = genome["chrom_lengths"]
    L, a = int(traffic["read_len"]), anchor_len
    if traffic["junctions"] == "loci":
        junction = np.concatenate([
            _junction_reads(rng, codes, offs, chrom, j1, j2, circular, L, a)
            for circular, chrom, j1, j2 in _locus_draws(rng, genome,
                                                        traffic)])
        n_cont, n_noise = _shares(traffic, junction.shape[0])
    else:
        n_reads = int(traffic["n_reads"])
        n_bs = int(round(traffic["backsplice_frac"] * n_reads))
        c = rng.integers(0, lens.size, size=n_bs)
        lo, hi = traffic["span"]
        span = rng.integers(lo, hi, size=n_bs)
        start = rng.integers(500, lens[c] - hi - 500)
        junction = _junction_reads(rng, codes, offs, c, start, start + span,
                                   np.ones(n_bs, bool), L, a)
        n_cont, n_noise = n_reads - n_bs, 0
    _mutate(rng, junction, traffic["errors_per_read"])
    _revcomp(rng, junction, traffic["revcomp_frac"])
    cont = _contiguous(rng, codes, offs, lens, n_cont, L)
    _mutate(rng, cont, traffic["errors_per_read"])
    noise = rng.integers(0, 4, size=(n_noise, L), dtype=np.uint8)
    reads = np.concatenate([junction, cont, noise]).astype(np.uint8)
    return reads[rng.permutation(reads.shape[0])]


def _fragment_ends(rng, codes, offs, lens, chrom, j1, j2, circular: bool,
                   ins, L, a):
    """The first and the last L bases of fragments of lengths `ins` over
    junctions (j1, j2), chromosome-local, and each junction's offset in
    its fragment. A circle's fragment runs [j2 - bp, j2) and on round the
    circle from j1; an intron's runs [j1 - bp, j1) + [j2, ...), its
    offset kept inside the chromosome."""
    bp = rng.integers(a, ins - a + 1)
    if not circular:
        bp = np.clip(bp, np.maximum(a, ins - (lens[chrom] - j2)),
                     np.minimum(ins - a, j1))
    b, s, e = bp[:, None], j1[:, None], j2[:, None]
    base = offs[chrom][:, None]

    def at(k):
        if circular:
            return codes[base + s + np.mod(e - s - b + k, e - s)]
        return codes[base + np.where(k < b, s - b + k, e + k - b)]
    cols = np.arange(L)[None, :]
    return at(cols), at(ins[:, None] - L + cols), bp


def _contiguous_ends(rng, codes, offs, lens, ins, L):
    c = rng.integers(0, lens.size, size=ins.size)
    p = rng.integers(0, lens[c] - ins) + offs[c]
    cols = np.arange(L)[None, :]
    return (codes[p[:, None] + cols],
            codes[(p + ins - L)[:, None] + cols], p)


def _rc(reads: np.ndarray) -> np.ndarray:
    return 3 - reads[:, ::-1]


def make_pairs(genome: dict, traffic: dict, seed: int, anchor_len: int
               ) -> tuple[np.ndarray, np.ndarray, dict]:
    """uint8 codes [n_pairs, read_len] of mate 1 and of mate 2 of the
    paired library for `seed` (`mates: 2`), in pair order, and per pair
    its fragment: `source` (0 circular, 1 linear, 2 contiguous, 3
    noise), `ins` its length, `bp` the junction's offset in it (-1
    without), `j1`, `j2` the junction's genome positions (contiguous:
    the fragment's start, and -1), `flip` whether it was read from its
    other strand."""
    if traffic["junctions"] != "loci":
        raise ValueError("a paired library (mates: 2) needs loci traffic")
    rng = np.random.default_rng(seed)
    codes, offs = genome["codes"], genome["chrom_offsets"]
    lens = genome["chrom_lengths"]
    L, a = int(traffic["read_len"]), anchor_len
    mean, sd = float(traffic["insert_mean"]), float(traffic["insert_sd"])

    def inserts(n):
        return np.maximum(np.rint(rng.normal(mean, sd, size=n)),
                          L).astype(np.int64)
    heads, tails, info = [], [], []
    for circular, chrom, j1, j2 in _locus_draws(rng, genome, traffic):
        ins = inserts(chrom.size)
        h, t, bp = _fragment_ends(rng, codes, offs, lens, chrom, j1, j2,
                                  circular, ins, L, a)
        heads.append(h)
        tails.append(t)
        o = offs[chrom]
        info.append((np.full(ins.size, 0 if circular else 1), ins, bp,
                     j1 + o, j2 + o))
    n_cont, n_noise = _shares(traffic, sum(h.shape[0] for h in heads))
    ins = inserts(n_cont)
    h, t, p = _contiguous_ends(rng, codes, offs, lens, ins, L)
    heads.append(h)
    tails.append(t)
    info.append((np.full(n_cont, 2), ins, np.full(n_cont, -1), p,
                 np.full(n_cont, -1)))
    heads.append(rng.integers(0, 4, size=(n_noise, L), dtype=np.uint8))
    tails.append(rng.integers(0, 4, size=(n_noise, L), dtype=np.uint8))
    none = np.full(n_noise, -1)
    info.append((np.full(n_noise, 3), none, none, none, none))
    head = np.concatenate(heads).astype(np.uint8)
    tail = np.concatenate(tails).astype(np.uint8)
    _mutate(rng, head, traffic["errors_per_read"])
    _mutate(rng, tail, traffic["errors_per_read"])
    n = head.shape[0]
    flip = rng.random(n) < traffic["revcomp_frac"]
    mate1 = np.where(flip[:, None], _rc(tail), head)
    mate2 = np.where(flip[:, None], head, _rc(tail))
    order = rng.permutation(n)
    fields = dict(zip(("source", "ins", "bp", "j1", "j2"),
                      (np.concatenate(f).astype(np.int64)
                       for f in zip(*info))))
    fields["flip"] = flip
    return (mate1[order], mate2[order],
            {k: v[order] for k, v in fields.items()})


def make_library(genome: dict, traffic: dict, seed: int,
                 anchor_len: int) -> list[np.ndarray]:
    """The library for `seed` as the reads of each FASTQ file: one file
    of single reads, or mate 1's and mate 2's with `mates: 2`."""
    if int(traffic.get("mates", 1)) == 2:
        return list(make_pairs(genome, traffic, seed, anchor_len)[:2])
    return [make_reads(genome, traffic, seed, anchor_len)]


def fastq_bytes(reads: np.ndarray, suffix: bytes = b"") -> bytes:
    """The reads as FASTQ records `@r<i><suffix>`, quality `I`
    throughout."""
    n, L = reads.shape
    seqs = _ASCII[reads]
    qual = b"I" * L
    return b"".join(b"@r%d%s\n%s\n+\n%s\n"
                    % (i, suffix, seqs[i].tobytes(), qual)
                    for i in range(n))


def fastq_files(files: list[np.ndarray]) -> list[bytes]:
    """Each file of a library as FASTQ: `@r<i>`, or `@r<i>/1` and
    `@r<i>/2` for the two mates of pair i."""
    if len(files) == 1:
        return [fastq_bytes(files[0])]
    return [fastq_bytes(r, b"/%d" % (k + 1)) for k, r in enumerate(files)]
