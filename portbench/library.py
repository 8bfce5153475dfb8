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
        parts = []
        for kind, draws, mean in (
                ("circular", traffic["circ_draws"],
                 traffic["circ_depth_mean"]),
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
            parts.append(_junction_reads(rng, codes, offs, lk["chrom"][at],
                                         lk["j1"][at], lk["j2"][at],
                                         kind == "circular", L, a))
        junction = np.concatenate(parts)
        rest = 1.0 - traffic["contiguous_frac"] - traffic["noise_frac"]
        n_cont = int(traffic["contiguous_frac"] * junction.shape[0] / rest)
        n_noise = int(traffic["noise_frac"] * junction.shape[0] / rest)
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


def fastq_bytes(reads: np.ndarray) -> bytes:
    """The reads as FASTQ records `@r<i>`, quality `I` throughout."""
    n, L = reads.shape
    seqs = _ASCII[reads]
    qual = b"I" * L
    return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual)
                    for i in range(n))
