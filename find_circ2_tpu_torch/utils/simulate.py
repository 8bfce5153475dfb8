"""Synthetic genome / read simulator with known ground-truth junctions.

Stands in for the reference's bundled test dataset (SURVEY.md §4): the
mount being empty, golden fixtures are generated here with fixed seeds and
validated against the CPU oracle. Used by tests and bench.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from find_circ2_tpu_torch.config import Config
from find_circ2_tpu_torch.io.genome import Genome
from find_circ2_tpu_torch.io.twobit import (codes_to_seq, revcomp_seq,
                                           seq_to_codes)


@dataclass
class TrueJunction:
    kind: str          # "circular" | "linear"
    chrom: str
    start: int         # per-chromosome coords, SPEC.md §4 conventions
    end: int
    reads: list = field(default_factory=list)


@dataclass
class SimData:
    genome: Genome
    reads: list          # list[(name, seq)]
    truths: list         # list[TrueJunction]


def random_genome(rng: np.random.Generator, chrom_lengths: dict[str, int],
                  cfg: Config = Config()) -> tuple[Genome, dict[str, np.ndarray]]:
    seqs = {name: rng.integers(0, 4, size=n, dtype=np.uint8)
            for name, n in chrom_lengths.items()}
    genome = Genome.from_records(list(seqs.items()), cfg)
    return genome, seqs


def plant_repeats(rng: np.random.Generator, seq: np.ndarray,
                  frac: float) -> dict:
    """Overwrite ~`frac` of `seq` with repeat-family copies, in place.

    Real genomes are ~45-50% repetitive; an IID-random bench genome makes
    the repetitive-20-mer guard (SPEC.md §2 MAX_BUCKET), cuckoo-table
    load, and gather locality unrealistically friendly (VERDICT r1 "weak
    1"). Three families model the dominant human repeat classes:

      - SAT:  171 bp unit (alpha-satellite-like) in tandem arrays of
              20-200 copies, ~2% per-copy divergence — dense exact-k-mer
              multiplicity, exercises MAX_BUCKET hard;
      - SINE: 300 bp element (Alu-like), dispersed, ~10% divergence —
              the high-copy-count mid-multiplicity regime;
      - LINE: 4 kb element (L1-like), dispersed, 5'-truncated to a
              random suffix, ~15% divergence — long low-multiplicity
              near-duplicates.

    Budget split 30/45/25% of `frac`. Copies may overlap each other
    (realistic: nested/fragmented repeats). Returns per-family planted
    base counts."""
    glen = int(seq.size)
    budget = {"SAT": 0.30, "SINE": 0.45, "LINE": 0.25}
    unit = {"SAT": 171, "SINE": 300, "LINE": 4000}
    diverg = {"SAT": 0.02, "SINE": 0.10, "LINE": 0.15}
    planted = {}
    for fam, share in budget.items():
        target = int(frac * share * glen)
        consensus = rng.integers(0, 4, size=unit[fam], dtype=np.uint8)
        done = 0
        while done < target:
            if fam == "SAT":
                n_copies = int(rng.integers(20, 201))
                copy = np.tile(consensus, n_copies)
            elif fam == "LINE":
                # 5'-truncation: keep a random-length 3' suffix.
                keep = int(rng.integers(unit[fam] // 8, unit[fam] + 1))
                copy = consensus[-keep:].copy()
            else:
                copy = consensus.copy()
            # Per-copy divergence: substitutions at the family rate.
            n_sub = rng.binomial(copy.size, diverg[fam])
            if n_sub:
                at = rng.integers(0, copy.size, size=n_sub)
                copy = copy.copy()
                copy[at] = (copy[at] + rng.integers(1, 4, size=n_sub)) % 4
            pos = int(rng.integers(0, max(1, glen - copy.size)))
            end = min(glen, pos + copy.size)
            seq[pos:end] = copy[:end - pos]
            done += end - pos
        planted[fam] = done
    return planted


def _plant(seq: np.ndarray, pos: int, bases: str) -> None:
    seq[pos:pos + len(bases)] = seq_to_codes(bases)


def _mutate(rng: np.random.Generator, read: np.ndarray, n_err: int) -> None:
    for _ in range(n_err):
        i = int(rng.integers(0, read.size))
        read[i] = (read[i] + 1 + rng.integers(0, 3)) % 4


def simulate(seed: int = 0,
             chrom_lengths: dict[str, int] | None = None,
             n_circ: int = 12,
             n_linear: int = 8,
             reads_per_junction: int = 4,
             read_len: int = 100,
             n_contiguous: int = 30,
             n_random: int = 10,
             err_rate: float = 0.2,
             minus_fraction: float = 0.5,
             cfg: Config = Config()) -> SimData:
    """Build a genome with planted canonical junctions and supporting reads.

    Planted circular junctions follow SPEC.md §4 circular geometry
    (AG immediately before `start`, GT at `end`); linear junctions have GT
    at `start` and AG immediately before `end`. Reads crossing each
    junction are emitted on both strands with 0-2 sequencing errors.
    """
    rng = np.random.default_rng(seed)
    if chrom_lengths is None:
        chrom_lengths = {"chrS1": 120_000, "chrS2": 80_000}
    genome_tmp, seqs = random_genome(rng, chrom_lengths, cfg)
    del genome_tmp
    a = cfg.anchor_len
    truths: list[TrueJunction] = []
    reads: list[tuple[str, str]] = []
    names = list(chrom_lengths)

    def rand_chrom():
        return names[int(rng.integers(0, len(names)))]

    used: list[tuple[str, int, int]] = []

    def spaced(chrom: str, lo: int, hi: int, width: int) -> int:
        """Pick a start so [start, start+width) avoids previous features."""
        for _ in range(200):
            s = int(rng.integers(lo, hi))
            if all(c != chrom or s + width < u0 or s > u1
                   for c, u0, u1 in used):
                used.append((chrom, s, s + width))
                return s
        raise RuntimeError("could not place feature; enlarge genome")

    # Circular junctions: circle [start, end); AG before start, GT at end.
    for ci in range(n_circ):
        chrom = rand_chrom()
        seq = seqs[chrom]
        span = int(rng.integers(read_len, 3000))
        start = spaced(chrom, 500, len(seq) - span - 500, span)
        end = start + span
        _plant(seq, start - 2, "AG")
        _plant(seq, end, "GT")
        tj = TrueJunction("circular", chrom, start, end)
        for ri in range(reads_per_junction):
            bp = int(rng.integers(a, read_len - a + 1))
            read = np.concatenate([seq[end - bp:end],
                                   seq[start:start + (read_len - bp)]])
            n_err = int(rng.random() < err_rate)
            _mutate(rng, read, n_err)
            s = codes_to_seq(read)
            if rng.random() < minus_fraction:
                s = revcomp_seq(s)
            name = f"circ{ci}_r{ri}"
            reads.append((name, s))
            tj.reads.append(name)
        truths.append(tj)

    # Linear splice junctions: GT at start(donor), AG before end(acceptor).
    for li in range(n_linear):
        chrom = rand_chrom()
        seq = seqs[chrom]
        intron = int(rng.integers(200, 5000))
        donor = spaced(chrom, 500, len(seq) - intron - read_len - 500,
                       intron + read_len)
        acceptor = donor + intron
        _plant(seq, donor, "GT")
        _plant(seq, acceptor - 2, "AG")
        tj = TrueJunction("linear", chrom, donor, acceptor)
        for ri in range(reads_per_junction):
            bp = int(rng.integers(a, read_len - a + 1))
            read = np.concatenate([seq[donor - bp:donor],
                                   seq[acceptor:acceptor + (read_len - bp)]])
            n_err = int(rng.random() < err_rate)
            _mutate(rng, read, n_err)
            s = codes_to_seq(read)
            if rng.random() < minus_fraction:
                s = revcomp_seq(s)
            name = f"lin{li}_r{ri}"
            reads.append((name, s))
            tj.reads.append(name)
        truths.append(tj)

    # Contiguously-mapping reads (prefilter fodder) and unmappable noise.
    for i in range(n_contiguous):
        chrom = rand_chrom()
        seq = seqs[chrom]
        p = int(rng.integers(0, len(seq) - read_len))
        read = seq[p:p + read_len].copy()
        _mutate(rng, read, int(rng.random() < err_rate))
        reads.append((f"cont{i}", codes_to_seq(read)))
    for i in range(n_random):
        read = rng.integers(0, 4, size=read_len, dtype=np.uint8)
        reads.append((f"rand{i}", codes_to_seq(read)))

    # Rebuild the genome AFTER planting signals.
    genome = Genome.from_records([(n, seqs[n]) for n in names], cfg)
    return SimData(genome=genome, reads=reads, truths=truths)


def rnase_r_library(seed: int = 0,
                    chrom_lengths: dict[str, int] | None = None,
                    n_circ: int = 200,
                    n_linear: int = 30,
                    depth_mean: float = 12.0,
                    read_len: int = 100,
                    contiguous_frac: float = 0.10,
                    noise_frac: float = 0.02,
                    err_rate: float = 0.3,
                    repeat_frac: float = 0.25,
                    cfg: Config = Config()) -> SimData:
    """Simulate an RNase-R-treated circRNA-enrichment library
    (BASELINE configs[2]).

    RNase R degrades linear RNA, so the library is dominated by
    junction-crossing circRNA reads with highly skewed per-junction depth
    (geometric around `depth_mean`, min 1); residual linear splice reads,
    leftover contiguous fragments, and unmappable noise model incomplete
    digestion. The genome carries repeat families (plant_repeats) so
    anchor multi-mapping and the MAX_BUCKET guard are exercised the way a
    real genome would."""
    rng = np.random.default_rng(seed)
    if chrom_lengths is None:
        chrom_lengths = {"chrR": 4_000_000}
    seqs = {}
    for name, n in chrom_lengths.items():
        s = rng.integers(0, 4, size=n, dtype=np.uint8)
        if repeat_frac > 0:
            plant_repeats(rng, s, repeat_frac)
        seqs[name] = s
    a = cfg.anchor_len
    truths: list[TrueJunction] = []
    reads: list[tuple[str, str]] = []
    names = list(chrom_lengths)

    def junction_reads(tag, jid, seq, start, end, kind, depth):
        tj = TrueJunction(kind, tag, start, end)
        for ri in range(depth):
            bp = int(rng.integers(a, read_len - a + 1))
            if kind == "circular":
                read = np.concatenate(
                    [seq[end - bp:end], seq[start:start + (read_len - bp)]])
            else:
                read = np.concatenate(
                    [seq[start - bp:start], seq[end:end + (read_len - bp)]])
            _mutate(rng, read, int(rng.random() < err_rate))
            s = codes_to_seq(read)
            if rng.random() < 0.5:
                s = revcomp_seq(s)
            name = f"{kind[:4]}{jid}_r{ri}"
            reads.append((name, s))
            tj.reads.append(name)
        truths.append(tj)

    def other_base(b: int) -> int:
        return int((b + 1 + rng.integers(0, 3)) % 4)

    for ci in range(n_circ):
        chrom = names[int(rng.integers(0, len(names)))]
        seq = seqs[chrom]
        span = int(rng.integers(read_len, 20_000))
        start = int(rng.integers(500, len(seq) - span - 500))
        end = start + span
        _plant(seq, start - 2, "AG")
        _plant(seq, end, "GT")
        # Unambiguous by construction: a +-1 split shift scores equally
        # iff seq[start]==seq[end] / seq[end-1]==seq[start-1], a property
        # of the junction flanks (identical for every crossing read) that
        # would hold for ~44% of random junctions. The enrichment library
        # models spliced circles (exon boundaries), so break the tie;
        # residual ambiguity in the bench then comes only from repeats.
        if seq[start] == seq[end]:
            seq[start] = other_base(seq[end])
        if seq[end - 1] == seq[start - 1]:
            seq[end - 1] = other_base(seq[start - 1])
        depth = 1 + int(rng.geometric(1.0 / depth_mean))
        junction_reads(chrom, ci, seq, start, end, "circular", depth)
    for li in range(n_linear):
        chrom = names[int(rng.integers(0, len(names)))]
        seq = seqs[chrom]
        intron = int(rng.integers(200, 5000))
        donor = int(rng.integers(500, len(seq) - intron - read_len - 500))
        acceptor = donor + intron
        _plant(seq, donor, "GT")
        _plant(seq, acceptor - 2, "AG")
        if seq[acceptor] == seq[donor]:
            seq[acceptor] = other_base(seq[donor])
        if seq[donor - 1] == seq[acceptor - 1]:
            seq[donor - 1] = other_base(seq[acceptor - 1])
        depth = 1 + int(rng.geometric(2.0 / depth_mean))
        junction_reads(chrom, li, seq, donor, acceptor, "linear", depth)

    n_junction_reads = len(reads)
    n_cont = int(contiguous_frac * n_junction_reads
                 / max(1e-9, 1 - contiguous_frac - noise_frac))
    n_noise = int(noise_frac * n_junction_reads
                  / max(1e-9, 1 - contiguous_frac - noise_frac))
    for i in range(n_cont):
        chrom = names[int(rng.integers(0, len(names)))]
        seq = seqs[chrom]
        p = int(rng.integers(0, len(seq) - read_len))
        read = seq[p:p + read_len].copy()
        _mutate(rng, read, int(rng.random() < err_rate))
        reads.append((f"cont{i}", codes_to_seq(read)))
    for i in range(n_noise):
        read = rng.integers(0, 4, size=read_len, dtype=np.uint8)
        reads.append((f"rand{i}", codes_to_seq(read)))
    rng.shuffle(reads)

    genome = Genome.from_records([(n, seqs[n]) for n in names], cfg)
    return SimData(genome=genome, reads=reads, truths=truths)
