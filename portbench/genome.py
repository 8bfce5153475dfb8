"""A configuration's genome, fixed by the genome seed in its file.

One random sequence per chromosome, with repeat families planted over
`repeat_frac` of it (a frozen copy of the port's
`utils/simulate.plant_repeats`, which also marks the bases it wrote), and
then the configuration's circular and linear junction loci with their
GT/AG signals planted as `utils/simulate.rnase_r_library` plants them.
`--seed` never reaches this module: every run of a configuration maps its
library to the same genome and loci. numpy only.

The result is the concatenated, sentinel-padded layout of the port's
`io/genome.Genome` (`CHROM_GAP` codes of `GAP_CODE` around every
chromosome), as plain arrays that the program and the reference each wrap
in their own Genome type.
"""

from __future__ import annotations

import numpy as np

CHROM_GAP = 512          # Config.chrom_gap
GAP_CODE = 5             # config.GAP_CODE
_AG = np.array([0, 2], np.uint8)
_GT = np.array([2, 3], np.uint8)


def plant_repeats(rng: np.random.Generator, seq: np.ndarray, frac: float,
                  mask: np.ndarray) -> dict:
    """Overwrite about `frac` of `seq` with copies of three repeat
    families (a satellite of 171 bp in tandem arrays of 20-200 copies at
    2% divergence, a 300 bp SINE at 10%, a 5'-truncated 4 kb LINE at 15%;
    30/45/25% of the budget), in place, and set `mask` over every base
    written. Returns the bases planted per family."""
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
                copy = np.tile(consensus, int(rng.integers(20, 201)))
            elif fam == "LINE":
                keep = int(rng.integers(unit[fam] // 8, unit[fam] + 1))
                copy = consensus[-keep:].copy()
            else:
                copy = consensus.copy()
            n_sub = rng.binomial(copy.size, diverg[fam])
            if n_sub:
                at = rng.integers(0, copy.size, size=n_sub)
                copy = copy.copy()
                copy[at] = (copy[at] + rng.integers(1, 4, size=n_sub)) % 4
            pos = int(rng.integers(0, max(1, glen - copy.size)))
            end = min(glen, pos + copy.size)
            seq[pos:end] = copy[:end - pos]
            mask[pos:end] = True
            done += end - pos
        planted[fam] = done
    return planted


def _other(rng: np.random.Generator, b: int) -> int:
    return int((b + 1 + rng.integers(0, 3)) % 4)


def _plant_loci(rng, seqs: list, loci: dict, read_len: int) -> dict:
    """Circular loci (AG before `start`, GT at `end`) and linear ones (GT
    at the donor, AG before the acceptor), with the +-1 split ties of
    their flanks broken, as rnase_r_library plants them. Returns int64
    arrays chrom, j1, j2 per kind: (start, end) of a circle, (donor,
    acceptor) of an intron, chromosome-local."""
    out = {}
    for kind in ("circular", "linear"):
        n = int(loci.get(f"n_{kind}", 0))
        chrom = np.zeros(n, np.int64)
        j1 = np.zeros(n, np.int64)
        j2 = np.zeros(n, np.int64)
        for i in range(n):
            c = int(rng.integers(0, len(seqs)))
            seq = seqs[c]
            if kind == "circular":
                lo, hi = loci["circ_span"]
                span = int(rng.integers(lo, hi))
                start = int(rng.integers(500, seq.size - span - 500))
                end = start + span
                seq[start - 2:start] = _AG
                seq[end:end + 2] = _GT
                if seq[start] == seq[end]:
                    seq[start] = _other(rng, int(seq[end]))
                if seq[end - 1] == seq[start - 1]:
                    seq[end - 1] = _other(rng, int(seq[start - 1]))
                a, b = start, end
            else:
                lo, hi = loci["intron"]
                intron = int(rng.integers(lo, hi))
                donor = int(rng.integers(
                    500, seq.size - intron - read_len - 500))
                acceptor = donor + intron
                seq[donor:donor + 2] = _GT
                seq[acceptor - 2:acceptor] = _AG
                if seq[acceptor] == seq[donor]:
                    seq[acceptor] = _other(rng, int(seq[donor]))
                if seq[donor - 1] == seq[acceptor - 1]:
                    seq[donor - 1] = _other(rng, int(seq[acceptor - 1]))
                a, b = donor, acceptor
            chrom[i], j1[i], j2[i] = c, a, b
        out[kind] = dict(chrom=chrom, j1=j1, j2=j2)
    return out


def _clean_flanks(mask: list, lk: dict, flank: int) -> np.ndarray:
    """Per locus: no base of [j - flank, j + flank) is a planted repeat
    base, at both of its junction coordinates."""
    clean = np.ones(lk["chrom"].size, bool)
    for c, m in enumerate(mask):
        cum = np.concatenate([[0], np.cumsum(m, dtype=np.int64)])
        on = lk["chrom"] == c
        for j in (lk["j1"][on], lk["j2"][on]):
            lo = np.clip(j - flank, 0, m.size)
            hi = np.clip(j + flank, 0, m.size)
            clean[np.flatnonzero(on)] &= (cum[hi] - cum[lo]) == 0
    return clean


def make_genome(conf: dict) -> dict:
    """The configuration's genome: `codes` (uint8, padded layout),
    `chrom_names`, `chrom_offsets`, `chrom_lengths` (int64), and per
    junction kind its loci (`chrom` index, `j1`, `j2` chromosome-local,
    `clean`: flanks of `loci.flank` bases outside the repeats), and
    `repeat_mask`, per chromosome the bases the repeats wrote (not
    cached)."""
    g = conf["genome"]
    rng = np.random.default_rng(int(g["seed"]))
    names = [str(n) for n, _ in g["chromosomes"]]
    lengths = [int(n) for _, n in g["chromosomes"]]
    if sum(lengths) != int(conf["genome_bp"]):
        raise ValueError(f"{conf['name']}: chromosomes sum to "
                         f"{sum(lengths)}, genome_bp says "
                         f"{conf['genome_bp']}")
    seqs, masks = [], []
    for n in lengths:
        s = rng.integers(0, 4, size=n, dtype=np.uint8)
        m = np.zeros(n, bool)
        if g["repeat_frac"] > 0:
            plant_repeats(rng, s, float(g["repeat_frac"]), m)
        seqs.append(s)
        masks.append(m)
    loci = conf.get("loci", {})
    kinds = _plant_loci(rng, seqs, loci, int(loci.get("read_len", 100)))
    for lk in kinds.values():
        lk["clean"] = _clean_flanks(masks, lk, int(loci.get("flank", 100)))
    gap = np.full(CHROM_GAP, GAP_CODE, np.uint8)
    parts, offsets, pos = [], [], 0
    for s in seqs:
        parts += [gap, s]
        offsets.append(pos + CHROM_GAP)
        pos += CHROM_GAP + s.size
    parts.append(gap)
    return dict(codes=np.concatenate(parts), chrom_names=names,
                chrom_offsets=np.asarray(offsets, np.int64),
                chrom_lengths=np.asarray(lengths, np.int64),
                loci=kinds, repeat_mask=masks)
