"""Frozen pipeline configuration.

Every behavioral constant of the engine lives here so the CPU oracle, the
single-chip JAX path, and the sharded path share one source of truth.
See SPEC.md §0 for the meaning of each field and SURVEY.md §2-§3 for the
reconstructed reference behavior they implement (the upstream reference
mount is empty; SURVEY.md §0).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # SPEC.md §0
    anchor_len: int = 20          # `a`: terminal anchor length (SURVEY §3.2)
    prefix_len: int = 12          # direct-addressed index prefix (SPEC §1)
    max_anchor_mm: int = 1        # A_MM: enumeration ball radius (SPEC §2)
    max_bucket: int = 64          # repetitive-20-mer guard (SPEC §2)
    max_pair_hits: int = 16       # multi-hit pairing cap K (SPEC §2b).
    # 8 -> 16 in v4: the r4 relocation study (scripts/trace_misses.py,
    # /tmp pool check recorded in docs/DESIGN.md "Repeat relocation
    # ceiling") found ~20% of repeat-region misses had the true locus at
    # candidate rank 8-31; K=16 buys half of that band (configs[2]
    # recall 0.891 -> 0.906) at 4x explore-grid cost on the ~15-20%
    # routed reads. K=32 adds +1.3pp more at 4x again — available via
    # Config for recall-critical runs.
    max_read_len: int = 160       # L_max: device padding length
    chrom_gap: int = 512          # sentinel padding around chromosomes
    min_uniq_qual: int = 10       # unique-anchor qual threshold
    prefilter_mm: int = 2         # pass-1 contiguous filter threshold
    max_span: int = 100_000       # default --filter / maxlength guard
    min_support: int = 2          # --filter: min supporting reads (SPEC §5)
    filter_max_edits: int = 2     # --filter: max edit distance (SPEC §5)
    # Host/device batching.
    batch_size: int = 4096        # reads per device batch
    # K1 v4 exact-first fast path (ops/anchor_align.py
    # exact_anchor_stats): static size of the in-program enumeration
    # fallback slice for absent-key anchors (sequencing errors). Purely
    # a performance knob — results are bit-identical at any value; if a
    # batch has more unresolved anchors than slots, the whole batch
    # transparently redoes on the classic enumeration program.
    exact_fallback_slots: int = 1024
    # Library strandedness: None => unstranded => strandmatch "NA".
    stranded: bool = False
    # SPEC §2 2-mm anchor rescue [FROZEN v4]: an anchor with NO hit in
    # the <=1-mm enumeration ball, whose mate anchor DID align at
    # <=1 mm, is re-searched at Hamming distance exactly 2 (host slow
    # path only — the device flags the read ST_UNALIGNED_* and routing
    # re-calls it; the K1 ball stays max_anchor_mm). Closes most of the
    # sensitivity gap vs bowtie2's 2-mismatch anchor alignments for
    # reads with two sequencing errors in one anchor. 1 disables.
    rescue_anchor_mm: int = 2
    # SPEC §2b pair-margin bridge rescue [FROZEN v4]: a multi-hit read
    # whose winning pair beats every explored pair at a DIFFERENT
    # junction by `margin` edits reports quals >= min(40, 10*margin) —
    # the full-read placement margin is a strictly stronger uniqueness
    # signal than the 20-mer anchor MAPQ surrogate, and it is what lets
    # repeat-region junctions (every anchor multi-mapping) still collect
    # ANCHOR_UNIQUE bridges. False restores v3 (anchor-only) quals.
    pair_rescue: bool = True

    def __post_init__(self) -> None:
        if not 1 <= self.anchor_len - self.prefix_len <= 8:
            raise ValueError("anchor_len - prefix_len must be in [1, 8] "
                             "(suffix must fit 16 bits, SPEC.md §1)")
        if self.max_anchor_mm > 1:
            raise ValueError("enumeration supports max_anchor_mm <= 1")
        if self.rescue_anchor_mm not in (1, 2):
            raise ValueError("rescue_anchor_mm must be 1 (off) or 2")
        if self.max_read_len < 2 * self.anchor_len:
            raise ValueError("max_read_len must be >= 2*anchor_len")
        if self.chrom_gap < self.max_read_len + 2:
            raise ValueError("chrom_gap must exceed max_read_len+2")


DEFAULT = Config()

# Base codes (SPEC.md §0). Codes >= N never match anything, including
# themselves, and invalidate k-mers.
A, C, G, T, N = 0, 1, 2, 3, 4
GAP_CODE = 5      # genome sentinel padding
RPAD_CODE = 6     # read padding on device

# Skip-reason / status codes shared by oracle, device path and stats.
ST_JUNCTION = 0           # read supports a junction (linear or circular)
ST_TOO_SHORT = 1          # len < 2*anchor_len
ST_TOO_LONG = 2           # len > max_read_len
ST_PREFILTERED = 3        # contiguous alignment found (pass-1 filter)
ST_UNALIGNED_A = 4        # 5' anchor has no hit with mm <= A_MM
ST_UNALIGNED_B = 5        # 3' anchor has no hit with mm <= A_MM
ST_DIFF_STRAND = 6        # best hits on different strands
ST_DIFF_CHROM = 7         # best hits on different chromosomes
ST_ANCHOR_OVERLAP = 8     # anchors overlap on the genome: neither geometry
ST_NO_JUNCTION = 9        # linear candidate with end <= start
N_STATUS = 10

STATUS_NAMES = {
    ST_JUNCTION: "junction_reads",
    ST_TOO_SHORT: "too_short",
    ST_TOO_LONG: "too_long",
    ST_PREFILTERED: "prefiltered_contiguous",
    ST_UNALIGNED_A: "anchor_A_unaligned",
    ST_UNALIGNED_B: "anchor_B_unaligned",
    ST_DIFF_STRAND: "different_strand",
    ST_DIFF_CHROM: "different_chrom",
    ST_ANCHOR_OVERLAP: "anchors_overlap",
    ST_NO_JUNCTION: "no_junction",
}

# Junction kinds.
KIND_LINEAR = 0
KIND_CIRCULAR = 1

# Senses.
SENSE_PLUS = 0
SENSE_MINUS = 1
SENSE_CHARS = {SENSE_PLUS: "+", SENSE_MINUS: "-"}

# Category flag order (SPEC.md §5). The `category` column joins the
# applicable subset with commas, in this order.
FLAG_ORDER = (
    "CIRCULAR",
    "LINEAR",
    "UNAMBIGUOUS_BP",
    "ANCHOR_UNIQUE",
    "NO_UNIQ_BRIDGES",
    "CANONICAL",
    "STRANDMATCH",
)

BED_COLUMNS = (
    "chrom", "start", "end", "name", "n_reads", "strand", "n_uniq",
    "uniq_bridges", "best_qual_left", "best_qual_right", "tissues",
    "tiss_counts", "edits", "anchor_overlap", "breakpoints", "signal",
    "strandmatch", "category",
)
