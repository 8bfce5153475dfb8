"""Base-code conversion, reverse complement, and 2-bit genome packing.

Replaces the reference's reliance on pysam/faidx text genome access
(SURVEY.md §2.2): sequences become small-integer code arrays (A=0 C=1 G=2
T=3 N=4, SPEC.md §0) that feed numpy (oracle) and JAX (device) identically,
plus an optional 2-bit packed form for HBM-resident whole genomes.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.config import N

# ASCII -> code lookup. Unknown characters behave like N.
_CODE_LUT = np.full(256, N, dtype=np.uint8)
for i, b in enumerate("ACGT"):
    _CODE_LUT[ord(b)] = i
    _CODE_LUT[ord(b.lower())] = i

_BASE_LUT = np.frombuffer(b"ACGTN?#!", dtype=np.uint8)  # code -> ASCII

# code -> reverse-complement code: 3-c for ACGT, identity for others.
REVCOMP_LUT = np.array([3, 2, 1, 0, 4, 5, 6], dtype=np.uint8)


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    """Encode an ASCII sequence into a uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    """Decode a uint8 code array back to an ASCII string."""
    return _BASE_LUT[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (N and sentinels map to self)."""
    return REVCOMP_LUT[codes[::-1]]


def revcomp_seq(seq: str) -> str:
    return codes_to_seq(revcomp_codes(seq_to_codes(seq)))


def pack_2bit(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack codes into 2 bits/base plus an N/sentinel mask bitmap.

    Returns (packed, nmask): `packed[i]` holds bases 4i..4i+3 (base 4i in
    the low bits); `nmask` is a 1-bit-per-base bitmap of codes >= 4. Bases
    with the mask bit set must be treated as mismatching everything when
    unpacked.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.size
    pad = (-n) % 4
    c = np.concatenate([codes, np.zeros(pad, np.uint8)])
    invalid = c >= 4
    two = np.where(invalid, 0, c).reshape(-1, 4).astype(np.uint8)
    packed = (two[:, 0] | (two[:, 1] << 2) | (two[:, 2] << 4)
              | (two[:, 3] << 6))
    pad8 = (-n) % 8
    inv8 = np.concatenate([invalid[:n], np.zeros(pad8, bool)]).reshape(-1, 8)
    nmask = np.packbits(inv8, axis=1, bitorder="little").reshape(-1)
    return packed.astype(np.uint8), nmask


def unpack_2bit(packed: np.ndarray, nmask: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit; invalid bases come back as N."""
    packed = np.asarray(packed, dtype=np.uint8)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    codes = ((packed[:, None] >> shifts) & 3).reshape(-1)[:n].astype(np.uint8)
    inv = np.unpackbits(np.asarray(nmask, np.uint8), bitorder="little")[:n]
    codes[inv.astype(bool)] = N
    return codes
