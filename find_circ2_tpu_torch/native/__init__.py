"""ctypes binding for the native host data loader (fc2native.c).

Builds the shared library on first use with the system C compiler (no
network, no pip) into `build/native/libfc2t_native_<hash>.so` at the
repository root, keyed by a hash of the source and flags, never next to
the source; callers must handle `available() == False` and fall back to
the pure-Python path (io/fastq.py + io/twobit.py). The reference relied
on samtools/htslib C code for this role (SURVEY.md §2.2).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fc2native.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
_CFLAGS = ("-O3", "-shared", "-fPIC")
_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha1(" ".join(_CFLAGS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libfc2t_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    """Compile into a private temporary name and rename it into place,
    so that processes building at once never load a half-written file."""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
    except OSError:
        return False
    tmp = f"{path}.{os.getpid()}.tmp"
    for cc in ("cc", "gcc", "clang"):
        try:
            r = subprocess.run([cc, *_CFLAGS, _SRC, "-o", tmp],
                               capture_output=True, timeout=120)
            if r.returncode == 0:
                os.replace(tmp, path)
                return True
        except (OSError, subprocess.TimeoutExpired):
            continue
    return False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.fc2_parse_fastq.restype = ctypes.c_int64
    lib.fc2_parse_fastq.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p, i64p, i64p, i64p, i64p]
    lib.fc2_encode_reads.restype = None
    lib.fc2_encode_reads.argtypes = [
        ctypes.c_char_p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_ubyte)]
    lib.fc2_segsearch.restype = None
    lib.fc2_segsearch.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), i64p, i64p, i64p,
        ctypes.c_int64, i64p, i64p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_fastq(buf: bytes, max_records: int = 1 << 20):
    """Scan a FASTQ byte buffer natively.

    Returns (spans, resume_off) where spans is an int64 array [n, 6] of
    (name_start, name_end, seq_start, seq_end, qual_start, qual_end) and
    resume_off is the offset of the first unconsumed byte (start of a
    trailing partial record, for streaming refills).
    Raises ValueError on malformed input.
    """
    lib = _load()
    assert lib is not None, "native library unavailable"
    cols = [np.empty(max_records, np.int64) for _ in range(6)]
    resume = ctypes.c_int64()
    n = lib.fc2_parse_fastq(
        buf, len(buf), max_records,
        *(_ptr(c, ctypes.c_int64) for c in cols),
        ctypes.byref(resume))
    if n < 0:
        raise ValueError(f"malformed FASTQ near byte {-(n + 1)}")
    spans = np.stack([c[:n] for c in cols], axis=1)
    return spans, int(resume.value)


def segsearch(sv: np.ndarray, lo_b: np.ndarray, hi_b: np.ndarray,
              keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(left, right) insertion points of keys[i] in the sorted uint16
    segment sv[lo_b[i]:hi_b[i]) — the native twin of
    models/multihit._segmented_searchsorted's numpy formulation."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    assert sv.dtype == np.uint16 and sv.flags.c_contiguous
    lo_b = np.ascontiguousarray(lo_b, np.int64)
    hi_b = np.ascontiguousarray(hi_b, np.int64)
    keys = np.ascontiguousarray(keys, np.int64)
    n = keys.size
    out_lo = np.empty(n, np.int64)
    out_hi = np.empty(n, np.int64)
    lib.fc2_segsearch(
        _ptr(sv, ctypes.c_uint16), _ptr(lo_b, ctypes.c_int64),
        _ptr(hi_b, ctypes.c_int64), _ptr(keys, ctypes.c_int64), n,
        _ptr(out_lo, ctypes.c_int64), _ptr(out_hi, ctypes.c_int64))
    return out_lo, out_hi


def encode_reads(buf: bytes, seq_start: np.ndarray, seq_end: np.ndarray,
                 out: np.ndarray, lens: np.ndarray,
                 lut: np.ndarray) -> None:
    """Fill out[n, lp] (uint8, pre-filled with RPAD) and lens[n] (int32)
    from the byte spans. Over-long reads get lens = -true_length."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    n, lp = out.shape
    ss = np.ascontiguousarray(seq_start, np.int64)
    se = np.ascontiguousarray(seq_end, np.int64)
    assert lens.dtype == np.int32 and out.dtype == np.uint8
    assert out.flags.c_contiguous and lens.flags.c_contiguous
    lib.fc2_encode_reads(
        buf, _ptr(ss, ctypes.c_int64), _ptr(se, ctypes.c_int64),
        n, lp, _ptr(out, ctypes.c_ubyte), _ptr(lens, ctypes.c_int32),
        _ptr(np.ascontiguousarray(lut, np.uint8), ctypes.c_ubyte))
