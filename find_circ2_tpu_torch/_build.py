"""Build and load the hand-written CUDA kernels of `csrc/`.

At first use, every `csrc/*.cu` is compiled with `nvcc` for Hopper
(`sm_90a`), one `nvcc` per source, all started together, and linked into
one shared library with a plain C interface under `build/kernels/` at the
repository root, keyed by a hash of the flags and of every source and
header of `csrc/` (an edited `*.cuh` builds a new library), and loaded
with `ctypes`. A failed build raises: there is no fallback for CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import struct
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# The measurement build: csrc/explore.cu, csrc/classic_k1.cu,
# csrc/detect.cu, csrc/exact_stats.cu and csrc/merge.cu record per-stage
# clocks.
STAMP_FLAGS = ("-DFC2T_EXPLORE_STAMPS", "-DFC2T_CLASSIC_STAMPS",
               "-DFC2T_DETECT_STAMPS", "-DFC2T_MERGE_STAMPS")

_lib = None
_stamped = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _hashed() -> list[str]:
    """What the library is built from: the sources and their headers."""
    return sorted(_sources() + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path(flags: tuple = NVCC_FLAGS) -> str:
    h = hashlib.sha1(" ".join(flags).encode())
    for s in _hashed():
        with open(s, "rb") as fh:
            h.update(os.path.basename(s).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libfc2t_{h.hexdigest()[:16]}.so")


def build(flags: tuple = NVCC_FLAGS) -> str:
    """Compile csrc/*.cu with `flags` unless the keyed library exists;
    return its path. Raises RuntimeError with nvcc's output on failure."""
    so = library_path(flags)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tmp = _nvcc(), f"{so}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in _sources()]
    try:
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(_sources(), objs)]
        texts = [p.communicate()[0] for p in procs]  # waits for all
        for s, p, text in zip(_sources(), procs, texts):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on "
                                   f"{os.path.basename(s)}:\n{text}")
        r = subprocess.run([nvcc, *flags, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument and result types."""
    # One GATHER_ARGS buffer in; the kernels launched, or minus a CUDA
    # error, out.
    lib.fc2t_gather_rows.argtypes = [ctypes.c_char_p]
    lib.fc2t_gather_rows.restype = ctypes.c_int
    # One EXPLORE_ARGS buffer in; the kernels launched, or minus a CUDA
    # error, out.
    lib.fc2t_explore.argtypes = [ctypes.c_char_p]
    lib.fc2t_explore.restype = ctypes.c_int
    # Lp, K, V, n_chroms and an int[5] out; 0 or minus a CUDA error.
    lib.fc2t_explore_resources.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.fc2t_explore_resources.restype = ctypes.c_int
    # One DETECT_ARGS / EXACT_ARGS buffer in; the kernels launched, or
    # minus a CUDA error, out.
    lib.fc2t_detect.argtypes = [ctypes.c_char_p]
    lib.fc2t_detect.restype = ctypes.c_int
    lib.fc2t_exact_stats.argtypes = [ctypes.c_char_p]
    lib.fc2t_exact_stats.restype = ctypes.c_int
    # One CLASSIC_ARGS / COMPACT_ARGS buffer in; the kernels launched, or
    # minus a CUDA error, out.
    lib.fc2t_classic_k1.argtypes = [ctypes.c_char_p]
    lib.fc2t_classic_k1.restype = ctypes.c_int
    lib.fc2t_compact.argtypes = [ctypes.c_char_p]
    lib.fc2t_compact.restype = ctypes.c_int
    # One MERGE_ARGS buffer in; the kernels launched, or minus a CUDA
    # error, out.
    lib.fc2t_merge.argtypes = [ctypes.c_char_p]
    lib.fc2t_merge.restype = ctypes.c_int
    # Rows in; the scratch bytes fc2t_merge wants for them out.
    lib.fc2t_merge_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.fc2t_merge_scratch_bytes.restype = ctypes.c_longlong
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(build()))
    return _lib


def load_stamped() -> ctypes.CDLL:
    """The measurement build of the kernel library (STAMP_FLAGS), built on
    first call; it also has fc2t_explore_stamps(void*),
    fc2t_classic_stamps(void*), fc2t_detect_stamps(void*),
    fc2t_exact_stamps(void*) and fc2t_merge_stamps(void*)."""
    global _stamped
    if _stamped is None:
        lib = _bind(ctypes.CDLL(build(NVCC_FLAGS + STAMP_FLAGS)))
        for name in STAMP_ENTRIES:
            getattr(lib, name).argtypes = [ctypes.c_void_p]
            getattr(lib, name).restype = ctypes.c_int
        _stamped = lib
    return _stamped


# The measurement build's entries that point a kernel's stage clocks at a
# buffer (null: nowhere); each returns 0 or minus a CUDA error.
STAMP_ENTRIES = ("fc2t_explore_stamps", "fc2t_classic_stamps",
                 "fc2t_detect_stamps", "fc2t_exact_stamps",
                 "fc2t_merge_stamps")


def stamped(entry: str, rows: int, stages: int, like, launch):
    """launch(lib) through the measurement build (load_stamped), with the
    stage clocks of the kernel behind `entry` (one of STAMP_ENTRIES)
    recorded into a zeroed int64 [rows, stages + 1] buffer on `like`'s
    device, which is current: (launch's result, the cycles of each stage,
    int64 [rows, stages])."""
    import torch
    lib = load_stamped()
    point = getattr(lib, entry)
    stamps = torch.zeros((rows, stages + 1), dtype=torch.int64,
                         device=like.device)
    with torch.cuda.device(like.get_device()):
        check(-point(stamps.data_ptr()), entry)
        try:
            got = launch(lib)
            torch.cuda.synchronize()
        finally:
            check(-point(None), entry)
    return got, stamps.diff(dim=1)


# csrc/gather_rows.cu's GatherArgs: table_a, out_a, table_b, out_b, idx,
# n, n_rows, stream, then width_a, width_b, idx_is_64, device.
GATHER_ARGS = struct.Struct("<5Q2qQ4i")

# csrc/explore.cu's ExploreArgs: words, chrom_offsets, reads, lens, mm_v,
# out, then per anchor (A, B) count, first_pos, extras, pos, strand,
# aligned, mm, n_best, qual; stream, nbases; then B, Lp, V, K, n_chroms,
# anchor_len, prefilter_mm, pair_rescue, prefilter, device.
EXPLORE_ARGS = struct.Struct("<25Qq10i")

# csrc/detect.cu's DetectArgs: words, chrom_offsets, reads, lens, out,
# overflow, then per anchor (A, B) pos, strand, aligned, n_best, qual;
# stream, nbases; then B, Lp, n_chroms, anchor_len, prefilter_mm,
# prefilter, device, reserved.
DETECT_ARGS = struct.Struct("<17Qq8i")

# csrc/exact_stats.cu's ExactArgs: anchors, table, ntable, meta, then the
# outputs aligned, pos, strand, mm, n_best, second_mm, qual, resolved,
# partials; stream, rows; lo, hi (the canonical p12 range looked up);
# then n, anchor_len, prefix_len, max_bucket, max_anchor_mm, device;
# n_others, reserved, others (the other shards' records).
EXACT_ARGS = struct.Struct("<14Qq2q6i2iQ")

# csrc/classic_k1.cu's ClassicArgs: anchors, table, meta, ext_id, ext,
# slots, then the outputs aligned, pos, strand, mm, n_best, second_mm,
# qual, count, first_pos, extras; stream; rows, ext_rows; then n,
# anchor_len, prefix_len, max_bucket, max_anchor_mm, ext_width, device,
# reserved; lo, hi (the canonical p12 range looked up); then partials,
# others (the other shards' records); n_others, reserved.
CLASSIC_ARGS = struct.Struct("<17Q2q8i2q2Q2i")

# csrc/classic_k1.cu's CompactArgs: resolved, slots, overflow, stream; n,
# k; device, reserved.
COMPACT_ARGS = struct.Struct("<4Q2q2i")

# csrc/merge.cu's MergeArgs: valid, kind, chrom, start, end, sense, the
# three sum, two maximum and three minimum fields, status, lens, multi,
# align_strand; the outputs in the same order as the table's fields; the
# scratch buffer; stream; n, the scratch's bytes; then st_junction,
# min_uniq_qual, device, reserved.
MERGE_ARGS = struct.Struct("<34Q2q4i")


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
