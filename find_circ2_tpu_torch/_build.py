"""Build and load the hand-written CUDA kernels of `csrc/`.

At first use, every `csrc/*.cu` is compiled with `nvcc` for Hopper
(`sm_90a`) into one shared library with a plain C interface under
`build/kernels/` at the repository root, keyed by a hash of the sources
and flags, and loaded with `ctypes`. A failed build raises: there is no
fallback for CUDA tensors.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        with open(s, "rb") as fh:
            h.update(os.path.basename(s).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libfc2t_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless the keyed library exists; return its
    path. Raises RuntimeError with nvcc's output on failure."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        # One GATHER_ARGS buffer in; the kernels launched, or minus a
        # CUDA error, out.
        lib.fc2t_gather_rows.argtypes = [ctypes.c_char_p]
        lib.fc2t_gather_rows.restype = ctypes.c_int
        _lib = lib
    return _lib


# csrc/gather_rows.cu's GatherArgs: table_a, out_a, table_b, out_b, idx,
# n, n_rows, stream, then width_a, width_b, idx_is_64, device.
GATHER_ARGS = struct.Struct("<5Q2qQ4i")


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
