"""PyTorch and CUDA port of find_circ2_tpu's single-device path: the
detect program and the §2b multi-hit explore program.

The module paths mirror the reference package (`find_circ2_tpu/`), which
stays the reference the port is held against bit for bit. The port
stands alone: it imports nothing of the reference package and nothing
of jax. Its host modules (config, io, index builders, oracle, aggregate,
multihit, native loader, utils, the auxiliary CLIs) are its own copies
of the reference's, equal to them apart from imports. On the card the
device programs are hand-written CUDA kernels (`csrc/`, built at first
use into `build/kernels/`): on one table, K1's exact-first probe,
enumeration and fallback slice fetch their own table rows
(`ops/anchor_align.py`), detect's core and the §2b pair program follow
(`ops/detect.py`, `ops/explore.py`); the row gather (`ops/gather_rows.py`)
serves the sharded engine's per-shard K1. The native FASTQ loader builds
into `build/native/`.
"""

__version__ = "0.1.0"
