"""PyTorch and CUDA port of find_circ2_tpu's single-device path: the
detect program and the §2b multi-hit explore program.

The module paths mirror the reference package (`find_circ2_tpu/`), which
stays the reference the port is held against bit for bit. Host-only
modules of the reference (config, io, index builders, oracle, aggregate,
multihit, native loader) are imported from it, never copied; nothing
here imports jax. The one hand-written kernel is the row gather
(`ops/gather_rows.py`, `csrc/gather_rows.cu`) under every K1 and explore
table fetch, built at first use.
"""

__version__ = "0.1.0"
