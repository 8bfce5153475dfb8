"""PyTorch and CUDA port of find_circ2_tpu's single-device path: the
detect program and the §2b multi-hit explore program.

The module paths mirror the reference package (`find_circ2_tpu/`), which
stays the reference the port is held against bit for bit. The port
stands alone: it imports nothing of the reference package and nothing
of jax. Its host modules (config, io, index builders, oracle, aggregate,
multihit, native loader, utils, the auxiliary CLIs) are its own copies
of the reference's, equal to them apart from imports. The one
hand-written kernel is the row gather (`ops/gather_rows.py`,
`csrc/gather_rows.cu`) under every K1 and explore table fetch, built at
first use into `build/kernels/`; the native FASTQ loader builds into
`build/native/`.
"""

__version__ = "0.1.0"
