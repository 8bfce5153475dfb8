"""Each kernel's registers and a digest of its SASS, for one CUDA source of
find_circ2_tpu_torch compiled as the package builds it (_build.NVCC_FLAGS)
from each of one or more checkouts. Two kernels with the same digest
compile to the same instructions on the same constant-bank offsets, so
they run alike; the mangled names may differ (a template parameter
added).

    python3 scripts/sass_digest.py find_circ2_tpu_torch/csrc/exact_stats.cu \
        ROOT [ROOT ...]

Needs nvcc and cuobjdump (the CUDA toolkit, no card). Builds under
build/sass/ of this checkout and prints one JSON line a kernel and
checkout: root, kernel (demangled), registers, instructions, sha1.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from find_circ2_tpu_torch import _build  # noqa: E402

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One SASS instruction: /*addr*/ text ; (the encoding comments dropped).
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit(f"{name} not found: this needs the CUDA toolkit")


def _demangle(names: list[str]) -> list[str]:
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt:
        return names
    out = subprocess.run([filt], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def digest(source: str, root: str, out_dir: str, tag: int = 0
           ) -> list[dict]:
    """The kernels of `source` (a path inside a checkout) under `root`,
    built into `out_dir` as the `tag`-th cubin."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler",
                                                       "-fPIC")]
    cubin = os.path.join(out_dir, f"{tag}.cubin")
    src = os.path.join(root, source)
    subprocess.run([_tool("nvcc"), *flags, "-I", os.path.dirname(src),
                    "-cubin", "-o", cubin, src], check=True)
    cuobjdump = _tool("cuobjdump")
    regs = {}
    for line in subprocess.run([cuobjdump, "-res-usage", cubin], text=True,
                               capture_output=True, check=True
                               ).stdout.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m:
            regs[name] = int(m.group(1))
    sass = subprocess.run([cuobjdump, "-sass", cubin], text=True,
                          capture_output=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    names, bodies = parts[1::2], parts[2::2]
    rows = []
    for name, pretty, body in zip(names, _demangle(names), bodies):
        insns = INSN.findall(body)
        rows.append({"root": root, "kernel": pretty,
                     "registers": regs.get(name),
                     "instructions": len(insns),
                     "sha1": hashlib.sha1("\n".join(insns).encode()
                                          ).hexdigest()})
    return rows


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    source, roots = argv[0], argv[1:]
    out_dir = os.path.join(HERE, "build", "sass")
    os.makedirs(out_dir, exist_ok=True)
    for tag, root in enumerate(roots):
        for row in digest(source, root, out_dir, tag):
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
