"""Build the CUDA sources under ``csrc/`` with nvcc, at first use.

Each library is compiled for sm_90a into a shared library with a plain C
interface, for ctypes to load. The file lands in ``build/kernels/`` at the
root of the checkout, named by a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing here runs at
import: a machine without nvcc imports this module and fails only when a
kernel is first called.
"""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [
        Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c is not None and Path(c).is_file():
            return str(c)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path(name, sources):
    """Where the library built from ``sources`` (names under csrc/) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.encode())
        h.update((CSRC_DIR / s).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name, sources):
    """Compile ``sources`` into the library ``name`` unless it is built.

    Returns (path, log): log holds nvcc's output (ptxas register and shared
    memory use) when this call compiled, and is empty when the library was
    already there. Raises RuntimeError when nvcc fails."""
    out = library_path(name, sources)
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC_DIR / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out, proc.stdout + proc.stderr
