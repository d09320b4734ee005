"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source seld_tpu_torch/csrc/<name>.cu becomes one shared library with
a plain C interface, build/kernels/<name>-<hash>.so at the repository
root, where <hash> covers the source, the headers beside it and the
compiler flags. A library is built at first use (or ahead of it by
`build`) and loaded with ctypes; pointers and the stream cross as
c_void_p. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): building the CUDA kernels needs the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> dict | None:
    """Compile csrc/<name>.cu into its library unless it is built already.

    Returns {"seconds": wall time, "log": nvcc's output} when this call
    compiled it, None when the library was there; raises RuntimeError
    with nvcc's output when the compile fails."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{res.stdout}")
    os.replace(tmp, target)  # atomic: concurrent builds of a source agree
    return {"seconds": time.perf_counter() - t0, "log": res.stdout}


_BUILD_LOCK = threading.Lock()  # threads of one process share build()'s temporary name


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library for csrc/<name>.cu, built if needed."""
    with _BUILD_LOCK:
        build(name)
    return ctypes.CDLL(str(library_path(name)))
