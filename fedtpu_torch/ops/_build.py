"""Build and load the port's CUDA kernels (``fedtpu_torch/csrc/*.cu``).

One ``nvcc`` call compiles every source into a shared library with a plain C
interface, for ``sm_90a`` (Hopper), which ``ctypes`` loads. The library goes
into ``build/fedtpu_torch_kernels/`` beside the package, named by a hash of
the sources, the flags and the compiler, so an edited source is rebuilt and
an unchanged one is built once. Nothing here runs at import: the first
kernel launch builds. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" \
    / "fedtpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes; every one returns its launch's cudaError_t.
SIGNATURES = {
    "ft_weighted_average": (_P, _P, _I, _I, _P, _P),
    "ft_eval_confusion": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P),
    "ft_mlp_forward": (_P, _I, _P, _I, _P, _I, _I, _P, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "fedtpu_torch kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(force: bool = False) -> dict:
    """Compile the library unless it is already built. Returns
    ``{"path", "seconds", "compiler_output"}`` (``seconds`` is 0 and the
    output empty when the library was already there)."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    nvcc = _nvcc()
    h = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for f in sources + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    lib = BUILD_DIR / f"libfedtpu_torch_kernels-{h.hexdigest()[:16]}.so"
    if lib.exists() and not force:
        return {"path": str(lib), "seconds": 0.0, "compiler_output": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return {"path": str(lib), "seconds": seconds,
            "compiler_output": proc.stdout + proc.stderr}


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's argtypes set."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
