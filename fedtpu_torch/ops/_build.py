"""Build and load the port's CUDA kernels (``fedtpu_torch/csrc/*.cu``).

One ``nvcc`` process per source compiles them all at once, in parallel, for
``sm_90a`` (Hopper); one more links the objects into a shared library with a
plain C interface, which ``ctypes`` loads. The library goes
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
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" \
    / "fedtpu_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argtypes; every one returns a cudaError_t.
SIGNATURES = {
    "ft_weighted_average": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "ft_eval_confusion": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _P, _P),
    "ft_mlp_forward": (_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P),
    "ft_ring_all_reduce": (_P, _P, _I, _L, _P),
    "ft_fused_round": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P,
                       _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "ft_fused_round_resident": (_I, _P),
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
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    outputs = [proc.communicate()[0] for proc in procs]
    tmp = lib.with_suffix(f".{tag}")
    try:
        for proc, src, out in zip(procs, sources, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{src.name}:\n{' '.join(proc.args)}\n"
                                   f"{out}")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "compiler_output": "".join(outputs)}


_LOAD_LOCK = threading.Lock()


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's argtypes set. Threads
    that launch first at once build it one after the other (the build's
    temporary files are named by the process)."""
    with _LOAD_LOCK:
        lib = ctypes.CDLL(build()["path"])
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib
