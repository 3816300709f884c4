"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` and the objects are linked into one
shared library with a plain C interface. The library lands in
``build/torch_kernels/<hash>/`` beside the package, keyed by a hash of
the sources and flags, so an unchanged tree reuses it and a changed
source rebuilds. Nothing here includes PyTorch's headers: a build takes
seconds, not minutes. The build and the load happen inside the first
call that launches a kernel, never at import, so the CPU tests can
import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
LIB_NAME = "libpfx_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
_F = ctypes.c_float
#: dropout arguments: on/off, keep threshold, keep scale, seed
_DROP = [_I, _U, _F, _ULL]
#: the C signatures of csrc/*.cu (every pointer and the stream as void*)
SIGNATURES = {
    "pfx_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _LL, _LL, _LL, _F, _I, _I, *_DROP, _P],
    # the decode kernels take q, k, v, then the int8 cache's K and V
    # scales (null for a cache of q's type)
    "pfx_flash_decode": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                         _I, _F, _I, _P],
    "pfx_flash_decode_verify": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _F, _I, _P],
    "pfx_flash_decode_paged": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _F, _I, _P],
    "pfx_flash_decode_paged_verify": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _I, _I, _F, _I, _P],
    "pfx_quantized_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "pfx_quantized_matmul_dx": [_P, _P, _P, _I, _I, _I, _I, _P],
    # ... is_bf16, then the route, its tile (rows, columns) and the
    # split route's cluster size
    "pfx_grouped_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL,
                           _LL, _I, _I, _I, _I, _I, _P],
    "pfx_grouped_matmul_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P],
    "pfx_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _LL, _LL, _LL, _F, _I, _I, *_DROP, _P],
    "pfx_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _LL, _LL, _LL, _F, _I, _I, *_DROP, _P],
}

_lib: Optional[ctypes.CDLL] = None
#: what the last build in this process did: seconds, library path and
#: the compiler's output (ptxas register / shared-memory report)
last_build: Dict[str, object] = {}


def _nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin``, ``PATH``, then the
    toolkit's default install prefix."""
    cands = []
    home = os.environ.get("CUDA_HOME")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for cand in cands:
        if os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "kernels are built from csrc/ at first use")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile ``csrc/*.cu`` into the shared library (unless one built
    from the same sources and flags exists) and return its path.

    Raises:
        RuntimeError: nvcc is missing or a compile or link failed; the
            message carries the compiler's output.
    """
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    hashed = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))) + sources
    out_dir = os.path.join(BUILD_DIR, _digest(hashed))
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib_path):
        last_build.update(seconds=0.0, path=lib_path, log="(cached)")
        return lib_path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR)
    try:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(os.path.basename(src))
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
                               *objs], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.makedirs(out_dir, exist_ok=True)
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    last_build.update(seconds=time.time() - t0, path=lib_path, log=log)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call of the
    process and loaded once, with every entry point's C signature set
    (each returns a ``cudaError_t`` as int)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
