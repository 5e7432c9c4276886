"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``repro_torch/csrc/*.cu`` for ``sm_90a`` into an
object file (one compiler process per source, all started together), links
them into one shared library with a plain C interface under the repository's
``build/`` directory, and ``ctypes`` loads it.  The library's name carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded.  Nothing is built when this module is imported:
``load()`` builds at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v prints each kernel's registers, shared memory and spills
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
_LP = ctypes.POINTER(ctypes.c_int64)
SIGNATURES = {
    # ..., m, k, rows, L, g, then the plan (kernels/tlmm/plan.py): rows and
    # columns a block, groups a split, splits
    "tlmm_launch": [_P, _L, _P, _L, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _P],
    "tlmm_lut_launch": [_P, _L, _P, _L, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P],
    # (g, rows a block) -> dynamic shared memory bytes of a block
    "tlmm_dynamic_smem": [_I, _I],
    "tlmm_lut_dynamic_smem": [_I, _I],
    # ..., x_bf16, w_bf16, 16-byte loads
    "rmsnorm_quant_launch": [_P, _L, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    # ..., m, f, 16-byte loads
    "swiglu_quant_launch": [_P, _L, _P, _L, _P, _P, _P, _P, _I, _I, _I, _P],
    # an empty kernel: the launch floor
    "repro_empty_launch": [_P],
    # ..., window, kv_bf16, then warps a block (kernels/flash_prefill/plan.py)
    "flash_attn_launch": [_P, _LP, _P, _LP, _P, _LP, _P, _LP, _P, _LP, _P, _P,
                          _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # ..., window, kv_bf16 (kv_kind), q_bf16, then warps a block
    # (kernels/decode_attention/plan.py)
    "decode_attn_launch": [_P, _LP, _P, _LP, _P, _LP, _P, _P, _I, _I, _I, _I,
                           _I, _F, _I, _I, _I, _I, _P],
    "decode_attn_paged_launch": [_P, _LP, _P, _LP, _P, _LP, _P, _LP, _P, _LP,
                                 _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _F,
                                 _I, _I, _I, _I, _P],
    "flash_attn_paged_launch": [_P, _LP, _P, _LP, _P, _LP, _P, _L, _P, _LP,
                                _P, _LP, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _F, _I, _I, _I, _P],
}

_lib = None          # the loaded library: one per process
build_log = ""       # compiler output of the build this process ran
build_seconds = 0.0


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    return srcs, headers


def library_path() -> Path:
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists; the
    compiler output of a build is kept in ``build_log``."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs, _ = _sources()
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [exe, *CFLAGS, "-I", str(CSRC), "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [exe, *ARCH_FLAGS, "-shared", "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)   # atomic: no process loads a partial file
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and no later synchronise would report it)."""
    if err != 0:
        msg = load().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def strides(t) -> ctypes.Array:
    """A tensor's leading element strides as a C int64 array (the kernels
    take the last dim contiguous)."""
    st = t.stride()[:-1]
    return (ctypes.c_int64 * len(st))(*st)
