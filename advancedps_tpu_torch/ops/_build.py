"""Build the CUDA kernels of this package at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, under ``advancedps_tpu_torch/_build/``.  The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt and a
stale library is never loaded.  A failed build raises with nvcc's output; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_U64 = ctypes.c_uint64
#: C signatures of the entry points in csrc/resample.cu.
_SIGNATURES = {
    "aps_prefix_tile_size": (),
    "aps_scan_scratch_words": (_I64,),
    "aps_extents_from_logw": (_P, _I64, _P, _P, ctypes.c_float, _I32, _P, _I64, _U64, _P, _P),
    "aps_scaled_prefix": (_P, _I64, _I32, _P, _P, _P, _I64, _U64, _P, _P),
    "aps_extents_from_logw_chains": (_P, _I64, _I64, _P, _P, _P, _I32, _P, _I64, _U64, _P, _P),
    "aps_scaled_prefix_chains": (_P, _I64, _I64, _I32, _P, _P, _P, _I64, _U64, _P, _P),
    "aps_decode_geometry": (_I32,),
    "aps_decode_ancestors": (_P, _I64, _I32, _I64, _I64, _P, _P),
    "aps_move_rows": (_P, _I64, _I64, _P, _I64, _P, _P, _P),
    "aps_decode_move": (_P, _I64, _I32, _I64, _I64, _P, _I64, _P, _P, _P),
    "aps_max_leaves": (),
    "aps_decode_move_leaves": (_P, _I64, _I32, _I64, _I64, _I32, _P, _P, _P, _P, _P),
    "aps_decode_move_chains": (_P, _I64, _I64, _I32, _I64, _I64, _P, _I64, _P, _P, _P),
    "aps_decode_move_leaves_chains": (_P, _I64, _I64, _I32, _I64, _I64, _I32, _P, _P, _P, _P,
                                      _P),
    "aps_decode_ancestors_dense": (_P, _I64, _I32, _I64, _P, _P, _I64, _U64, _P, _P),
    "aps_count_le_sorted_bs": (_P, _I64, _P, _I64, _P, _P),
    "aps_count_le_sorted": (_P, _I64, _P, _I64, _P, _P),
    "aps_count_le_geometry": (_I32,),
    "aps_decode_ancestors_chains": (_P, _I64, _I64, _I32, _I64, _I64, _P, _P),
    "aps_move_rows_chains": (_P, _I64, _I64, _I64, _P, _I64, _P, _P, _P),
    "aps_decode_ancestors_dense_chains": (_P, _I64, _I64, _I32, _I64, _P, _I64, _P, _I64, _U64,
                                          _P, _P),
    "aps_count_le_sorted_bs_chains": (_P, _I64, _I64, _I64, _P, _I64, _P, _P),
    "aps_count_le_sorted_chains": (_P, _I64, _I64, _I64, _P, _I64, _P, _P),
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
            "advancedps_tpu_torch cannot be built"
        )
    return str(candidate)


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libaps_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists.  The
    compiler's output (with ptxas register and spill counts) is kept beside
    the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's C signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.aps_error_string.argtypes = [ctypes.c_int]
    lib.aps_error_string.restype = ctypes.c_char_p
    return lib
