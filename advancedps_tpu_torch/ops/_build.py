"""Build the CUDA kernels of this package at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, under ``advancedps_tpu_torch/_build/``: one ``nvcc`` a source, all
started together, then one link.  The library's file name
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_U64 = ctypes.c_uint64
_U32 = ctypes.c_uint32
#: C signatures of the entry points in csrc/resample.cu, csrc/threefry.cu and csrc/levy.cu.
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
    "aps_threefry_max_dims": (),
    "aps_threefry2x32": (_I64, _P, _P, _U32, _P, _U32, _P, _U32, _P, _U32, _I32, _P, _P),
    "aps_pos_uniform": (_I64, _P, _P, _U32, _P, _U32, _P, _I32, _U32, _I32, _P, _P),
    "aps_pos_normal": (_I64, _P, _P, _U32, _P, _U32, _P, _I32, _U32, _I32, _P, _P),
    "aps_pos_normals": (_I64, _P, _P, _U32, _P, _U32, _P, _I32, _I64, _U32, _P, _P),
    "aps_levy_max_jumps": (),
    "aps_levy_meancov": (_I64, _P, _I64, _I64, _P, _P, _P, _P, _P, _P, _I64, _I32, ctypes.c_float,
                         ctypes.c_float, _I32, _P, _P, _P),
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
    """Compile the sources unless the library for their hash exists: each
    source to an object by an ``nvcc`` of its own, all at once, then one link.
    The compilers' output (with ptxas register and spill counts) is kept
    beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = Path(work) / so.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        done = subprocess.run(link, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed ({done.returncode}): {' '.join(link)}\n"
                               f"{done.stdout}{done.stderr}")
        so.with_suffix(".log").write_text("".join(logs) + done.stdout + done.stderr)
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
