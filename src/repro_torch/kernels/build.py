"""Build and bind the port's CUDA kernels.

Each source under ``csrc/`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/`` at the repository root at first
use (the library's file name carries a hash of the source and flags, so
an edited source rebuilds) and loaded with ``ctypes``.  Nothing is built
when a module is imported: only the first launch on a CUDA tensor builds.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# mttkrp_slab_launch(device, batch, chunk_slab, rb_chunk_ptr, num_chunks,
#   num_row_blocks, chunk_slabs, idx, vals, lrows, factor_ptrs,
#   factor_lane_strides, num_inputs, factors_bf16, rank, slots, tile,
#   block_rows, rank_block, r_pad, walkers, partials, out, stream)
_MTTKRP_SLAB_ARGTYPES = [_I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                         _I, _I, _LL, _I, _I, _I, _I, _I, _P, _P, _P]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def compile_source(source: Path) -> Path:
    """Compile ``source`` into its shared library unless it exists; the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside it as ``.log``."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True, check=False)
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The MTTKRP slab kernel's library, built on first call."""
    lib = ctypes.CDLL(str(compile_source(CSRC / "mttkrp_slab.cu")))
    lib.mttkrp_slab_launch.argtypes = _MTTKRP_SLAB_ARGTYPES
    lib.mttkrp_slab_launch.restype = ctypes.c_int
    lib.mttkrp_slab_error_string.argtypes = [ctypes.c_int]
    lib.mttkrp_slab_error_string.restype = ctypes.c_char_p
    return lib
