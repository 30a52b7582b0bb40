"""Build and bind the port's CUDA kernels.

Each source under ``csrc/`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/`` at the repository root at first
use (the library's file name carries a hash of the source, the headers
beside it and the flags, so an edited source or header rebuilds) and
loaded with ``ctypes``.  Nothing is built when a module is imported: only
the first launch on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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
# mttkrp_slab_launch(device, batch, chunk_slab, num_chunks, chunk_slabs,
#   group_chunk, num_groups, rb_group_ptr, num_row_blocks, idx, vals, lrows,
#   slots, tile, stream_vec, factor_ptrs, factor_lane_strides, factor_rows,
#   num_inputs, factors_bf16, rank, block_rows, rank_block, r_pad, cols,
#   walkers, stage_slots, staged_mask, partials, group_sums, out, stream)
_MTTKRP_SLAB_ARGTYPES = [_I, _I, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P,
                         _LL, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P, _P, _P, _P]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_sources(source: Path) -> list[Path]:
    """Every file the library of ``source`` is built from: the source and
    the headers beside it (``*.cuh``, ``*.h``), in a fixed order."""
    headers = [p for pattern in ("*.cuh", "*.h") for p in source.parent.glob(pattern)]
    return [source, *sorted(headers)]


def library_path(source: Path) -> Path:
    """The library's file: its name carries a hash of every source it is
    built from and of the flags, so editing any of them rebuilds."""
    h = hashlib.sha256()
    for path in library_sources(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


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
    return bind_library(compile_source(CSRC / "mttkrp_slab.cu"))


def bind_library(path: Path) -> ctypes.CDLL:
    """Load a built slab-kernel library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    lib.mttkrp_slab_launch.argtypes = _MTTKRP_SLAB_ARGTYPES
    lib.mttkrp_slab_launch.restype = ctypes.c_int
    lib.mttkrp_slab_blocks_per_sm.argtypes = [_I, _I, _I, _I, _I, _LL]
    lib.mttkrp_slab_blocks_per_sm.restype = ctypes.c_int
    lib.mttkrp_slab_error_string.argtypes = [ctypes.c_int]
    lib.mttkrp_slab_error_string.restype = ctypes.c_char_p
    return lib


_PTXAS_TYPES = {"f": "float", "13__nv_bfloat16": "bfloat16"}


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of an ``-Xptxas -v`` log: its name with its
    template arguments (type, inputs W, columns per thread V), registers
    and spill bytes, e.g. ``chunk_tiles_kernel<float,W=3,V=4>: 64
    registers, 12 bytes spill stores, 16 bytes spill loads``."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = _demangle(m.group(1)), ""
        elif name and "spill stores" in line:
            spill = line.strip().split(", ", 1)[1]
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {spill}")
            name = None
    return out


def _demangle(symbol: str) -> str:
    m = re.search(r"(chunk_tiles_kernel|sum_ranges_kernel)(I(f|13__nv_bfloat16)Li(\d)ELi(\d)E)?",
                  symbol)
    if not m:
        return symbol
    if not m.group(2):
        return m.group(1)
    return f"{m.group(1)}<{_PTXAS_TYPES[m.group(3)]},W={m.group(4)},V={m.group(5)}>"
