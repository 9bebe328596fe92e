"""Builds the hand-written CUDA kernels at first use and binds them with ctypes.

Each source under `csrc/` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface. The library is named by a sha256 of its
source, so an edited kernel is rebuilt and a stale one is never loaded; it goes
to `build/torch_kernels/` in the checkout (`build/` is git-ignored). Nothing is
compiled while a module is imported: the first launch calls `load`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("KernelBuild")

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C signatures of the entry points of each source: every pointer and the
# stream as c_void_p (a bare Python int would be cut to 32 bits), sizes as int64
_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_CONV_ARGS = [_PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _I64, _I64, _I64, _PTR]
SIGNATURES = {
    "conv3d_fwd": {
        "conv3d_fwd_f32": (_CONV_ARGS, ctypes.c_int),
        "conv3d_fwd_bf16": (_CONV_ARGS, ctypes.c_int),
        "conv3d_fwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
    "conv3d_packw": {
        "conv3d_packw_f32": (_CONV_ARGS, ctypes.c_int),
        "conv3d_packw_bf16": (_CONV_ARGS, ctypes.c_int),
        "conv3d_packw_error_string": ([ctypes.c_int], ctypes.c_char_p),
        "conv3d_packw_smem_bytes": ([], ctypes.c_int),
    },
    "conv3d_im2col": {
        "conv3d_im2col_f32": (_CONV_ARGS, ctypes.c_int),
        "conv3d_im2col_bf16": (_CONV_ARGS, ctypes.c_int),
        "conv3d_im2col_error_string": ([ctypes.c_int], ctypes.c_char_p),
        "conv3d_im2col_smem_bytes": ([], ctypes.c_int),
    },
}

_libs: dict = {}
_lock = threading.Lock()
# one lock per source: two sources build at once, one source never twice
_name_locks: dict[str, threading.Lock] = {}
# nvcc's output (ptxas register / shared-memory / spill report) per source
build_logs: dict[str, str] = {}


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>.cu` lives: named by the
    sha256 of the source and of the compiler flags."""
    digest = hashlib.sha256(source_path(name).read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {candidate} and on PATH): the CUDA kernels cannot be built")
    return found


def _compile(name: str, so_path: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename, so a concurrent loader never
    # opens a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source_path(name))]
    logger.info(f"Building {name}: {' '.join(cmd)}")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source_path(name)} (exit {proc.returncode}):\n{build_logs[name]}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(name: str) -> ctypes.CDLL:
    """Returns the bound library of `csrc/<name>.cu`, building it first if
    this version of the source has not been built."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        so_path = library_path(name)
        if not so_path.exists():
            _compile(name, so_path)
        lib = ctypes.CDLL(str(so_path))
        for fn_name, (argtypes, restype) in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[name] = lib
        return lib


def load_all(names=None) -> dict[str, ctypes.CDLL]:
    """Loads every named source (all of `SIGNATURES` by default), running
    one nvcc per source at the same time."""
    names = list(SIGNATURES if names is None else names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))
