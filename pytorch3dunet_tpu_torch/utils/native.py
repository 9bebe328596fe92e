"""Loader for the native C++ host ops (built lazily with g++, loaded via ctypes).

The port's own copy of pytorch3dunet_tpu/utils/native.py. The native tier
holds host-side hot loops that are awkward for numpy — the union-find
connected-components labeler (`csrc/cc3d.cpp`) used by the evaluation metrics.
It is compiled once per source change into `build/native/` in the checkout
(git-ignored), named by the source's sha256; every native op has a pure-Python
fallback, so the port works without a toolchain.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("Native")

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "cc3d.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lib = None
_load_attempted = False


def _build_and_load():
    if not SOURCE.exists():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"cc3d_{digest}.so"
    if not so_path.exists():
        # compile to a temp name + atomic rename so concurrent builders never
        # load a half-written ELF
        fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp_path, str(SOURCE)]
        logger.info(f"Building native ops: {' '.join(cmd)}")
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp_path, so_path)
        finally:
            # failed build: drop the mkstemp file instead of littering the build dir
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in [
        ("cc3d_label_i64", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]),
        ("cc3d_label_u8", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int, ctypes.c_uint8, ctypes.c_void_p]),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64
    return lib


def get_native_lib():
    global _lib, _load_attempted
    if not _load_attempted:
        _load_attempted = True
        try:
            _lib = _build_and_load()
        except Exception as e:  # toolchain missing / compile error: fall back
            logger.warning(f"Native ops unavailable ({type(e).__name__}: {e}); using scipy fallback")
            _lib = None
    return _lib


def native_label(m: np.ndarray, background: int = 0, connectivity: int | None = None):
    """Connected components via the native labeler; returns (labels, count) or
    None when the native library is unavailable."""
    lib = get_native_lib()
    if lib is None:
        return None

    if connectivity is None:
        connectivity = m.ndim
    if m.ndim == 2:
        shape3 = (1,) + m.shape
    elif m.ndim == 3:
        shape3 = m.shape
    else:
        return None

    out = np.empty(shape3, dtype=np.int64)
    if m.dtype == np.uint8:
        src = np.ascontiguousarray(m.reshape(shape3))
        n = lib.cc3d_label_u8(
            src.ctypes.data, *[ctypes.c_int64(s) for s in shape3],
            ctypes.c_int(connectivity), ctypes.c_uint8(background % 256), out.ctypes.data,
        )
    else:
        src = np.ascontiguousarray(m.reshape(shape3), dtype=np.int64)
        n = lib.cc3d_label_i64(
            src.ctypes.data, *[ctypes.c_int64(s) for s in shape3],
            ctypes.c_int(connectivity), ctypes.c_int64(int(background)), out.ctypes.data,
        )
    return out.reshape(m.shape), int(n)
