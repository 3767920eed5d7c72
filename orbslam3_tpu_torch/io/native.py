"""ctypes bindings to the native C++ data loader (native/dataloader.cpp).

Copy of orbslam3_tpu/io/native.py: PNG grayscale decode, IMU CSV parsing
and a threaded image prefetcher, through the library's plain C ABI. The
library is built at first use with g++ from the checkout's
native/dataloader.cpp into build/orbslam3_tpu_torch/ (zlib and pthreads
only); a failed build raises with the compiler's message. `available()`
says whether the library is loaded, which needs g++ on the machine.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "dataloader.cpp")
_LIB_PATH = os.path.join(_ROOT, "build", "orbslam3_tpu_torch", "liborbslam3_io.so")
COMPILER = "g++"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> str:
    """Compile native/dataloader.cpp into the shared library unless it is
    newer than its source. Returns the library's path; raises RuntimeError
    with the compiler's output when the build fails."""
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    cxx = shutil.which(COMPILER)
    if cxx is None:
        raise RuntimeError(f"{COMPILER} not found: cannot build the native data loader")
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    # build beside the target and rename: concurrent builders never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB_PATH))
    os.close(fd)
    cmd = [cxx, *FLAGS, "-o", tmp, _SRC, "-lz", "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native data loader failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load():
    global _lib
    if _lib is None and shutil.which(COMPILER) is not None:
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.png_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
        lib.png_info.restype = ctypes.c_int
        lib.png_decode_gray.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int]
        lib.png_decode_gray.restype = ctypes.c_int
        lib.imu_csv_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        lib.imu_csv_parse.restype = ctypes.c_long
        lib.prefetcher_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.prefetcher_create.restype = ctypes.c_void_p
        lib.prefetcher_get.argtypes = [ctypes.c_void_p, ctypes.c_long, u8p]
        lib.prefetcher_get.restype = ctypes.c_int
        lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library not built: {COMPILER} not found")
    return lib


def png_decode_gray(path: str) -> np.ndarray:
    """Decode a PNG into (H, W) uint8 grayscale with the native decoder."""
    lib = _lib_or_raise()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.png_info(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"png_info({path}) failed: {rc}")
    out = np.empty((h.value, w.value), np.uint8)
    rc = lib.png_decode_gray(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             out.size)
    if rc != 0:
        raise IOError(f"png_decode_gray({path}) failed: {rc}")
    return out


def imu_csv_parse(path: str, cap: int = 2_000_000):
    """Parse an EuRoC imu0/data.csv natively -> (ts_ns, gyro, acc)."""
    lib = _lib_or_raise()
    ts = np.empty(cap, np.int64)
    gyro = np.empty((cap, 3), np.float32)
    acc = np.empty((cap, 3), np.float32)
    n = lib.imu_csv_parse(path.encode(), ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                          gyro.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          acc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
    if n < 0:
        raise IOError(f"imu_csv_parse({path}) failed: {n}")
    return ts[:n].copy(), gyro[:n].copy(), acc[:n].copy()


class ImagePrefetcher:
    """Threaded PNG prefetcher: decodes frames ahead of the SLAM loop."""

    def __init__(self, paths: list, width: int, height: int, threads: int = 2):
        self._lib = _lib_or_raise()
        self.width = width
        self.height = height
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._paths_keepalive = arr
        self._h = self._lib.prefetcher_create(arr, len(paths), width, height, threads)
        self._n = len(paths)

    def get(self, index: int) -> np.ndarray:
        out = np.empty((self.height, self.width), np.uint8)
        rc = self._lib.prefetcher_get(self._h, index,
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == 1:
            # the native side zero-filled the buffer: never feed a black frame
            raise IOError(f"prefetcher_get({index}): PNG decode failed")
        if rc != 0:
            raise IOError(f"prefetcher_get({index}) failed: {rc}")
        return out

    def close(self):
        if self._h:
            self._lib.prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
