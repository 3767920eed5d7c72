"""Fused two-threshold FAST-16-9 score + 3x3 NMS: CUDA kernel and plain version.

`fast_nms_levels` scores every level of a pyramid in one kernel launch; it
is what the front end calls once a frame. `fast_nms` and `fast_nms_single`
are the ports of orbslam3_tpu/ops/fast_pallas.py::fast_nms_pallas_batch and
::fast_nms_pallas: one-level calls of the same kernel. On CUDA tensors they
launch the hand-written kernel in csrc/fast_nms.cu (sm_90a) or raise; on
CPU tensors they run `fast_nms_reference`, the plain PyTorch version of the
same function, which accumulates in the kernel's order so the two agree bit
for bit on the card.

The kernel is compiled with nvcc at first use, from the repo's source
alone, into build/orbslam3_tpu_torch/ (ignored by git through the `build/`
line of .gitignore). The library's file name carries the hash of the
source, so an edited source is rebuilt. It is bound with ctypes through a
plain C launcher that returns the launch's cudaError_t.

`fast_nms.launches` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from orbslam3_tpu_torch.ops.fast import fast_score, nms3x3

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fast_nms.cu"
BUILD_DIR = _PKG.parent / "build" / "orbslam3_tpu_torch"
# one block scores a TILE_X x TILE_Y tile of one image of one level; a launch
# takes at most MAX_LEVELS levels (the kernel's parameter table). The source
# is compiled with these values (the -D flags below).
TILE_X, TILE_Y, MAX_LEVELS = 64, 16, 16
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
              f"-DFAST_TX={TILE_X}", f"-DFAST_TY={TILE_Y}", f"-DFAST_MAX_LEVELS={MAX_LEVELS}"]

_lib = None


class _Level(ctypes.Structure):  # csrc/fast_nms.cu::FastNmsLevel
    _fields_ = [("inp", ctypes.c_void_p), ("out", ctypes.c_void_p), ("H", ctypes.c_int),
                ("W", ctypes.c_int), ("tiles_x", ctypes.c_int), ("first", ctypes.c_int)]


class _Table(ctypes.Structure):  # csrc/fast_nms.cu::FastNmsTable
    _fields_ = [("lv", _Level * MAX_LEVELS), ("n", ctypes.c_int), ("B", ctypes.c_int),
                ("total", ctypes.c_int)]


def fast_nms_reference(imgs, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """Plain PyTorch: nms3x3(max(fast_score(., thr_hi), 1e-3 * fast_score(., thr_lo)))."""
    s = torch.maximum(fast_score(imgs, thr_hi), fast_score(imgs, thr_lo) * 1e-3)
    return nms3x3(s)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           f"{SOURCE.name}")
    return found


def build() -> dict:
    """Compile csrc/fast_nms.cu unless this source's build exists. Returns
    {"path", "seconds", "cached"} and, after a compile, nvcc's "ptxas"
    report (registers, shared memory, spills)."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libfast_nms_{digest}.so"
    if lib.exists():
        return dict(path=str(lib), seconds=0.0, cached=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return dict(path=str(lib), seconds=secs, cached=False,
                ptxas=(res.stdout + res.stderr).strip())


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        fn = lib.fast_nms_launch
        fn.argtypes = [ctypes.POINTER(_Table), ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=64)
def level_table(shapes: tuple, B: int):
    """The launch's grid for a tuple of (H, W) level shapes: ((H, W, tiles_x,
    first) a level, total tiles). Flat tile indices first .. first + B *
    tiles_x * tiles_y - 1 belong to the level, image-major, then tile rows,
    then tiles across."""
    table, first = [], 0
    for H, W in shapes:
        tiles_x = -(-W // TILE_X)
        table.append((H, W, tiles_x, first))
        first += B * tiles_x * -(-H // TILE_Y)
    return tuple(table), first


def locate_tile(table, flat: int):
    """(level, image, tile row, tile column) of a flat tile index, found as
    the kernel finds it: the last level whose first tile is <= flat."""
    lv = 0
    for i in range(1, len(table)):
        if flat >= table[i][3]:
            lv = i
    H, _, tiles_x, first = table[lv]
    image, rem = divmod(flat - first, tiles_x * -(-H // TILE_Y))
    return (lv, image, *divmod(rem, tiles_x))


def fast_nms_levels(levels, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """[(B, h_l, w_l) float32] -> [(B, h_l, w_l)] NMS'd two-threshold FAST
    scores of up to MAX_LEVELS pyramid levels, from one kernel launch."""
    levels = list(levels)
    if not levels:
        return []
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"fast_nms_levels takes at most {MAX_LEVELS} levels, got {len(levels)}")
    for lv in levels:
        if lv.dtype != torch.float32 or lv.dim() != 3 or not lv.is_contiguous():
            raise ValueError("fast_nms_levels takes contiguous (B, H, W) float32 tensors, got "
                             f"{tuple(lv.shape)} {lv.dtype} contiguous={lv.is_contiguous()}")
    dev, B = levels[0].device, levels[0].shape[0]
    for lv in levels:
        if lv.shape[0] != B or lv.device != dev:
            raise ValueError("fast_nms_levels takes levels of one batch size on one device, got "
                             f"B={lv.shape[0]} on {lv.device} beside B={B} on {dev}")
    if dev.type != "cuda":
        return [fast_nms_reference(lv, thr_hi, thr_lo) for lv in levels]
    outs = [torch.empty_like(lv) for lv in levels]
    table, total = level_table(tuple(lv.shape[1:] for lv in levels), B)
    if total == 0:
        return outs
    t = _Table(n=len(levels), B=B, total=total)
    for i, (lv, out, (H, W, tiles_x, first)) in enumerate(zip(levels, outs, table)):
        t.lv[i] = _Level(lv.data_ptr(), out.data_ptr(), H, W, tiles_x, first)
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fast_nms_launch(ctypes.byref(t), float(thr_hi), float(thr_lo), stream)
    if rc != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError_t {rc}")
    fast_nms.launches += 1
    return outs


def fast_nms(imgs, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """(B, H, W) float32 -> (B, H, W) NMS'd two-threshold FAST score: a
    one-level call of the kernel."""
    return fast_nms_levels([imgs], thr_hi, thr_lo)[0]


fast_nms.launches = 0


def fast_nms_single(img, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """(H, W) -> (H, W): the port of fast_pallas.py::fast_nms_pallas, a B=1
    call of the same kernel."""
    return fast_nms(img[None].contiguous(), thr_hi, thr_lo)[0]
