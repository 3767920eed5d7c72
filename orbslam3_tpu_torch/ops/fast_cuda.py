"""Fused two-threshold FAST-16-9 score + 3x3 NMS: CUDA kernel and plain version.

`fast_nms` is the port of orbslam3_tpu/ops/fast_pallas.py::
fast_nms_pallas_batch. On a CUDA tensor it launches the hand-written kernel
in csrc/fast_nms.cu (sm_90a) or raises; on a CPU tensor it runs
`fast_nms_reference`, the plain PyTorch version of the same function, which
accumulates in the kernel's order so the two agree bit for bit on the card.

The kernel is compiled with nvcc at first use, from the repo's source
alone, into build/orbslam3_tpu_torch/ (ignored by git through the `build/`
line of .gitignore). The library's file name carries the hash of the
source, so an edited source is rebuilt. It is bound with ctypes through a
plain C launcher that returns the launch's cudaError_t.

`fast_nms.launches` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v"]

_lib = None


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
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def fast_nms(imgs, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """(B, H, W) float32 -> (B, H, W) NMS'd two-threshold FAST score."""
    if not imgs.is_cuda:
        return fast_nms_reference(imgs, thr_hi, thr_lo)
    if imgs.dtype != torch.float32 or imgs.dim() != 3 or not imgs.is_contiguous():
        raise ValueError("fast_nms takes a contiguous (B, H, W) float32 tensor, got "
                         f"{tuple(imgs.shape)} {imgs.dtype} contiguous={imgs.is_contiguous()}")
    B, H, W = imgs.shape
    out = torch.empty_like(imgs)
    if imgs.numel() == 0:
        return out
    lib = _load()
    stream = torch.cuda.current_stream(imgs.device).cuda_stream
    with torch.cuda.device(imgs.device):
        rc = lib.fast_nms_launch(imgs.data_ptr(), out.data_ptr(), B, H, W,
                                 float(thr_hi), float(thr_lo), stream)
    if rc != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError_t {rc}")
    fast_nms.launches += 1
    return out


fast_nms.launches = 0


def fast_nms_single(img, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """(H, W) -> (H, W): the port of fast_pallas.py::fast_nms_pallas, a B=1
    call of the same kernel."""
    return fast_nms(img[None].contiguous(), thr_hi, thr_lo)[0]
