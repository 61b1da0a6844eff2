"""Build, binding and wrappers of the hand-written Hopper kernels.

`csrc/annp_harm.cu` holds `g_harm` (replaces the TPU kernel
`_g_kernel_harm`, meng_zhang_tpu/ops/pallas_annp.py:299) and `force_harm`
(replaces `_force_kernel_harm`, :352). The source is compiled at first use
by `nvcc` for `sm_90a` into a plain-C shared library under
`meng_zhang_tpu_torch/_build/<hash of source and flags>/`, and bound with
ctypes; kernels run on PyTorch's current stream.

Each wrapper takes the kernel's plain PyTorch version (ops/fused_annp.py)
only when its inputs lie on the CPU. For CUDA tensors it launches the kernel
or raises; it counts its launches in `launches`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

from . import fused_annp

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "annp_harm.cu")
_BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_K = 256          # one thread per lane, at most 8 warps per row block


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def build():
    """Compile the kernels if this source and flag set has not been built
    yet; returns (library path, build seconds, compiler log). The library
    is written to a temporary name and renamed, so concurrent builds
    never load a partial file."""
    with open(_SRC, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(_BUILD_ROOT, key)
    lib = os.path.join(out_dir, "libannp_harm.so")
    log_path = os.path.join(out_dir, "build.log")
    if os.path.exists(lib):
        with open(log_path) as f:
            return lib, 0.0, f.read()
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.monotonic()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                         capture_output=True, text=True)
    secs = time.monotonic() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib)
    return lib, secs, log


@functools.cache
def _lib():
    lib = ctypes.CDLL(build()[0])
    vp, ll, ci, cd = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_double)
    for suffix in ("f32", "f64"):
        g = getattr(lib, f"annp_g_harm_{suffix}")
        g.argtypes = [vp] * 6 + [ll, ci, ci, ci, cd, vp]
        g.restype = ci
        fn = getattr(lib, f"annp_force_harm_{suffix}")
        fn.argtypes = [vp] * 9 + [ll, ci, ci, ci, cd, vp]
        fn.restype = ci
    return lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(planes, npsf, ntsf):
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"harmonic kernels take CUDA or CPU tensors, got "
                         f"{dev}")
    p, k = planes[0].shape
    for t in planes:
        if t.device != dev or t.dtype != planes[0].dtype \
                or tuple(t.shape) != (p, k) or not t.is_contiguous():
            raise ValueError("dx planes must be contiguous [P, K] tensors of "
                             "one dtype on one device")
    if planes[0].dtype not in _SUFFIX:
        raise ValueError(f"unsupported dtype {planes[0].dtype}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K = {k} outside [1, {MAX_K}]")
    if npsf < 2 or ntsf < 1 or ntsf * ntsf > fused_annp.AB_PAD - 1 \
            or npsf + ntsf + 1 > fused_annp.NSF_PAD:
        raise ValueError(f"npsf {npsf}, ntsf {ntsf} outside the kernels' "
                         "layout")
    return p, k


def _check_row(t, planes, width, name):
    if t.device != planes[0].device or t.dtype != planes[0].dtype \
            or tuple(t.shape) != (planes[0].shape[0], width) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [P, {width}] tensor "
                         "of the planes' dtype and device")


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


class _HarmKernel:
    """Shared state of one kernel wrapper: launch count and the per-device
    ladder coefficient tables."""

    def __init__(self):
        self.launches = 0
        self._tabs = {}

    def _tab(self, ntsf, dtype, device):
        key = (ntsf, dtype, device)
        if key not in self._tabs:
            self._tabs[key] = torch.as_tensor(
                fused_annp.ladder_table(ntsf - 1), dtype=dtype,
                device=device)
        return self._tabs[key]


class GHarm(_HarmKernel):
    """g_harm(dxx, dxy, dxz, npsf, ntsf, rc) -> (g_raw [P, 128],
    A [P, 384]); see fused_annp.g_harm_plain for the layout."""

    def __call__(self, dxx, dxy, dxz, npsf, ntsf, rc):
        if dxx.device.type == "cpu":
            return fused_annp.g_harm_plain(dxx, dxy, dxz, npsf, ntsf, rc)
        planes = (dxx, dxy, dxz)
        p, k = _check(planes, npsf, ntsf)
        g = torch.empty((p, fused_annp.NSF_PAD), dtype=dxx.dtype,
                        device=dxx.device)
        a = torch.empty((p, fused_annp.AB_PAD), dtype=dxx.dtype,
                        device=dxx.device)
        fn = getattr(_lib(), f"annp_g_harm_{_SUFFIX[dxx.dtype]}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     self._tab(ntsf, dxx.dtype, dxx.device).data_ptr(),
                     g.data_ptr(), a.data_ptr(), p, k, npsf, ntsf,
                     float(rc), stream)
        _raise_on(rc_, "g_harm")
        self.launches += 1
        return g, a


class ForceHarm(_HarmKernel):
    """force_harm(dxx, dxy, dxz, dedg_rad, b, npsf, ntsf, rc) -> per-pair
    Fj = -dE_i/dx_j as three [P, K] planes; see
    fused_annp.force_harm_plain."""

    def __call__(self, dxx, dxy, dxz, dedg_rad, b, npsf, ntsf, rc):
        if dxx.device.type == "cpu":
            return fused_annp.force_harm_plain(dxx, dxy, dxz, dedg_rad, b,
                                               npsf, ntsf, rc)
        planes = (dxx, dxy, dxz)
        p, k = _check(planes, npsf, ntsf)
        _check_row(dedg_rad, planes, fused_annp.NSF_PAD, "dedg_rad")
        _check_row(b, planes, fused_annp.AB_PAD, "b")
        out = [torch.empty_like(dxx) for _ in range(3)]
        fn = getattr(_lib(), f"annp_force_harm_{_SUFFIX[dxx.dtype]}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     dedg_rad.data_ptr(), b.data_ptr(),
                     self._tab(ntsf, dxx.dtype, dxx.device).data_ptr(),
                     *(o.data_ptr() for o in out), p, k, npsf, ntsf,
                     float(rc), stream)
        _raise_on(rc_, "force_harm")
        self.launches += 1
        return tuple(out)


g_harm = GHarm()
force_harm = ForceHarm()


def reset_launch_counts():
    g_harm.launches = 0
    force_harm.launches = 0
