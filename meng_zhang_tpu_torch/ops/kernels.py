"""Build, binding and wrappers of the hand-written Hopper kernels.

`csrc/annp_harm.cu` holds `g_harm` (replaces the TPU kernel
`_g_kernel_harm`, meng_zhang_tpu/ops/pallas_annp.py:299) and `force_harm`
(replaces `_force_kernel_harm`, :352); `csrc/annp_gcos.cu` holds `g_cos`
(replaces `_g_kernel`, :116) and `csrc/annp_cos.cu` `force_cos` (replaces
`_force_kernel`, :193); `csrc/ni_bp.cu` holds `ni_g` (replaces `_ni_g_kernel`,
meng_zhang_tpu/ops/pallas_ni.py:126) and `ni_force` (replaces
`_ni_force_kernel`, :170), and for rows wider than NI_MAX_K their
cross-tile instances `ni_g_tiles` and `ni_force_tiles` (the same TPU
kernels), the latter with its second kernel `ni_force_tiles_sum`. Every `.cu` under `csrc/` is compiled at first
use by `nvcc` for `sm_90a` into its own plain-C shared library under
`meng_zhang_tpu_torch/_build/<hash of the sources, headers and flags>/`
(one nvcc per source, all started together), and bound with ctypes;
kernels run on PyTorch's current stream.

Each wrapper takes the kernel's plain PyTorch version (ops/fused_annp.py,
ops/fused_ni.py) only when its inputs lie on the CPU. For CUDA tensors it
launches the kernel or raises; it counts its kernel's launches in
`launches` (one a call, but for `ni_force_tiles` and `ni_force_tiles_sum`:
one a chunk of rows).
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from . import fused_annp, fused_ni

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# --split-compile 0: each source's kernel instances (up to 64) go through
# the optimiser on all cores instead of one after another; on an 8-core
# host the four sources build in 19 s with it and 35 s without (nvcc 12.9)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0")
# Widest row (K) of one launch's row: g_harm walks a row of more than 256
# slots in two tiles of <= 8 slots a lane, force_harm splits it over two
# blocks, the cos pair runs it on blocks of up to 16 warps; ni: one warp a
# row, <= 16 slots a lane. 512 is the JAX fused evaluators' own ceiling
# (their int32 (row, slot) packing), so the fused short-list path and the
# cos pair stop there. The harmonic and ni wrappers take wider rows, of
# any K, as the JAX chunked functions evaluate them: the harmonic pair as
# HARM_TILE-slot virtual rows through the same kernels (row sums add over
# tiles; fused_annp.g_harm_tiles), the ni pair through the cross-tile
# instances of ni_bp.cu in NI_TILE-slot tiles.
MAX_K = 512
COS_MAX_T = 32       # cos kernels: one compiled instance per ntsf up to it
NI_MAX_K = 512
# Tile widths, chosen by measurement on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md): at [152880, 768] g_harm / force_harm took ~12.1 / ~10.7 ms in
# virtual rows of 256 slots (the one-tile instances) and ~17.7 / ~16.6 ms
# in rows of 512 (the two-tile ones; chip_smoke.py [fe-widest] as it stood
# then); at [16384, 640] the ni cross-tile kernels of pairs of tiles take
# about half the time in tiles of 128 slots that they take in tiles of 256
# (a 256-slot unit holds 2x the shared memory, so fewer warps share an
# SM). ni_bp.cu compiles its cross-tile instances for NI_TILE alone
# (kCrossSlots).
HARM_TILE = 256      # slots of a virtual row of a wider harmonic row
NI_TILE = 128        # slots of a tile of a wider ni row
# ni_force_tiles' scratch of unit partials, T^2 4 NI_TILE values a row (at
# K 640 in f32 51,200 bytes: 5,242 rows a chunk)
NI_SCRATCH_BYTES = 1 << 28


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
    """Compile every csrc/*.cu into lib<stem>.so unless this set of sources
    and flags has been built already; returns ({stem: library path}, build
    seconds, compiler log). The nvcc processes run in parallel; each library
    is written to a temporary name and renamed, so concurrent builds never
    load a partial file."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    out_dir = os.path.join(_BUILD_ROOT, h.hexdigest()[:16])
    stems = [os.path.splitext(os.path.basename(s))[0] for s in srcs]
    libs = {stem: os.path.join(out_dir, f"lib{stem}.so") for stem in stems}
    log_path = os.path.join(out_dir, "build.log")
    if all(os.path.exists(p) for p in libs.values()):
        with open(log_path) as f:
            return libs, 0.0, f.read()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    jobs = []
    for src, (stem, lib) in zip(srcs, libs.items()):
        tmp = f"{lib}.{os.getpid()}.tmp"
        jobs.append((stem, lib, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for stem, lib, tmp, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"== {stem}.cu\n{out}")
        if proc.returncode != 0:
            failed.append(f"{stem}.cu ({proc.returncode})")
    secs = time.monotonic() - t0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    for _, lib, tmp, _ in jobs:
        os.replace(tmp, lib)
    return libs, secs, log


@functools.cache
def _libs():
    """{source stem: ctypes library}, argument types declared."""
    vp, ll, ci, cd = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_double)
    libs = {stem: ctypes.CDLL(path) for stem, path in build()[0].items()}
    harm, gcos, cos, ni = (libs[stem] for stem in (
        "annp_harm", "annp_gcos", "annp_cos", "ni_bp"))
    for suffix in ("f32", "f64"):
        g = getattr(harm, f"annp_g_harm_{suffix}")
        g.argtypes = [vp] * 6 + [ll, ci, ci, ci, cd, vp]
        g.restype = ci
        fn = getattr(harm, f"annp_force_harm_{suffix}")
        fn.argtypes = [vp] * 9 + [ll, ci, ci, ci, cd, vp]
        fn.restype = ci
        g = getattr(gcos, f"annp_g_cos_{suffix}")
        g.argtypes = [vp] * 4 + [ll, ci, ci, ci, cd, vp]
        g.restype = ci
        fn = getattr(cos, f"annp_force_cos_{suffix}")
        fn.argtypes = [vp] * 7 + [ll, ci, ci, ci, cd, vp]
        fn.restype = ci
        g = getattr(ni, f"ni_g_{suffix}")
        g.argtypes = [vp] * 4 + [ll, ci, vp, vp]
        g.restype = ci
        fn = getattr(ni, f"ni_force_{suffix}")
        fn.argtypes = [vp] * 7 + [ll, ci, vp, vp]
        fn.restype = ci
        g = getattr(ni, f"ni_g_tiles_{suffix}")
        g.argtypes = [vp] * 4 + [ll, ci, vp, vp]
        g.restype = ci
        fn = getattr(ni, f"ni_force_tiles_{suffix}")
        fn.argtypes = [vp] * 5 + [ll, ci, vp, vp]
        fn.restype = ci
        fn = getattr(ni, f"ni_force_tiles_sum_{suffix}")
        fn.argtypes = [vp] * 8 + [ll, ci, vp, vp]
        fn.restype = ci
        size = getattr(ni, f"ni_cfg_size_{suffix}")
        size.restype = ci
        if size() != ctypes.sizeof(_NI_CFG[suffix]):
            raise RuntimeError("ni_bp.cu's NiCfg layout differs from the "
                               "ctypes mirror in ops/kernels.py")
    return libs


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def tiled_width(widest, tile):
    """Columns for rows compacted to their partners, `widest` at most:
    MAX_K (= NI_MAX_K, the single launches' width) where they fit, else
    `widest` rounded up to whole tiles."""
    return MAX_K if widest <= MAX_K else -(-widest // tile) * tile


def _check_planes(planes, max_k=None, limit=None):
    """(P, K) of contiguous [P, K] planes of one dtype on one CUDA device;
    K at most max_k unless it is None."""
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA or CPU tensors, got {dev}")
    p, k = planes[0].shape
    for t in planes:
        if t.device != dev or t.dtype != planes[0].dtype \
                or tuple(t.shape) != (p, k) or not t.is_contiguous():
            raise ValueError("dx planes must be contiguous [P, K] tensors of "
                             "one dtype on one device")
    if planes[0].dtype not in _SUFFIX:
        raise ValueError(f"unsupported dtype {planes[0].dtype}")
    if k < 1 or (max_k is not None and k > max_k):
        raise ValueError(f"K = {k} outside [1, {limit} = {max_k}]")
    return p, k


def _check(planes, npsf, ntsf):
    p, k = _check_planes(planes, MAX_K, "MAX_K")
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
    """Shared state of one kernel wrapper: launch count and the float64
    ladder tables on the host, which each launch copies into its parameter
    block."""

    def __init__(self):
        self.launches = 0
        self._tabs = {}

    def _tab(self, ntsf):
        if ntsf not in self._tabs:
            self._tabs[ntsf] = np.ascontiguousarray(
                fused_annp.ladder_table(ntsf - 1), dtype=np.float64)
        return self._tabs[ntsf].ctypes.data


class GHarm(_HarmKernel):
    """g_harm(dxx, dxy, dxz, npsf, ntsf, rc) -> (g_raw [P, 128],
    A [P, 384]); see fused_annp.g_harm_plain for the layout. A row wider
    than MAX_K goes as virtual rows of HARM_TILE slots through this wrapper
    (fused_annp.g_harm_tiles): one launch on the card, the plain version
    on the CPU."""

    def __call__(self, dxx, dxy, dxz, npsf, ntsf, rc):
        if dxx.shape[1] > MAX_K:
            return fused_annp.g_harm_tiles(dxx, dxy, dxz, npsf, ntsf, rc,
                                           HARM_TILE, piece=self)
        if dxx.device.type == "cpu":
            return fused_annp.g_harm_plain(dxx, dxy, dxz, npsf, ntsf, rc)
        planes = (dxx, dxy, dxz)
        p, k = _check(planes, npsf, ntsf)
        g = torch.empty((p, fused_annp.NSF_PAD), dtype=dxx.dtype,
                        device=dxx.device)
        a = torch.empty((p, fused_annp.AB_PAD), dtype=dxx.dtype,
                        device=dxx.device)
        fn = getattr(_libs()["annp_harm"], f"annp_g_harm_{_SUFFIX[dxx.dtype]}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     self._tab(ntsf), g.data_ptr(), a.data_ptr(), p, k,
                     npsf, ntsf, float(rc), stream)
        _raise_on(rc_, "g_harm")
        self.launches += 1
        return g, a


class ForceHarm(_HarmKernel):
    """force_harm(dxx, dxy, dxz, dedg_rad, b, npsf, ntsf, rc) -> per-pair
    Fj = -dE_i/dx_j as three [P, K] planes; see
    fused_annp.force_harm_plain. A row wider than MAX_K goes as virtual
    rows of HARM_TILE slots, each with its row's dedg_rad and b
    (fused_annp.force_harm_tiles)."""

    def __call__(self, dxx, dxy, dxz, dedg_rad, b, npsf, ntsf, rc):
        if dxx.shape[1] > MAX_K:
            return fused_annp.force_harm_tiles(dxx, dxy, dxz, dedg_rad, b,
                                               npsf, ntsf, rc, HARM_TILE,
                                               piece=self)
        if dxx.device.type == "cpu":
            return fused_annp.force_harm_plain(dxx, dxy, dxz, dedg_rad, b,
                                               npsf, ntsf, rc)
        planes = (dxx, dxy, dxz)
        p, k = _check(planes, npsf, ntsf)
        _check_row(dedg_rad, planes, fused_annp.NSF_PAD, "dedg_rad")
        _check_row(b, planes, fused_annp.AB_PAD, "b")
        out = [torch.empty_like(dxx) for _ in range(3)]
        fn = getattr(_libs()["annp_harm"],
                     f"annp_force_harm_{_SUFFIX[dxx.dtype]}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     dedg_rad.data_ptr(), b.data_ptr(), self._tab(ntsf),
                     *(o.data_ptr() for o in out), p, k, npsf, ntsf,
                     float(rc), stream)
        _raise_on(rc_, "force_harm")
        self.launches += 1
        return tuple(out)


# ---------------------------------------------------------- cos matrix
def _check_cos(planes, npsf, ntsf):
    p, k = _check_planes(planes, MAX_K, "MAX_K")
    if npsf < 2 or not 1 <= ntsf <= COS_MAX_T \
            or npsf + ntsf > fused_annp.NSF_PAD:
        raise ValueError(f"npsf {npsf}, ntsf {ntsf} outside the cos kernels' "
                         "layout")
    return p, k


class GCos:
    """g_cos(dxx, dxy, dxz, npsf, ntsf, rc) -> raw descriptors g [P, 128];
    see fused_annp.g_cos_plain."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dxx, dxy, dxz, npsf, ntsf, rc):
        if dxx.device.type == "cpu":
            return fused_annp.g_cos_plain(dxx, dxy, dxz, npsf, ntsf, rc)
        p, k = _check_cos((dxx, dxy, dxz), npsf, ntsf)
        g = torch.empty((p, fused_annp.NSF_PAD), dtype=dxx.dtype,
                        device=dxx.device)
        fn = getattr(_libs()["annp_gcos"],
                     f"annp_g_cos_{_SUFFIX[dxx.dtype]}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     g.data_ptr(), p, k, npsf, ntsf, float(rc), stream)
        _raise_on(rc_, "g_cos")
        self.launches += 1
        return g


class ForceCos:
    """force_cos(dxx, dxy, dxz, dedg, npsf, ntsf, rc) -> per-pair
    Fj = -dE_i/dx_j as three [P, K] planes, dedg [P, 128] carrying
    sf_scale * e_scale; see fused_annp.force_cos_plain."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dxx, dxy, dxz, dedg, npsf, ntsf, rc):
        if dxx.device.type == "cpu":
            return fused_annp.force_cos_plain(dxx, dxy, dxz, dedg, npsf, ntsf,
                                              rc)
        planes = (dxx, dxy, dxz)
        p, k = _check_cos(planes, npsf, ntsf)
        _check_row(dedg, planes, fused_annp.NSF_PAD, "dedg")
        out = [torch.empty_like(dxx) for _ in range(3)]
        fn = getattr(_libs()["annp_cos"],
                     f"annp_force_cos_{_SUFFIX[dxx.dtype]}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     dedg.data_ptr(), *(o.data_ptr() for o in out), p, k,
                     npsf, ntsf, float(rc), stream)
        _raise_on(rc_, "force_cos")
        self.launches += 1
        return tuple(out)


# ---------------------------------------------------------------- ni
# NiCfg's arrays: any table of nsf = nrad + nang <= 32 (fused_ni.NSF_SUB)
# fits, as in the TPU kernels; eta groups, distinct (lambda, zeta) shapes
# and their (group, shape) entries are each at most nang
_NI_MAX = 32


def _ni_cfg_type(real):
    """ctypes mirror of NiCfg<T> (csrc/ni_bp.cu)."""
    ci, cd, cu = ctypes.c_int, ctypes.c_double, ctypes.c_uint32
    return type(f"NiCfg_{real.__name__}", (ctypes.Structure,), {"_fields_": [
        ("nrad", ci), ("nang", ci), ("rc_a", cd),
        ("rad_eta", cd * _NI_MAX), ("rad_rc", cd * _NI_MAX),
        ("eta", real * _NI_MAX), ("lam", real * _NI_MAX),
        ("zeta", real * _NI_MAX), ("coef", real * _NI_MAX),
        ("col", ci * _NI_MAX), ("zlog2", ci * _NI_MAX),
        ("first", ci * _NI_MAX), ("ngroup", ci), ("nshape", ci),
        ("nent", ci), ("grp_eta", real * _NI_MAX),
        ("grp_mask", cu * _NI_MAX), ("grp_off", ci * _NI_MAX),
        ("sh_lam", real * _NI_MAX), ("sh_zeta", real * _NI_MAX),
        ("sh_adv", ci * _NI_MAX), ("sh_new", ci * _NI_MAX),
        ("ent", ci * _NI_MAX), ("ent_sh", ci * _NI_MAX),
        ("ent_first", ci * _NI_MAX), ("ent_eta", real * _NI_MAX)]})


_NI_CFG = {"f32": _ni_cfg_type(ctypes.c_float),
           "f64": _ni_cfg_type(ctypes.c_double)}


def _zeta_log2(zeta):
    """log2(zeta) when zeta is a positive power of two, else -1."""
    zi = int(zeta)
    pow2 = zeta == zi and zi > 0 and (zi & (zi - 1)) == 0
    return zi.bit_length() - 1 if pow2 else -1


@functools.cache
def _ni_cfg(table, suffix):
    """The kernels' NiCfg for a fused_ni.NiTable (functions group-major).

    Beside the per-function arrays that ni_g reads, it lists the table's
    structure for ni_force: the eta groups, the distinct (lambda, zeta)
    shapes sorted by lambda then zeta, and the (group, shape) entries that
    occur, group-major then by shape (each group's shapes as the bits of
    grp_mask, its first entry grp_off; each function's entry ent).
    Power-of-two zetas of one lambda share a squaring chain: sh_new starts
    it, sh_adv counts the squarings from the shape before (-1: through
    pow). ni_g_tiles walks the entries: each one's shape (ent_sh), group
    eta (ent_eta) and whether it opens its group (ent_first). Raises where
    the TPU kernels refuse the table: more than NSF_SUB
    functions, or angular columns that do not follow the radial ones
    (ni_table itself refuses more than one angular cutoff)."""
    fns = [(gi, eta, fi == 0, lam, zeta, col)
           for gi, (eta, group) in enumerate(table.ang)
           for fi, (lam, zeta, col) in enumerate(group)]
    if len(table.rad) + len(fns) > _NI_MAX:
        raise ValueError(f"{len(table.rad)} radial + {len(fns)} angular "
                         f"functions exceed the kernels' {_NI_MAX}")
    if sorted(f[-1] for f in fns) != list(range(
            len(table.rad), len(table.rad) + len(fns))):
        raise ValueError("angular columns must follow the radial ones")
    shapes = sorted({(lam, zeta) for _, _, _, lam, zeta, _ in fns})
    entries = sorted({(gi, shapes.index((lam, zeta)))
                      for gi, _, _, lam, zeta, _ in fns})
    c = _NI_CFG[suffix]()
    c.nrad, c.nang, c.rc_a = len(table.rad), len(fns), table.rc_a
    c.ngroup, c.nshape, c.nent = len(table.ang), len(shapes), len(entries)
    for i, (eta, rc) in enumerate(table.rad):
        c.rad_eta[i], c.rad_rc[i] = eta, rc
    for gi, (eta, _) in enumerate(table.ang):
        c.grp_eta[gi] = eta
        mine = [e for e, (g, _) in enumerate(entries) if g == gi]
        c.grp_off[gi] = mine[0]
        c.grp_mask[gi] = sum(1 << entries[e][1] for e in mine)
    chain = None                   # (lambda, log2 zeta) of the running chain
    for si, (lam, zeta) in enumerate(shapes):
        level = _zeta_log2(zeta)
        c.sh_lam[si], c.sh_zeta[si] = lam, zeta
        if level < 0:
            c.sh_new[si], c.sh_adv[si], chain = 0, -1, None
            continue
        fresh = chain is None or chain[0] != lam
        c.sh_new[si] = int(fresh)
        c.sh_adv[si] = level if fresh else level - chain[1]
        chain = (lam, level)
    for f, (gi, eta, first, lam, zeta, col) in enumerate(fns):
        c.eta[f], c.lam[f], c.zeta[f] = eta, lam, zeta
        c.coef[f] = 2.0 ** (1.0 - zeta)
        c.col[f], c.first[f] = col, int(first)
        c.zlog2[f] = _zeta_log2(zeta)
        c.ent[f] = entries.index((gi, shapes.index((lam, zeta))))
    for e, (gi, si) in enumerate(entries):
        c.ent_sh[e], c.ent_eta[e] = si, table.ang[gi][0]
        c.ent_first[e] = int(e == c.grp_off[gi])
    return c


def _check_ni(planes, max_k=NI_MAX_K):
    p, k = _check_planes(planes, max_k, "NI_MAX_K")
    return p, k, _SUFFIX[planes[0].dtype]


class NiG:
    """ni_g(dxx, dxy, dxz, table) -> raw BP descriptors g [P, 32]; see
    fused_ni.ni_g_plain. The kernel sums in a fixed order: two runs on the
    same input agree bit for bit. A row wider than NI_MAX_K goes to the
    cross-tile wrapper `ni_g_tiles`."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dxx, dxy, dxz, table):
        if dxx.shape[1] > NI_MAX_K:
            return ni_g_tiles(dxx, dxy, dxz, table)
        if dxx.device.type == "cpu":
            return fused_ni.ni_g_plain(dxx, dxy, dxz, table)
        p, k, suffix = _check_ni((dxx, dxy, dxz))
        cfg = _ni_cfg(table, suffix)
        g = torch.empty((p, fused_ni.NSF_SUB), dtype=dxx.dtype,
                        device=dxx.device)
        fn = getattr(_libs()["ni_bp"], f"ni_g_{suffix}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     g.data_ptr(), p, k, ctypes.addressof(cfg), stream)
        _raise_on(rc_, "ni_g")
        self.launches += 1
        return g


class NiForce:
    """ni_force(dxx, dxy, dxz, dedg, table) -> per-pair Fj = -dE_i/dx_j as
    three [P, K] planes, dedg [P, 32] carrying sf_scale * e_scale; see
    fused_ni.ni_force_plain. The kernel sums each lane's pair terms with
    shared-memory atomics, so f32 results may differ in the last bits from
    run to run. A row wider than NI_MAX_K goes to the cross-tile wrapper
    `ni_force_tiles`."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dxx, dxy, dxz, dedg, table):
        if dxx.shape[1] > NI_MAX_K:
            return ni_force_tiles(dxx, dxy, dxz, dedg, table)
        if dxx.device.type == "cpu":
            return fused_ni.ni_force_plain(dxx, dxy, dxz, dedg, table)
        planes = (dxx, dxy, dxz)
        p, k, suffix = _check_ni(planes)
        _check_row(dedg, planes, fused_ni.NSF_SUB, "dedg")
        cfg = _ni_cfg(table, suffix)
        out = [torch.empty_like(dxx) for _ in range(3)]
        fn = getattr(_libs()["ni_bp"], f"ni_force_{suffix}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     dedg.data_ptr(), *(o.data_ptr() for o in out), p, k,
                     ctypes.addressof(cfg), stream)
        _raise_on(rc_, "ni_force")
        self.launches += 1
        return tuple(out)


class NiGTiles:
    """ni_g of rows of any width through the cross-tile instance, in tiles
    of NI_TILE slots (CPU: its plain twin fused_ni.ni_g_tiles_plain):
    [P, U, 32] partials, one a unit (the U = T (T + 1) / 2 tile pairs of
    fused_ni.cross_units), summed in unit order. It sums in a fixed order:
    two runs on the same input agree bit for bit."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dxx, dxy, dxz, table):
        if dxx.device.type == "cpu":
            part = fused_ni.ni_g_tiles_plain(dxx, dxy, dxz, table, NI_TILE)
            return fused_annp.sum_tiles(part)
        p, k, suffix = _check_ni((dxx, dxy, dxz), None)
        cfg = _ni_cfg(table, suffix)
        nt = -(-k // NI_TILE)
        part = torch.empty((p, nt * (nt + 1) // 2, fused_ni.NSF_SUB),
                           dtype=dxx.dtype, device=dxx.device)
        fn = getattr(_libs()["ni_bp"], f"ni_g_tiles_{suffix}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     part.data_ptr(), p, k, ctypes.addressof(cfg), stream)
        _raise_on(rc_, "ni_g_tiles")
        self.launches += 1
        return fused_annp.sum_tiles(part)


def ni_scratch_rows(k, itemsize):
    """Rows of a chunk of ni_force_tiles on rows of K slots: as many as
    keep its scratch of T^2 4 NI_TILE values a row within
    NI_SCRATCH_BYTES, at least one."""
    nt = -(-k // NI_TILE)
    return max(1, NI_SCRATCH_BYTES // (nt * nt * 4 * NI_TILE * itemsize))


class NiForceTiles:
    """ni_force of rows of any width through the cross-tile instance, in
    tiles of NI_TILE slots (CPU: its plain twin
    fused_ni.ni_force_tiles_plain). The rows go in chunks of
    ni_scratch_rows; each chunk goes through the unit kernel (`units`,
    counted here), whose partials of its units' two tiles' slots go to a
    scratch [rows, T, T, 4, NI_TILE], and then through `ni_force_tiles_sum`
    (counted there), which adds each slot's T partials in tile order. No
    atomics: two runs agree bit for bit."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dxx, dxy, dxz, dedg, table):
        if dxx.device.type == "cpu":
            return fused_ni.ni_force_tiles_plain(dxx, dxy, dxz, dedg, table,
                                                 NI_TILE)
        p, k, _ = _check_ni((dxx, dxy, dxz), None)
        _check_row(dedg, (dxx, dxy, dxz), fused_ni.NSF_SUB, "dedg")
        chunk = max(1, min(p, ni_scratch_rows(k, dxx.element_size())))
        nt = -(-k // NI_TILE)
        part = torch.empty((chunk, nt, nt, 4, NI_TILE), dtype=dxx.dtype,
                           device=dxx.device)
        out = [torch.empty_like(dxx) for _ in range(3)]
        for r0 in range(0, p, chunk):
            rows = slice(r0, min(p, r0 + chunk))
            planes = [t[rows] for t in (dxx, dxy, dxz)]
            sub = part[:rows.stop - r0]
            self.units(*planes, dedg[rows], table, sub)
            ni_force_tiles_sum(*planes, dedg[rows], sub, table,
                               [o[rows] for o in out])
        return tuple(out)

    def units(self, dxx, dxy, dxz, dedg, table, part=None):
        """The unit kernel alone: part [P, T, T, 4, NI_TILE] (CPU:
        fused_ni.ni_force_tiles_part_plain); at [:, a, b] tile a's sums
        over its pairs with tile b, by a slot's place among its tile's
        slots inside the angular cutoff (places past them unwritten)."""
        if dxx.device.type == "cpu":
            return fused_ni.ni_force_tiles_part_plain(dxx, dxy, dxz, dedg,
                                                      table, NI_TILE)
        planes = (dxx, dxy, dxz)
        p, k, suffix = _check_ni(planes, None)
        _check_row(dedg, planes, fused_ni.NSF_SUB, "dedg")
        nt = -(-k // NI_TILE)
        if part is None:
            part = torch.empty((p, nt, nt, 4, NI_TILE), dtype=dxx.dtype,
                               device=dxx.device)
        _check_part(part, planes, nt)
        cfg = _ni_cfg(table, suffix)
        fn = getattr(_libs()["ni_bp"], f"ni_force_tiles_{suffix}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     dedg.data_ptr(), part.data_ptr(), p, k,
                     ctypes.addressof(cfg), stream)
        _raise_on(rc_, "ni_force_tiles")
        self.launches += 1
        return part


class NiForceTilesSum:
    """ni_force_tiles' second kernel: Fj [P, K] x3 from the unit partials
    part [P, T, T, 4, NI_TILE] of NiForceTiles.units, each slot's T
    partials added in tile order, then its radial term (CPU: its plain twin
    fused_ni.ni_force_tiles_sum_plain). `out`: three [P, K] planes to write
    (views of wider planes' rows may do), else new ones."""

    def __init__(self):
        self.launches = 0

    def __call__(self, dxx, dxy, dxz, dedg, part, table, out=None):
        if dxx.device.type == "cpu":
            return fused_ni.ni_force_tiles_sum_plain(dxx, dxy, dxz, dedg,
                                                     part, table)
        planes = (dxx, dxy, dxz)
        p, k, suffix = _check_ni(planes, None)
        _check_row(dedg, planes, fused_ni.NSF_SUB, "dedg")
        _check_part(part, planes, -(-k // NI_TILE))
        if out is None:
            out = [torch.empty_like(dxx) for _ in range(3)]
        for o in out:
            if o.shape != dxx.shape or o.dtype != dxx.dtype \
                    or o.device != dxx.device or not o.is_contiguous():
                raise ValueError("out: three contiguous planes like dxx")
        cfg = _ni_cfg(table, suffix)
        fn = getattr(_libs()["ni_bp"], f"ni_force_tiles_sum_{suffix}")
        with torch.cuda.device(dxx.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc_ = fn(dxx.data_ptr(), dxy.data_ptr(), dxz.data_ptr(),
                     dedg.data_ptr(), part.data_ptr(),
                     *(o.data_ptr() for o in out), p, k,
                     ctypes.addressof(cfg), stream)
        _raise_on(rc_, "ni_force_tiles_sum")
        self.launches += 1
        return tuple(out)


def _check_part(part, planes, nt):
    shape = (planes[0].shape[0], nt, nt, 4, NI_TILE)
    if tuple(part.shape) != shape or part.dtype != planes[0].dtype \
            or part.device != planes[0].device or not part.is_contiguous():
        raise ValueError(f"part: a contiguous {list(shape)} tensor like the "
                         "planes")


g_harm = GHarm()
force_harm = ForceHarm()
g_cos = GCos()
force_cos = ForceCos()
ni_g = NiG()
ni_force = NiForce()
ni_g_tiles = NiGTiles()
ni_force_tiles = NiForceTiles()
ni_force_tiles_sum = NiForceTilesSum()


# every kernel wrapper of this module, by name
WRAPPERS = ("g_harm", "force_harm", "g_cos", "force_cos", "ni_g", "ni_force",
            "ni_g_tiles", "ni_force_tiles", "ni_force_tiles_sum")


def reset_launch_counts():
    for name in WRAPPERS:
        globals()[name].launches = 0
