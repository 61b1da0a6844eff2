"""The short-list compaction: `kernels.compact_short` (csrc/short_list.cu)
against its plain twin `fused_annp.compact_short_plain`.

The kernel keeps each skin row's partners within rc_s in the row's order;
the plain version sorts the masked keys. The two agree because every
neighbor-list build writes its rows ascending by partner id, padded with
the sentinel: the tests assert that of the list builds
(`build_neighbors_cell`, `build_neighbors_cell_rowsweep`,
`build_neighbors_n2`, `build_neighbors_images`), and that an in-order
prefix of the in-range lanes equals the plain version's rows. Rows in
another order keep their order on the card: the same partners as the
plain version's, not sorted. The kernel is held to the plain version bit for bit (ids,
padding, overflow, the counters), so its geometry has to round as the
eager torch ops do, including how torch compares a tensor with a Python
scalar (rounded to the tensor's dtype), which one CPU and one card test
check.

The tests marked `cuda` skip without an NVIDIA GPU; on a machine with one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_short_list.py
"""
import numpy as np
import pytest
import torch

from meng_zhang_tpu_torch import profiling
from meng_zhang_tpu_torch.models.annp import image_shift_table
from meng_zhang_tpu_torch.ops import fused_annp as fa
from meng_zhang_tpu_torch.ops import fused_ni as fn
from meng_zhang_tpu_torch.ops import kernels
from meng_zhang_tpu_torch.system.cell import image_table
from meng_zhang_tpu_torch.system.neighbors import (
    build_neighbors_cell, build_neighbors_cell_rowsweep,
    build_neighbors_images, build_neighbors_n2, cell_grid_dims)
from meng_zhang_tpu_torch.testing import thermal_bcc, thermal_fcc
from torch_port_util import cuda_device  # noqa: F401  (fixture)
from torch_port_util import reduced_ni_potential, reduced_potential

PERIODIC = (True, True, True)
MIXED = (True, True, False)

# name: (list build, skin cutoff, K = capacity, rc_s, pbc). K 64: the ni
# cell's fcc at Rc + skin (its third shell, 4.31 A, straddles rc_s); K 192:
# the fe cells' bcc at rc + skin (the row sweep's cells of 54 atoms with
# a free z); K 640: rows of ~560 partners, the wide-row route's Ks = K;
# images: a 2-cell thin z over x_ext
SCENES = {
    "cell-k64": ("cell", 4.6, 64, 4.3, PERIODIC),
    "rowsweep-k192-mixed": ("rowsweep", 7.7, 192, 6.9, MIXED),
    "n2-k192-mixed": ("n2", 7.7, 192, 6.9, MIXED),
    "n2-k640": ("n2", 12.0, 640, 11.6, PERIODIC),
    "images-k192": ("images", 7.2, 192, 6.9, PERIODIC),
}


def scene(name, dtype, device):
    """(x, box, built, idx, x_ext, rc_s, pbc): `built` the skin list of
    SCENES[name] built on `device` in `dtype`, idx a copy with two rows
    changed: row 0 all filler, row 1 its own atom alone (a real lane that
    is never kept: an empty row)."""
    kind, cut, cap, rc_s, pbc = SCENES[name]
    if kind == "cell":
        xn, boxn = thermal_fcc(6, seed=3, disp=0.12)
    elif kind == "images":
        xn, boxn = thermal_bcc((9, 9, 2), seed=4)
    else:
        xn, boxn = thermal_bcc(9, seed=5)
    x = torch.as_tensor(xn, dtype=dtype, device=device)
    box = torch.as_tensor(boxn, dtype=dtype, device=device)
    x_ext = None
    if kind == "cell":
        nb = build_neighbors_cell(x, box, cut, cap,
                                  cell_grid_dims(boxn, cut), 24, pbc=pbc)
    elif kind == "rowsweep":
        nb = build_neighbors_cell_rowsweep(x, box, cut, cap,
                                           cell_grid_dims(boxn, cut), 96,
                                           pbc=pbc)
    elif kind == "n2":
        nb = build_neighbors_n2(x, box, cut, cap, pbc)
    else:
        shifts, pbc = image_shift_table(boxn, cut, pbc)
        shifts = torch.as_tensor(shifts, device=device)
        x_ext = image_table(x, box, shifts)
        nb = build_neighbors_images(x, box, shifts, cut, cap, pbc)
    assert not bool(nb.overflow)
    idx = nb.idx.clone()
    m = len(x) if x_ext is None else len(x_ext)
    idx[0] = m
    idx[1] = m
    idx[1, 0] = 1
    return x, box, nb.idx, idx, x_ext, rc_s, pbc


def assert_ascending(idx, m):
    """Rows ascending by partner id, each real id once, the sentinel m
    only after them."""
    idx = idx.cpu()
    a, b = idx[:, :-1], idx[:, 1:]
    assert bool(((b > a) | (b == m)).all())
    assert bool(((a < m) | (b == m)).all())
    assert bool((idx <= m).all()) and bool((idx >= 0).all())


def widths(x, box, idx, rc_s, pbc, x_ext):
    """(Ks below (an overflow), equal to and above the widest row's count
    of partners within rc_s (the last also above K), that count)."""
    full = fa.compact_short_plain(x, box, idx, rc_s, idx.shape[1], pbc,
                                  x_ext=x_ext).sidx
    m = len(x) if x_ext is None else len(x_ext)
    top = int((full < m).sum(1).max())
    return (top - 3, top, idx.shape[1] + 8), top


def in_order_prefix(x, box, idx, rc_s, ks, pbc, x_ext=None):
    """The kernel's rule in plain torch: each row's lanes within rc_s in
    the row's order, the first Ks of them, padded with the sentinel."""
    m = len(x) if x_ext is None else len(x_ext)
    dx = fa.pair_dx_planes(x, box, idx, pbc, x_ext=x_ext)
    rsq = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
    keep = (rsq < rc_s * rc_s) & (rsq > 1.0e-12)
    out = torch.full((len(x), ks), m, dtype=torch.int64)
    for i in range(len(x)):
        ids = idx[i][keep[i]][:ks]
        out[i, :len(ids)] = ids
    return out, bool((keep.sum(1) > ks).any())


def counted(fn_, *args, **kw):
    """(fn_(*args, **kw), {counter: value}) with tracing on."""
    profiling.reset()
    profiling.enable()
    try:
        out = fn_(*args, **kw)
        return out, profiling.counts()
    finally:
        profiling.enable(False)
        profiling.reset()


def scalar_threshold():
    """A squared radius t whose float32 rounding lies below it, and v, that
    rounding as a float32 tensor: v < t holds in exact arithmetic and fails
    in float32."""
    for r in np.arange(4.0, 12.0, 0.01):
        t = float(r) * float(r)
        v = torch.tensor([t], dtype=torch.float32)
        if float(v) < t:
            return t, v
    raise AssertionError("no threshold rounds down")


# ----------------------------------------------------------------- CPU
@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_list_builds_write_ascending_rows_and_order_keeps_the_sort(name,
                                                                   dtype):
    """The list builds' rows are ascending, so the kernel's rule (an in-order
    prefix of the in-range lanes) gives the plain version's sorted rows,
    at Ks below, equal to and above the widest row's count."""
    x, box, built, idx, x_ext, rc_s, pbc = scene(name, dtype, "cpu")
    m = len(x) if x_ext is None else len(x_ext)
    assert_ascending(built, m)
    sizes, top = widths(x, box, idx, rc_s, pbc, x_ext)
    for ks in sizes:
        want = fa.compact_short_plain(x, box, idx, rc_s, ks, pbc,
                                      x_ext=x_ext)
        got, ovf = in_order_prefix(x, box, idx, rc_s, ks, pbc, x_ext)
        assert torch.equal(got, want.sidx)
        assert ovf == bool(want.overflow) == (ks < top)
        assert bool((want.sidx[0] == m).all())
        assert bool((want.sidx[1] == m).all())


def test_cpu_and_plain_evaluators_take_compact_short_plain(monkeypatch):
    """CPU tensors (any evaluator) and plain=True take compact_short_plain,
    which launches nothing; the counters read the same through every
    route."""
    x, box, _, idx, _, rc_s, pbc = scene("cell-k64", torch.float64, "cpu")
    calls = []
    plain = fa.compact_short_plain

    def spy(*a, **kw):
        calls.append(a[4])
        return plain(*a, **kw)
    monkeypatch.setattr(fa, "compact_short_plain", spy)
    from meng_zhang_tpu_torch.models.annp import make_annp
    cfg, params = make_annp(reduced_potential(cut=rc_s - 0.4), torch.float64,
                            device="cpu")
    ncfg, nparams = make_annp(reduced_ni_potential(), torch.float64,
                              device="cpu")
    kernels.compact_short.launches = 0
    routes = {
        "fused_annp.compact_short":
            lambda: fa.compact_short(x, box, idx, rc_s, 64, pbc),
        "kernels.compact_short":
            lambda: kernels.compact_short(x, box, idx, rc_s, 64, pbc),
        "FusedAnnp": lambda: fa.FusedAnnp(cfg, params, k_short=64,
                                          short_delta=0.4)
        .compact_short(x, box, idx),
        "FusedAnnp(plain=True)": lambda: fa.FusedAnnp(
            cfg, params, k_short=64, short_delta=0.4, plain=True)
        .compact_short(x, box, idx),
    }
    ref, ref_counts = counted(plain, x, box, idx, rc_s, 64, pbc)
    assert ref_counts["nbr.shorts"] == 1
    assert ref_counts["nbr.short_slots"] == len(x) * 64
    assert ref_counts["nbr.short_lanes"] == int((ref.sidx < len(x)).sum())
    for route, call in routes.items():
        got, cts = counted(call)
        assert torch.equal(got.sidx, ref.sidx), route
        assert cts == ref_counts, route
    for ev in (fn.FusedNi(ncfg, nparams, k_short=16),
               fn.FusedNi(ncfg, nparams, k_short=16, plain=True)):
        got = ev.compact_short(x, box, idx)
        assert got.sidx.shape == (len(x), 16)
    assert len(calls) == len(routes) + 2
    assert kernels.compact_short.launches == 0


def test_cpu_scalar_compare_rounds_to_dtype():
    """torch compares a float32 tensor with a Python scalar rounded to
    float32 (the kernel rounds rc_s^2 and 1e-12 so)."""
    t, v = scalar_threshold()
    assert not bool(v < t)
    assert bool(v.double() < t)


# ---------------------------------------------------------------- card
@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    """int32 ids, a skin list of other rows than x's and half positions
    raise ValueError on the card."""
    x, box, _, idx, _, rc_s, pbc = scene("cell-k64", torch.float32,
                                         cuda_device)
    with pytest.raises(ValueError):
        kernels.compact_short(x, box, idx.int(), rc_s, 64, pbc)
    with pytest.raises(ValueError):
        kernels.compact_short(x, box, idx[1:], rc_s, 64, pbc)
    with pytest.raises(ValueError):
        kernels.compact_short(x.half(), box, idx, rc_s, 64, pbc)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_is_the_plain_version_bit_for_bit(cuda_device, name, dtype):
    """Skin lists built on the card; Ks below (overflowing rows), equal to
    and above the widest row's count; the box on the card and on the host;
    ids, padding, overflow and counters equal to compact_short_plain's on
    the card and on the CPU."""
    x, box, built, idx, x_ext, rc_s, pbc = scene(name, dtype, cuda_device)
    m = len(x) if x_ext is None else len(x_ext)
    assert_ascending(built, m)
    kernels.reset_launch_counts()
    calls = 0
    sizes, top = widths(x, box, idx, rc_s, pbc, x_ext)
    for ks in sizes:
        for b in (box, tuple(float(v) for v in box.cpu())):
            want, want_counts = counted(fa.compact_short_plain, x, b, idx,
                                        rc_s, ks, pbc, x_ext=x_ext)
            got, got_counts = counted(fa.compact_short, x, b, idx, rc_s, ks,
                                      pbc, x_ext=x_ext)
            calls += 1
            assert got.sidx.dtype == torch.int64
            assert torch.equal(got.sidx, want.sidx), (ks, type(b))
            assert bool(got.overflow) == bool(want.overflow) == (ks < top)
            assert got_counts == want_counts
            assert got_counts["nbr.shorts"] == 1
            assert got.ref_x is x
        cpu = fa.compact_short_plain(
            x.cpu(), box.cpu(), idx.cpu(), rc_s, ks, pbc,
            x_ext=None if x_ext is None else x_ext.cpu())
        assert torch.equal(got.sidx.cpu(), cpu.sidx)
        assert bool(got.overflow) == bool(cpu.overflow)
    assert kernels.compact_short.launches == calls


@pytest.mark.cuda
def test_any_layout_gives_the_plain_rows(cuda_device):
    """Column-major positions and a skin list that is a view of a wider
    one (the kernel takes row-major copies) give the plain version's
    rows."""
    x, box, _, idx, _, rc_s, pbc = scene("cell-k64", torch.float32,
                                         cuda_device)
    x_f = x.t().contiguous().t()
    wide = torch.cat([idx, idx], dim=1)[:, :idx.shape[1]]
    assert not x_f.is_contiguous() and not wide.is_contiguous()
    want = fa.compact_short_plain(x, box, idx, rc_s, 48, pbc)
    got = fa.compact_short(x_f, box, wide, rc_s, 48, pbc)
    assert torch.equal(got.sidx, want.sidx)
    assert bool(got.overflow) == bool(want.overflow)


@pytest.mark.cuda
def test_one_refresh_is_one_launch_and_no_sync(cuda_device):
    """On the card a refresh is one launch of the kernel and the overflow
    flag's memset: no sort, no loop over row chunks, no host read; with
    tracing on, the launch count follows nbr.shorts."""
    x, box, _, idx, _, rc_s, pbc = scene("n2-k192-mixed", torch.float32,
                                         cuda_device)
    fa.compact_short(x, box, idx, rc_s, 160, pbc)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                fa.compact_short(x, box, idx, rc_s, 160, pbc)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "memset" not in e.name.lower()]
    assert len(names) == 3 and all("compact_short" in n for n in names), \
        names
    assert kernels.compact_short.launches == 3
    _, counts = counted(lambda: [fa.compact_short(x, box, idx, rc_s, 160,
                                                  pbc) for _ in range(2)])
    assert kernels.compact_short.launches == 5 and counts["nbr.shorts"] == 2


@pytest.mark.cuda
def test_rows_in_another_order_keep_it(cuda_device):
    """The kernel's precondition: rows that are not ascending (here each
    row's real lanes reversed) give the plain version's partners in the
    row's own order, its sorted rows once sorted."""
    x, box, _, idx, _, rc_s, pbc = scene("n2-k192-mixed", torch.float32,
                                         cuda_device)
    m = len(x)
    real = (idx < m).sum(1, keepdim=True)
    lane = torch.arange(idx.shape[1], device=idx.device)[None, :]
    flipped = torch.where(lane < real,
                          idx.gather(1, (real - 1 - lane).clamp(min=0)), m)
    got = fa.compact_short(x, box, flipped, rc_s, 160, pbc)
    want, _ = in_order_prefix(x.cpu(), box.cpu(), flipped.cpu(), rc_s, 160,
                              pbc)
    assert torch.equal(got.sidx.cpu(), want)
    plain = fa.compact_short_plain(x, box, idx, rc_s, 160, pbc)
    assert torch.equal(torch.sort(got.sidx, dim=1).values, plain.sidx)


@pytest.mark.cuda
def test_card_scalar_compare_rounds_to_dtype(cuda_device):
    """On the card too, torch compares a float32 tensor with a Python
    scalar rounded to float32, as the kernel compares rsq with rc_s^2."""
    t, v = scalar_threshold()
    vd = v.to(cuda_device)
    assert not bool(vd < t)
    assert bool(vd.double() < t)
