"""PyTorch/CUDA port of the meng_zhang_tpu MD engine for one NVIDIA H100.

The JAX package `meng_zhang_tpu` stays the reference; this package mirrors
its layout (`system/`, `models/`, `ops/`, `md/`) and imports only torch and
numpy. It keeps its own copies of the reference package's framework-free
modules it needs (`units`, `io.potential`, `geometry.lattice`). Its entry
points (`models.annp.make_annp`, `params_from_numpy`, the `md.integrate`
helpers) put tensors on the card unless the caller names another device.

The fe Chebyshev-ANNP main path runs here: cell-list skin list ->
refresh-static short list -> descriptor kernel -> MLP + VJP -> force
kernel -> index_add delivery -> NHC/MTK NPT step, through the harmonic
kernels (`ops/csrc/annp_harm.cu`) or the cos-matrix kernels
(`ops/csrc/annp_cos.cu`); the fcc-Ni Behler-Parrinello NVT path runs
through `ops/csrc/ni_bp.cu`. The kernels are hand-written CUDA bound in
`ops/kernels.py`; on CPU tensors their plain PyTorch versions run.
"""
