"""PyTorch/CUDA port of the meng_zhang_tpu MD engine for one NVIDIA H100.

The JAX package `meng_zhang_tpu` stays the reference; this package mirrors
its layout (`system/`, `models/`, `ops/`, `md/`) and imports only torch,
numpy and the framework-free modules of the reference package
(`units`, `io.potential`, `io.lammps_data`, `geometry.lattice`).

The fe Chebyshev-ANNP main path runs here: cell-list skin list ->
refresh-static short list -> harmonic descriptor kernel -> MLP + VJP ->
harmonic force kernel -> index_add delivery -> NHC/MTK NPT step. The two
per-pair kernels are hand-written CUDA (`ops/csrc/annp_harm.cu`, bound in
`ops/kernels.py`); on CPU tensors their plain PyTorch versions run.
"""
