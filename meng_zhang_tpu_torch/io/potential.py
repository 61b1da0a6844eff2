"""The parsed form of a reference `.ann` potential file (numpy only).

Counterpart of the data classes of meng_zhang_tpu/io/potential.py (:49-129):
the activation and descriptor flags, `ActivationStyle`, `NetworkParams` and
`AnnpPotential` with its normalisation (`sf_scale`, `sf_shift`). The `.ann`
readers are not ported; the port builds its potentials in memory
(meng_zhang_tpu_torch/testing.py). The JAX package's `make_annp` reads a
potential's attributes only, so it takes an `AnnpPotential` of either
package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Activation flags (shared across all reference variants,
# fe/src/pair_annp.cpp:410-414):
ACT_LINEAR = 0     # "li*"
ACT_TANH = 1       # "hy*" (hyperbolic)
ACT_SIGMOID = 2    # "si*"  -- NOTE: reference computes 1/(1+exp(+x))
ACT_MTANH = 3      # "mo*" (modified tanh)
ACT_TTANH = 4      # "ta*" (tanh with optional linear twist)

# Descriptor family flags (fe/src/pair_annp.cpp:406-408)
SYM_CHEBYSHEV = 0  # "Ch*"
SYM_BEHLER = 1     # "Be*" / "BP*"
SYM_CUSTOM = 2     # "Cu*"


class ActivationStyle:
    """Coefficient sets for activation flags 3/4 differ per reference variant."""
    FE = "fe"      # flag3: 1.7159*tanh(2x/3); flag4: 1.7159*tanh(2x/3)+0.1x (fe/src/pair_annp.cpp:699-727)
    NI = "ni"      # flag3 and flag4 are plain tanh (ni/src/pair_annp.cpp:~800)
    ANNA = "anna"  # flag3/flag4: 1.7*tanh(0.3x) (pair_anna_adp.cpp:695-717)


@dataclasses.dataclass(frozen=True)
class NetworkParams:
    """Per-element MLP: weights[l] has shape [n_out, n_in], biases[l] [n_out]."""
    weights: tuple
    biases: tuple
    flagact: tuple          # activation flag per layer
    act_style: str          # one of ActivationStyle

    @property
    def n_layers(self) -> int:
        return len(self.weights)


@dataclasses.dataclass(frozen=True)
class AnnpPotential:
    """Parsed `.ann` file (both the fe/fe_v2 Chebyshev and ni BP flavors)."""
    elements: tuple
    masses: np.ndarray        # [ne]
    ntl: int                  # total layers (incl. input & output)
    nhl: int
    nnod: int
    nsf: int
    npsf: int
    ntsf: int
    cut: float                # neighbor-list cutoff [A]
    flagsym: int
    norm_row0: np.ndarray     # [nsf] raw first normalization row
    norm_row1: np.ndarray     # [nsf] raw second normalization row
    norm_style: str           # "gaussian" (fe) or "minmax" (ni)
    e_scale: float
    e_shift: float
    e_atom: float
    networks: tuple           # NetworkParams per element
    sym_coerad: np.ndarray | None   # [npsf, 3] (eta, rs, Rc_bohr) or None
    sym_coeang: np.ndarray | None   # [ntsf, 4] (eta, lambda, zeta, Rc_bohr) or None

    @property
    def sf_scale(self) -> np.ndarray:
        """Multiplicative normalization: G_norm = (G_raw - sf_shift) * sf_scale.

        fe: scale = 1/sqrt(cov - avg^2), zeroed when degenerate
        (fe/src/pair_annp.cpp:98-108); ni: scale = 1/(max - min)
        (ni/src/pair_annp.cpp:97-99,168-170).
        """
        if self.norm_style == "gaussian":
            var = self.norm_row0 - self.norm_row1 ** 2
            scale = np.zeros_like(var)
            ok = var > 1.0e-20
            scale[ok] = 1.0 / np.sqrt(var[ok])
            scale[np.sqrt(np.maximum(var, 0.0)) <= 1.0e-10] = 0.0
            return scale
        span = self.norm_row1 - self.norm_row0
        return 1.0 / span

    @property
    def sf_shift(self) -> np.ndarray:
        return self.norm_row1 if self.norm_style == "gaussian" else self.norm_row0
