"""Tiny per-atom MLPs with the reference's activation table.

Counterpart of meng_zhang_tpu/models/mlp.py (`activation`, `mlp_apply`).
Flags: 0 linear, 1 tanh, 2 sigmoid 1/(1+exp(+x)) (the reference's sign
quirk, kept), 3 and 4 the style-dependent modified tanh -- FE style is
1.7159*tanh(2x/3) (flag 3) and 1.7159*tanh(2x/3) + 0.1x (flag 4).
"""
from __future__ import annotations

import torch

from ..io.potential import ActivationStyle

_FE_A = 1.7159
_FE_B = 0.666666666666667
_FE_C = 0.1
_ANNA_A = 1.7
_ANNA_B = 0.3


def activation(x, flag: int, style: str):
    if flag == 0:
        return x
    if flag == 1:
        return torch.tanh(x)
    if flag == 2:
        return 1.0 / (1.0 + torch.exp(x))
    if style == ActivationStyle.FE:
        if flag == 3:
            return _FE_A * torch.tanh(_FE_B * x)
        return _FE_A * torch.tanh(_FE_B * x) + _FE_C * x
    if style == ActivationStyle.ANNA:
        return _ANNA_A * torch.tanh(_ANNA_B * x)
    return torch.tanh(x)          # ni: flags 3 and 4 are plain tanh


def mlp_apply(weights, biases, flagact, style, g):
    """weights[l] [n_out, n_in], biases[l] [n_out]; g [..., nsf]."""
    h = g
    for w, b, flag in zip(weights, biases, flagact):
        h = activation(torch.matmul(h, w.transpose(-1, -2)) + b, flag, style)
    return h
