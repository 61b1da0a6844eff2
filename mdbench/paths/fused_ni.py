"""The ni main path: FusedNi (ni_g, the MLP and its VJP, ni_force, the
index_add delivery) over compact_short's rows at the descriptor cutoff."""


def evaluator(mcfg, params, wl):
    from meng_zhang_tpu_torch.ops.fused_ni import FusedNi
    return FusedNi(mcfg, params, k_short=wl["k_short"],
                   short_delta=wl["short_delta"])


def build(pot, wl, device):
    from mdbench import annp
    return annp.Side(pot, wl, device, evaluator)
