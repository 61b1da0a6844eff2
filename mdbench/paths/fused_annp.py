"""The fe main path: FusedAnnp's harmonic short path (g_harm, the MLP and
its VJP, force_harm, the index_add delivery) over compact_short's rows."""


def evaluator(mcfg, params, wl):
    from meng_zhang_tpu_torch.ops.fused_annp import FusedAnnp
    return FusedAnnp(mcfg, params, k_short=wl["k_short"],
                     short_delta=wl["short_delta"], angular="harmonic")


def build(pot, wl, device):
    from mdbench import annp
    return annp.Side(pot, wl, device, evaluator)
