"""Checkpoint / restart.

Counterpart of meng_zhang_tpu/md/checkpoint.py (`save_checkpoint` :22,
`load_checkpoint` :31): positions, velocities, box, thermostat and
barostat variables, the step counter and the sticky flags in a compressed
.npz; the neighbor list, the model's short list and the forces are rebuilt
on load (:18-19, :33-53).

The JAX state holds a PRNG key (`key`) where the port's holds a
torch.Generator, which only the Langevin thermostat draws from. The port
saves the generator's state (`generator_state`, with the device type it
belongs to in `generator_device`). A checkpoint written by the JAX
package loads too: its key has no torch meaning, so the generator is
reseeded from the key's bytes, and a Langevin run says so on stderr; the
same holds for a generator state of another device type.
"""
from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from . import integrate as I
from .simulation import MDState

_FIELDS = ("x", "v", "box", "pe", "virial", "v_eps", "step", "overflow",
           "stale", "unsafe")


def save_checkpoint(path: str, state: MDState) -> None:
    data = {f: getattr(state, f).detach().cpu().numpy() for f in _FIELDS}
    data["nhc_xi"] = state.nhc.xi.cpu().numpy()
    data["nhc_vxi"] = state.nhc.v_xi.cpu().numpy()
    data["baro_xi"] = state.baro_nhc.xi.cpu().numpy()
    data["baro_vxi"] = state.baro_nhc.v_xi.cpu().numpy()
    data["generator_state"] = state.generator.get_state().numpy()
    data["generator_device"] = np.asarray(state.generator.device.type)
    np.savez_compressed(path, **data)


def _generator(z, simulator, dev):
    """The Langevin generator on `dev`: the saved state when it belongs to
    a generator of this device type, else reseeded from the saved bytes
    (a JAX key or another device's state)."""
    gen = torch.Generator(device=dev)
    saved = z["generator_state"] if "generator_state" in z else None
    if saved is not None and str(z["generator_device"]) == dev.type:
        gen.set_state(torch.as_tensor(saved, dtype=torch.uint8))
        return gen
    raw = np.asarray(saved if saved is not None else z["key"]).tobytes()
    seed = int.from_bytes(hashlib.sha256(raw).digest()[:8], "little") >> 1
    gen.manual_seed(seed)
    if simulator.cfg.ensemble == "langevin":
        what = ("a generator state of another device type" if saved is
                not None else "a JAX PRNG key")
        print(f"note: the checkpoint holds {what}; the Langevin noise "
              f"stream is reseeded with {seed}", file=sys.stderr, flush=True)
    return gen


def load_checkpoint(path: str, simulator) -> MDState:
    """Restore an MDState on the simulator's device; forces, the neighbor
    list and the model's short list are recomputed."""
    dev = simulator.masses.device
    with np.load(path) as z:
        def t(name, **kw):
            return torch.as_tensor(np.asarray(z[name]), device=dev, **kw)

        x, box = t("x"), t("box")
        nbrs = simulator.build_nbrs(x, box)
        short = None
        if simulator.short_build is not None:
            short = simulator.short_build(x, box, nbrs)
        pe, f, w = simulator._eval_force(x, box, nbrs, short)
        return MDState(
            x=x, v=t("v"), f=f, box=box, pe=pe, virial=w, nbrs=nbrs,
            nhc=I.NHCState(t("nhc_xi"), t("nhc_vxi")),
            v_eps=t("v_eps"),
            baro_nhc=I.NHCState(t("baro_xi"), t("baro_vxi")),
            generator=_generator(z, simulator, dev),
            step=t("step", dtype=torch.int64),
            overflow=t("overflow", dtype=torch.bool),
            stale=torch.zeros((), dtype=torch.bool, device=dev),
            unsafe=(t("unsafe", dtype=torch.bool) if "unsafe" in z
                    else torch.zeros((), dtype=torch.bool, device=dev)),
            short=short)
