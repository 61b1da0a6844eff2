"""Potentials from the seed: a configuration's network, made by the
generator its reference module holds (`make_potential`), as a plain dict
that both sides are handed. The shipped .ann files are not in the
repository, so the generators draw weights of the shipped shapes around a
stable perfect lattice (the two-hidden-layer wells of the synthetic
potentials); the configuration's `potential_seed` fixes the function, and
the run's seed the order of the hidden units, which leaves the function
as it is and changes the order of every sum over them."""
from __future__ import annotations

import numpy as np

from . import found


def paired_wells(rng, g0n, nnod, v_scale):
    """Weights of a two-hidden-layer network whose energy has a stable
    minimum at the normalised descriptors g0n: first-layer units in pairs
    z = +-v.(g - g0) + c, c < 0, an even well in v.g of bounded depth;
    second-layer units weigh both units of a pair alike with weights >= 0
    and the output weights are positive."""
    if nnod % 2:
        raise ValueError("nnod must be even (first-layer units in pairs)")
    nsf = len(g0n)
    npair = nnod // 2
    v = v_scale * rng.normal(size=(npair, nsf)) / np.sqrt(nsf)
    c = -rng.uniform(0.5, 1.5, npair)
    w1 = np.empty((nnod, nsf))
    w1[0::2], w1[1::2] = v, -v
    b1 = np.empty(nnod)
    b1[0::2], b1[1::2] = c - v @ g0n, c + v @ g0n
    w2 = np.repeat(rng.uniform(0.0, 0.5, (nnod, npair)), 2, axis=1)
    w3 = np.abs(rng.normal(size=(1, nnod))) / np.sqrt(nnod)
    return [w1, w2, w3], [b1, 0.1 * rng.normal(size=nnod), np.zeros(1)]


def permuted(pot, seed):
    """pot with its hidden units in an order drawn from seed (the same
    function); a potential with no network (no `weights`) as it is."""
    if "weights" not in pot:
        return dict(pot)
    rng = np.random.default_rng(seed)
    (w1, w2, w3), (b1, b2, b3) = pot["weights"], pot["biases"]
    p1, p2 = rng.permutation(len(b1)), rng.permutation(len(b2))
    out = dict(pot)
    out["weights"] = [w1[p1], w2[p2][:, p1], w3[:, p2]]
    out["biases"] = [b1[p1], b2[p2], b3]
    return out


def build(config, seed, device):
    """The configuration's potential, hidden units ordered by seed."""
    return permuted(canonical(config, device), seed)


def canonical(config, device):
    """The configuration's potential, hidden units in the generator's
    order."""
    pot = found.load("reference", config["reference"]).make_potential(
        config, device)
    pot["element"] = config["element"]
    return pot
