"""The symmetric-tilt grain-boundary bicrystal of the reference's
symmetry_tilt_grain_boundary/{stgb.cpp,stgb_b.cpp} (BASELINE config 5):
grain 1 an oriented bcc crystal clipped to [0, Lx] with a +-1 A tolerance
on x, grain 2 its mirror x -> 2 Lx - x, the box doubled in x, and grain 2's
atoms within spec["delete_overlap"] A of a grain-1 atom deleted (LAMMPS
`delete_atoms overlap`)."""
import numpy as np
import torch

ORIENT = ((-1, 1, -2), (1, -1, -1), (1, 1, 0))
BCC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])


def oriented(orient, length, a):
    """bcc sites in [0, L) rotated so the rows of `orient` lie along the
    box axes, seeded at the box corner and rotated about its centre."""
    r = np.asarray(orient, np.float64)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    half = length / 2.0
    reach = int(np.ceil(np.linalg.norm(half) / a)) + 2
    span = np.arange(-reach, reach + 1)
    cells = np.stack(np.meshgrid(span, span, span, indexing="ij"),
                     -1).reshape(-1, 3)
    pts = (cells[:, None, :] + BCC[None]).reshape(-1, 3) * a - half
    x = pts @ r.T + half
    eps = 1e-6
    keep = ((x[:, 0] >= -1.0 - eps) & (x[:, 0] < length[0] + 1.0 - eps)
            & (x[:, 1] >= -eps) & (x[:, 1] < length[1] - eps)
            & (x[:, 2] >= -eps) & (x[:, 2] < length[2] - eps))
    return x[keep]


def prune(keep, cand, r_min, box, device):
    """cand without the atoms within r_min of an atom of keep (periodic),
    checked near the two boundary planes, where alone they can meet."""
    lx = box[0] / 2.0
    margin = r_min + 1.0

    def near(p):
        return (np.abs(p[:, 0] - lx) < margin) | (p[:, 0] < margin) \
            | (p[:, 0] > box[0] - margin)

    k = torch.tensor(keep[near(keep)], device=device)
    ci = np.nonzero(near(cand))[0]
    c = torch.tensor(cand[ci], device=device)
    b = torch.tensor(box, device=device)
    hit = torch.zeros(len(ci), dtype=torch.bool, device=device)
    for i0 in range(0, len(ci), 256):
        d = c[i0:i0 + 256, None, :] - k[None, :, :]
        d -= b * torch.round(d / b)
        hit[i0:i0 + 256] = ((d * d).sum(-1) < r_min * r_min).any(1)
    drop = np.zeros(len(cand), bool)
    drop[ci[hit.cpu().numpy()]] = True
    return cand[~drop]


def build(spec, config, device):
    length = np.asarray(spec["length_box"], np.float64)
    x1 = oriented(ORIENT, length, config["lattice_A"])
    x2 = x1.copy()
    x2[:, 0] = 2.0 * length[0] - x2[:, 0]
    box = np.array([2.0 * length[0], length[1], length[2]])
    x2 = prune(x1, x2, spec["delete_overlap"], box, device)
    return np.concatenate([x1, x2]), box
