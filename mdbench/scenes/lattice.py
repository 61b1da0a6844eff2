"""A perfect cubic lattice: spec["lattice"] ("bcc" or "fcc") of
spec["cells"] cells a side, of the configuration's lattice constant."""
from mdbench.lattice import lattice


def build(spec, config, device):
    return lattice(spec["lattice"], spec["cells"], config["lattice_A"])
