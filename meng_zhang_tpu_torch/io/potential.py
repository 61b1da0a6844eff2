"""Parsers and writer of the reference `.ann` / `.anna` potential files
(numpy only).

Counterpart of meng_zhang_tpu/io/potential.py, a copy of its numpy code:
the activation and descriptor flags, `ActivationStyle`, `NetworkParams`,
`AnnpPotential` with its normalisation (`sf_scale`, `sf_shift`) and
`AnnaPotential` (:49-187); `_parse_act_line` and `_read_network_sections`
(:193-273); `read_ann` (:276), `read_anna` (:335) and `write_ann` (:368).

The files are the reference framework's model-config schema: a fixed
line-offset header followed by `#<element>` / `#<n>_(weight|bias)`
sections of tab-separated numbers.

`.ann` (ANNP): reference reader annp-gpu-lammps/fe/src/pair_annp.cpp:325-508
  line 5 (0-based)     : nelements
  lines 6..6+ne        : "<id>\t<element>\t<mass>"
  line 8+ne            : "ntl nhl nnod nsf npsf ntsf cut"
  lines 11+ne..12+ne   : two normalization rows over nsf symmetry functions
                         (fe: covariance & mean -> scale = 1/sqrt(cov-avg^2);
                          ni: min & max -> scale = 1/(max-min))
  line 15+ne           : descriptor + activation names, by 2-letter prefix
  lines 18+ne..20+ne   : e_scale, e_shift, e_atom
  then weight/bias sections; the ni file appends a
  "#coefficent of symmetry funciton" trailer with per-function
  (eta, rs, Rc) radial and (eta, lambda, zeta, Rc) angular rows.

`.anna` (ANNA-ADP): reference reader
  anna-gpu-lammps/bcc_fe/src/pair_anna_adp.cpp:392-562. The header adds
  `nout` (line 8+ne has 8 numbers), has no normalization rows, and carries
  `e_base e_scale` (line 14+ne) plus ngp = 17 global ADP parameters on
  line 18+ne.

The JAX package's `make_annp` reads a potential's attributes only, so it
takes an `AnnpPotential` of either package.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np

# Activation flags (shared across all reference variants,
# fe/src/pair_annp.cpp:410-414):
ACT_LINEAR = 0     # "li*"
ACT_TANH = 1       # "hy*" (hyperbolic)
ACT_SIGMOID = 2    # "si*"  -- NOTE: reference computes 1/(1+exp(+x))
ACT_MTANH = 3      # "mo*" (modified tanh)
ACT_TTANH = 4      # "ta*" (tanh with optional linear twist)

_ACT_PREFIX = {"li": ACT_LINEAR, "hy": ACT_TANH, "si": ACT_SIGMOID,
               "mo": ACT_MTANH, "ta": ACT_TTANH}

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


@dataclasses.dataclass(frozen=True)
class AnnaPotential:
    """Parsed `.anna` file (ANNA-ADP physically-informed potential)."""
    elements: tuple
    masses: np.ndarray
    ntl: int
    nhl: int
    nnod: int
    nout: int
    nsf: int
    npsf: int
    ntsf: int
    cut: float
    flagsym: int
    e_base: float
    e_scale: float
    gparams: np.ndarray       # [17] global ADP parameters
    networks: tuple

    # Named accessors for the 17 global ADP parameters
    # (pair_anna_adp.cpp:98-101)
    @property
    def A0(self): return self.gparams[0]
    @property
    def yy(self): return self.gparams[1]
    @property
    def gamma(self): return self.gparams[2]
    @property
    def C0(self): return self.gparams[3]
    @property
    def c1F(self): return self.gparams[4]
    @property
    def c2F(self): return self.gparams[5]
    @property
    def V0(self): return self.gparams[6]
    @property
    def b1(self): return self.gparams[7]
    @property
    def b2(self): return self.gparams[8]
    @property
    def delta(self): return self.gparams[9]
    @property
    def r0(self): return self.gparams[10]
    @property
    def r1(self): return self.gparams[11]
    @property
    def hc(self): return self.gparams[12]
    @property
    def d1(self): return self.gparams[13]
    @property
    def q1(self): return self.gparams[14]
    @property
    def d3(self): return self.gparams[15]
    @property
    def q3(self): return self.gparams[16]


def _floats(line: str) -> list:
    return [float(t) for t in line.split()]


def _parse_act_line(line: str, n_layers: int):
    """Descriptor-family + per-layer activation flags from the names line.

    The reference scans 2-character windows over the raw line
    (fe/src/pair_annp.cpp:400-416); token-prefix matching is equivalent for
    well-formed files ("Chebyshev tanh tanh linear" -> sym=0, flags [4,4,0]).
    """
    flagsym = None
    flags = []
    for tok in line.split():
        if tok[:2] == "Ch":
            flagsym = SYM_CHEBYSHEV
        elif tok[:2] in ("Be", "BP"):
            flagsym = SYM_BEHLER
        elif tok[:2] == "Cu":
            flagsym = SYM_CUSTOM
        else:
            p = tok[:2].lower()
            if p in _ACT_PREFIX:
                flags.append(_ACT_PREFIX[p])
    if flagsym is None or len(flags) != n_layers:
        raise ValueError(
            f"cannot parse descriptor/activation line {line!r}: "
            f"got sym={flagsym}, {len(flags)} activation flags, expected {n_layers}")
    return flagsym, tuple(flags)


def _read_network_sections(lines, start, ne, n_layers, nnod, nsf, nout,
                           elements, flagact, act_style):
    """Parse the `#<element>` / `#<n>_(weight|bias)` trailer into NetworkParams.

    Layer l=0: weight [nnod, nsf]; layers 1..n_layers-2: [nnod, nnod];
    final layer: [nout, nnod] with bias [nout]
    (fe/src/pair_annp.cpp:470-477; nout sizing pair_anna_adp.cpp:528-531).
    """
    weights = {e: [None] * n_layers for e in range(ne)}
    biases = {e: [None] * n_layers for e in range(ne)}
    cur_elem = 0
    i = start
    sec_re = re.compile(r"#(\d+)_\((weight|bias)\)")
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("#") and len(line) > 1 and line[1].isupper():
            name = line[1:].strip()
            if name in elements:
                cur_elem = elements.index(name)
            i += 1
            continue
        m = sec_re.match(line)
        if not m:
            i += 1
            continue
        layer = int(m.group(1)) - 1
        is_bias = m.group(2) == "bias"
        n_out = nnod if layer < n_layers - 1 else nout
        n_in = nsf if layer == 0 else nnod
        n_rows = 1 if is_bias else n_out
        rows = []
        for r in range(n_rows):
            i += 1
            rows.append(_floats(lines[i]))
        arr = np.asarray(rows, dtype=np.float64)
        if is_bias:
            # bias rows hold nnod entries even for the final layer; only the
            # first n_out are used (reference allocates [1][nnod] and the
            # final layer reads bias[0][0..nout), pair_annp.cpp:470-505)
            biases[cur_elem][layer] = arr[0, :n_out]
        else:
            if arr.shape != (n_out, n_in):
                raise ValueError(
                    f"layer {layer + 1} weight shape {arr.shape} != {(n_out, n_in)}")
            weights[cur_elem][layer] = arr
        i += 1

    nets = []
    for e in range(ne):
        if any(w is None for w in weights[e]) or any(b is None for b in biases[e]):
            raise ValueError(f"missing weight/bias sections for element {elements[e]}")
        nets.append(NetworkParams(tuple(weights[e]), tuple(biases[e]),
                                  tuple(flagact), act_style))
    return tuple(nets)


def read_ann(path: str, act_style: str | None = None) -> AnnpPotential:
    """Parse a `.ann` ANNP potential file (fe, fe_v2 or ni flavor)."""
    with open(path) as f:
        lines = f.read().splitlines()

    ne = int(lines[5].split()[0])
    elements, masses = [], []
    for k in range(ne):
        toks = lines[6 + k].split()
        elements.append(toks[1])
        masses.append(float(toks[2]))
    hdr = lines[8 + ne].split()
    ntl, nhl, nnod, nsf, npsf, ntsf = (int(x) for x in hdr[:6])
    cut = float(hdr[6])
    n_layers = ntl - 1

    norm_row0 = np.asarray(_floats(lines[11 + ne]), dtype=np.float64)
    norm_row1 = np.asarray(_floats(lines[12 + ne]), dtype=np.float64)
    if norm_row0.shape != (nsf,) or norm_row1.shape != (nsf,):
        raise ValueError("normalization rows do not match nsf")
    # fe labels the rows "(sfval_cov sfval_avg)"; ni "(sf_min sf_max)"
    label = lines[10 + ne].lower()
    norm_style = "minmax" if ("min" in label or "max" in label) else "gaussian"

    flagsym, flagact = _parse_act_line(lines[15 + ne], n_layers)
    e_scale = float(lines[18 + ne].split()[0])
    e_shift = float(lines[19 + ne].split()[0])
    e_atom = float(lines[20 + ne].split()[0])

    # Optional ni-style symmetry-function coefficient trailer
    # (ni/src/pair_annp.cpp:444-545): "#rad" then npsf rows "<el> eta rs Rc",
    # "#angl" then ntsf rows "<el> <el> eta lambda zeta Rc".
    sym_coerad = sym_coeang = None
    for i, line in enumerate(lines):
        if line.startswith("#rad"):
            sym_coerad = np.asarray(
                [_floats(" ".join(lines[i + 1 + r].split()[1:]))
                 for r in range(npsf)], dtype=np.float64)
        if line.startswith("#angl"):
            sym_coeang = np.asarray(
                [_floats(" ".join(lines[i + 1 + r].split()[2:]))
                 for r in range(ntsf)], dtype=np.float64)
    if sym_coerad is not None and sym_coerad.shape != (npsf, 3):
        raise ValueError("bad radial coefficient table")
    if sym_coeang is not None and sym_coeang.shape != (ntsf, 4):
        raise ValueError("bad angular coefficient table")

    if act_style is None:
        act_style = ActivationStyle.NI if sym_coerad is not None else ActivationStyle.FE
    nets = _read_network_sections(lines, 21 + ne, ne, n_layers, nnod, nsf, 1,
                                  elements, flagact, act_style)
    return AnnpPotential(
        elements=tuple(elements), masses=np.asarray(masses), ntl=ntl, nhl=nhl,
        nnod=nnod, nsf=nsf, npsf=npsf, ntsf=ntsf, cut=cut, flagsym=flagsym,
        norm_row0=norm_row0, norm_row1=norm_row1, norm_style=norm_style,
        e_scale=e_scale, e_shift=e_shift, e_atom=e_atom, networks=nets,
        sym_coerad=sym_coerad, sym_coeang=sym_coeang)


def read_anna(path: str) -> AnnaPotential:
    """Parse a `.anna` ANNA-ADP potential file."""
    with open(path) as f:
        lines = f.read().splitlines()

    ne = int(lines[5].split()[0])
    elements, masses = [], []
    for k in range(ne):
        toks = lines[6 + k].split()
        elements.append(toks[1])
        masses.append(float(toks[2]))
    hdr = lines[8 + ne].split()
    ntl, nhl, nnod, nout, nsf, npsf, ntsf = (int(x) for x in hdr[:7])
    cut = float(hdr[7])
    n_layers = ntl - 1

    flagsym, flagact = _parse_act_line(lines[11 + ne], n_layers)
    etoks = _floats(lines[14 + ne])
    e_base, e_scale = etoks[0], etoks[1]
    ngp = int(lines[17 + ne].split()[0])
    gparams = np.asarray(_floats(lines[18 + ne]), dtype=np.float64)
    if gparams.shape != (ngp,):
        raise ValueError(f"expected {ngp} global ADP parameters, got {gparams.shape}")

    nets = _read_network_sections(lines, 19 + ne, ne, n_layers, nnod, nsf, nout,
                                  elements, flagact, ActivationStyle.ANNA)
    return AnnaPotential(
        elements=tuple(elements), masses=np.asarray(masses), ntl=ntl, nhl=nhl,
        nnod=nnod, nout=nout, nsf=nsf, npsf=npsf, ntsf=ntsf, cut=cut,
        flagsym=flagsym, e_base=e_base, e_scale=e_scale, gparams=gparams,
        networks=nets)


def write_ann(path: str, pot: AnnpPotential) -> None:
    """Write an AnnpPotential back to the `.ann` fixed-offset format."""
    act_names = {0: "linear", 1: "hyperbolic", 2: "sigmoid", 3: "modified", 4: "tanh"}
    sym_names = {0: "Chebyshev", 1: "Behler", 2: "Custom"}
    out = []
    out.append("#Generated by meng_zhang_tpu_torch")
    out.append("#")
    out.append("#")
    out.append("")
    out.append("#element parameters_(nelement #n element mass)")
    out.append(str(len(pot.elements)))
    for k, (el, m) in enumerate(zip(pot.elements, pot.masses)):
        out.append(f"{k + 1}\t{el}\t{m}")
    out.append("")
    out.append("#artificial neural network parameters_(TL HL Nodes_HL Num_SF Num_PSF Num_TSF Cut)")
    out.append(f"{pot.ntl}\t{pot.nhl}\t{pot.nnod}\t{pot.nsf}\t{pot.npsf}\t{pot.ntsf}\t{pot.cut}")
    out.append("")
    if pot.norm_style == "gaussian":
        out.append("#symmetry function normization_(sfval_cov sfval_avg)")
    else:
        out.append("#symmetry function normization_(sf_min sf_max)")
    out.append("\t".join(f"{v:.15g}" for v in pot.norm_row0))
    out.append("\t".join(f"{v:.15g}" for v in pot.norm_row1))
    out.append("")
    out.append("#types of symmetry function and activation function")
    out.append("\t".join([sym_names[pot.flagsym]] +
                         [act_names[f] for f in pot.networks[0].flagact]))
    out.append("")
    out.append("#energy scale_(E_scale E_shift E_atom)")
    out.append(f"{pot.e_scale:.17g}")
    out.append(f"{pot.e_shift:.17g}")
    out.append(f"{pot.e_atom:.17g}")
    out.append("")
    out.append("#weight_bias_matrix_(#1.....#TL)")
    for el, net in zip(pot.elements, pot.networks):
        out.append(f"#{el}")
        for l, (w, b) in enumerate(zip(net.weights, net.biases)):
            out.append(f"#{l + 1}_(weight)")
            for row in w:
                out.append("\t".join(f"{v:.17g}" for v in row))
            out.append(f"#{l + 1}_(bias)")
            # pad final-layer bias row to nnod entries like the reference files
            brow = list(b) + [0.0] * (pot.nnod - len(b))
            out.append("\t".join(f"{v:.17g}" for v in brow))
    if pot.sym_coerad is not None:
        el = pot.elements[0]
        out.append("")
        out.append("#coefficent of symmetry funciton")
        out.append(f"#rad\t{pot.npsf}")
        for row in pot.sym_coerad:
            out.append(el + "\t" + "\t".join(f"{v:.7f}" for v in row))
        out.append(f"#angl\t{pot.ntsf}")
        for row in pot.sym_coeang:
            out.append(el + "\t" + el + "\t" + "\t".join(f"{v:.7f}" for v in row))
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
