"""Unit system and physical constants (counterpart of meng_zhang_tpu/units.py).

The engine works in LAMMPS "metal" units throughout: length in Angstrom,
energy in eV, time in ps, mass in g/mol, temperature in K, pressure in bar.

The Ni ANNP potential evaluates its descriptors and network in atomic units
internally (lengths in Bohr, energies in Hartree) and converts forces back to
eV/Angstrom; the conversion constants match the reference exactly
(ni/src/pair_annp.h:69-70, ni/lib/lal_annp.cu:51-52).
"""

# --- LAMMPS metal-unit constants (update.cpp "metal" block) ---
BOLTZ = 8.617343e-5          # Boltzmann constant [eV/K]
MVV2E = 1.0364269e-4         # mass*velocity^2 -> energy [ (g/mol)(A/ps)^2 -> eV ]
NKTV2P = 1.6021765e6         # energy/volume -> pressure [ eV/A^3 -> bar ]
FTM2V = 1.0 / MVV2E          # force/mass -> velocity-rate [ (eV/A)/(g/mol) -> A/ps^2 ]

# --- atomic-unit conversions used by the Ni ANNP potential ---
CFLENGTH = 1.889726          # Angstrom -> Bohr   (ni/src/pair_annp.h:69)
CFFORCE = 51.422515          # Hartree/Bohr -> eV/Angstrom (ni/src/pair_annp.h:70)
HARTREE_EV = 27.211386       # Hartree -> eV (for optional consistent-energy mode)

# --- lattice constants used by the reference geometry tools ---
A_BCC_FE = 2.8553            # bcc-Fe lattice parameter [A] (screw_dislocation_bcc_fe.cpp:21)
MASS_FE = 55.847             # g/mol (fe_annp_potential_2.ann element line)
MASS_NI = 58.6934            # g/mol (ni_annp_potential_2.ann element line)
