"""Element symbol <-> atomic number table (dependency-free).

The port's own copy of the JAX package's data/periodic.py.  The reference
gets this through ase / pymatgen; the loaders only need symbol -> Z, so a
static table keeps the parsers free of either package.
"""

from __future__ import annotations

# index = Z (index 0 is a placeholder), Z = 1..103
SYMBOLS = [
    "X",
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr",
]

ATOMIC_NUMBERS = {s: z for z, s in enumerate(SYMBOLS)}


def symbol_to_z(symbol: str) -> int:
    return ATOMIC_NUMBERS[symbol]
