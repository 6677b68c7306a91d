"""Standard atomic weights in Da, for plasma species given by element.

The port's own copy of ``ATOMIC_WEIGHTS_DA`` of
``hipace_tpu/utils/atomic_data.py:56-62``. The ionization energies stay
behind with field ionization, which is not ported.
"""

ATOMIC_WEIGHTS_DA = {
    "H": 1.008, "He": 4.002602, "Li": 6.94, "Be": 9.0121831, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998403163, "Ne": 20.1797,
    "Na": 22.98976928, "Mg": 24.305, "Al": 26.9815384, "Si": 28.085,
    "Ar": 39.95, "Cu": 63.546, "Kr": 83.798, "Rb": 85.4678, "Xe": 131.293,
    "Cs": 132.90545196,
}
