"""Physical constants (SI, kmol-based — combustion convention).

The port's own copy of deepflame_tpu/constants.py: the same values, so that
both packages build identical tables from one mechanism file.
"""

# Universal gas constant [J / (kmol K)]
GAS_CONSTANT = 8314.462618
# Standard atmosphere [Pa]
ONE_ATM = 101325.0
# Standard-state pressure for equilibrium constants [Pa]
P_REF = ONE_ATM
# Avogadro constant [1/kmol]
AVOGADRO = 6.02214076e26
# Boltzmann constant [J/K]
BOLTZMANN = 1.380649e-23
# Calorie [J]
CAL_TO_J = 4.184

# Atomic weights [kg/kmol] for element bookkeeping (IUPAC 2021 rounded)
ATOMIC_WEIGHTS = {
    "H": 1.008, "D": 2.0141, "He": 4.002602, "Li": 6.94, "Be": 9.0121831,
    "B": 10.81, "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998403163,
    "Ne": 20.1797, "Na": 22.98976928, "Mg": 24.305, "Al": 26.9815385,
    "Si": 28.085, "P": 30.973761998, "S": 32.06, "Cl": 35.45, "Ar": 39.948,
    "K": 39.0983, "Ca": 40.078, "Fe": 55.845, "Br": 79.904, "Kr": 83.798,
    "Xe": 131.293, "E": 0.000548579909,
}
