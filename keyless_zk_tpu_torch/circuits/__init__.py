"""Constraint systems and Groth16 setup (PyTorch port of keyless_zk_tpu.circuits)."""

from .r1cs import ConstraintSystem, LinComb
from .r1cs_file import R1CS, r1cs_from_cs
from .setup import SetupResult, groth16_setup

__all__ = ["ConstraintSystem", "LinComb", "R1CS", "r1cs_from_cs", "SetupResult", "groth16_setup"]
