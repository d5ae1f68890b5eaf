"""BN254 (alt_bn128) curve and field constants.

These are public parameters of the BN254 pairing curve used by circom/snarkjs
and by the reference stack (rust-rapidsnark/rapidsnark/src/fr.hpp, fq.hpp and
alt_bn128.hpp define the same primes; cross-checked against the value cited in
the reference at rust-rapidsnark/rapidsnark/src/groth16.cpp:295-300).
"""

# Base field modulus q (coordinates of G1; Fq2 tower for G2).
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Scalar field modulus r (the circuit/witness field).
R_SCALAR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter x such that p(x), r(x) follow the BN family polynomials.
BN_X = 4965661367192848881

# Curve: y^2 = x^3 + 3 over Fq. G2 on the twist y^2 = x^3 + 3/(9+u) over
# Fq2 = Fq[u]/(u^2+1).
CURVE_B = 3

G1_GENERATOR = (1, 2)

# Standard G2 generator (snarkjs/ark-bn254 convention).
G2_GENERATOR_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GENERATOR_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# Two-adicity of r-1: r - 1 = 2^28 * T_ODD.
TWO_ADICITY = 28
T_ODD = (R_SCALAR - 1) >> TWO_ADICITY
assert T_ODD % 2 == 1

# Smallest quadratic non-residue of Fr, found by upward search from 2 exactly
# like the reference FFT root-table constructor (fft.cpp:60-67): 5 is the
# first n with n^((r-1)/2) == -1 mod r.
FR_NQR = 5
assert pow(FR_NQR, (R_SCALAR - 1) // 2, R_SCALAR) == R_SCALAR - 1

# 2^28-th root of unity generator used for every NTT domain.
ROOT_OF_UNITY_2_28 = pow(FR_NQR, T_ODD, R_SCALAR)


def fr_root_of_unity(domain_pow: int) -> int:
    """Primitive 2^domain_pow-th root of unity in Fr.

    Matches the reference convention (fft.cpp:74-83): w = nqr^((r-1)/2^s).
    """
    if domain_pow > TWO_ADICITY:
        raise ValueError(f"domain 2^{domain_pow} exceeds two-adicity {TWO_ADICITY}")
    return pow(ROOT_OF_UNITY_2_28, 1 << (TWO_ADICITY - domain_pow), R_SCALAR)
