"""The benchmark's plain reference: what decides `correct`.

Plain Python over integers, for the BN254 pairing, Poseidon, Ed25519 and
the keyless statement. It imports nothing of the program
(keyless_zk_tpu_torch) and nothing of the JAX package, and it takes
nothing the program made but the answers it judges and the setup's
verification key (the raw `verification_key.json` both sides read, as a
deployment reads its ceremony's key). `judge.py` holds the comparison.
"""
