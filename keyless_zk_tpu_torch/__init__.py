"""Groth16 prover for the Aptos Keyless circuit in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `keyless_zk_tpu`, which stays the reference: the
layout mirrors it (fields/, curves/, circuits/, ops/, groth16/) and keeps its function
names; csrc/ holds the CUDA sources, built at first use (ops/_build.py).
This package imports torch and never jax.
"""
