"""Host utilities: structured span logging and Ed25519 (jax-free copies of
keyless_zk_tpu.utils)."""
