"""Setup procurement and on-chain VK encoding (jax-free copies of
keyless_zk_tpu.tooling's setup_tool and onchain_vk)."""
