"""Setup procurement, on-chain VK encoding, the VK diff and the release
helper (jax-free copies of keyless_zk_tpu.tooling's setup_tool, onchain_vk,
vk_diff and release_helper)."""
