"""The console scripts pyproject.toml installs for keyless_zk_tpu_torch:
each names a callable the port defines, and every tool of the JAX package
has its port counterpart (keyless-zk-tpu-<tool> and
keyless-zk-tpu-torch-<tool>)."""

import importlib
import tomllib
from pathlib import Path

import pytest

SCRIPTS = tomllib.loads((Path(__file__).resolve().parents[1] / "pyproject.toml").read_text())["project"]["scripts"]
PORT = {name: target for name, target in SCRIPTS.items() if target.startswith("keyless_zk_tpu_torch.")}


def test_every_jax_tool_has_a_port_script():
    jax_tools = {name.removeprefix("keyless-zk-tpu-") for name, target in SCRIPTS.items()
                 if target.startswith("keyless_zk_tpu.")}
    assert {name.removeprefix("keyless-zk-tpu-torch-") for name in PORT} == jax_tools
    assert {"prove", "prover-service", "setup", "vk-diff", "release-helper"} <= jax_tools


@pytest.mark.parametrize("name", sorted(PORT))
def test_port_script_target_is_a_callable(name):
    module, _, attr = PORT[name].partition(":")
    assert callable(getattr(importlib.import_module(module), attr))
