"""The port's setup tool (keyless_zk_tpu_torch/tooling/setup_tool.py):

- `circuit_checksum` is stable and changes with the configuration;
- `import_zkey` installs a small setup's zkey content-addressed, builds
  its table cache beside it, recovers a vk equal to the setup's from the
  zkey alone, and `set_slot` flips the store's slots;
- `procure`, with the circuit build and the setup replaced by a chain
  circuit's on the CPU, writes every file of a setup with `.complete`
  last, installs it as `default`, and returns at once when it is there;
- the commands that are not ported exit 2."""

import json
import os

import pytest

from keyless_zk_tpu_torch.circuits.keyless_circuit import KeylessConfig
from keyless_zk_tpu_torch.groth16.zkey import save_zkey
from keyless_zk_tpu_torch.tooling import setup_tool
from torch_io_fixtures import chain_circuit, small_setup

SETUP_FILES = ("main.r1cs", "prover_key.zkey", "verification_key.json", "circuit_config.yml", "keyless_config.json")


def test_circuit_checksum_stable_and_config_sensitive():
    a = setup_tool.circuit_checksum(KeylessConfig())
    assert a == setup_tool.circuit_checksum(KeylessConfig())
    assert len(a) == 16
    assert setup_tool.circuit_checksum(KeylessConfig(max_aud_value_len=119)) != a


def test_import_zkey_recovers_the_vk_and_flips_slots(tmp_path):
    _, _, _, res = small_setup()
    src = str(tmp_path / "ceremony.zkey")
    save_zkey(src, res.pk)
    root = str(tmp_path / "setups")
    os.makedirs(root)
    target = setup_tool.import_zkey(src, root=root, slot="new")
    assert os.path.exists(os.path.join(target, ".complete"))
    assert os.path.basename(target).startswith("zkey-")
    assert os.readlink(os.path.join(root, "new")) == os.path.basename(target)
    assert sorted(os.listdir(target)) == [".complete", "prover_key.zkey", "verification_key.json"]
    with open(os.path.join(target, "verification_key.json")) as f:
        assert json.load(f) == res.vk
    setup_tool.set_slot(root, os.path.basename(target), "default")
    assert os.readlink(os.path.join(root, "default")) == os.path.basename(target)
    assert setup_tool.import_zkey(src, root=root) == target
    with pytest.raises(ValueError):
        setup_tool.set_slot(root, os.path.basename(target), "old")


def test_procure_writes_every_file_then_complete(tmp_path, monkeypatch):
    cs, _, _ = chain_circuit()
    builds, setups, written = [], [], []
    real_setup = setup_tool.groth16_setup
    monkeypatch.setattr(setup_tool, "build_keyless_circuit", lambda kc: builds.append(kc) or cs)

    def setup_on_cpu(r, device):
        setups.append(device)
        return real_setup(r, device="cpu")

    monkeypatch.setattr(setup_tool, "groth16_setup", setup_on_cpu)
    for name in ("save_r1cs", "save_zkey"):
        real = getattr(setup_tool, name)

        def spy(path, obj, _real=real):
            written.append((os.path.basename(path), os.path.exists(os.path.join(os.path.dirname(path), ".complete"))))
            return _real(path, obj)

        monkeypatch.setattr(setup_tool, name, spy)
    root = str(tmp_path / "setups")
    kc = KeylessConfig()
    target = setup_tool.procure(kc, root=root, device="cpu")
    assert target == os.path.join(root, setup_tool.circuit_checksum(kc))
    assert (len(builds), setups) == (1, ["cpu"])
    assert written == [("main.r1cs", False), ("prover_key.zkey", False)]
    complete = os.stat(os.path.join(target, ".complete")).st_mtime_ns
    for name in SETUP_FILES:
        assert os.stat(os.path.join(target, name)).st_mtime_ns <= complete, name
    assert os.readlink(os.path.join(root, "default")) == os.path.basename(target)
    with open(os.path.join(target, "circuit_config.yml")) as f:
        assert "max_lengths:" in f.read()
    assert setup_tool.procure(kc, root=root, device="cpu") == target
    assert (len(builds), len(setups)) == (1, 1), "procure rebuilt a complete setup"


@pytest.mark.parametrize("cmd", [["download-ceremony", "v1"], ["cache-pull", "k", "--remote", "r"],
                                 ["cache-push", "d", "--remote", "r"]])
def test_commands_not_ported_exit_2(cmd, capsys):
    assert setup_tool.main(cmd) == 2
    assert "not ported" in capsys.readouterr().err


def test_show_lists_the_store(tmp_path, capsys):
    (tmp_path / "abc").mkdir()
    assert setup_tool.main(["show", "--root", str(tmp_path)]) == 0
    assert capsys.readouterr().out.split() == ["abc"]
