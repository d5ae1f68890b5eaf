"""The port's setup tool (keyless_zk_tpu_torch/tooling/setup_tool.py):

- `circuit_checksum` is stable and changes with the configuration;
- `import_zkey` installs a small setup's zkey content-addressed, builds
  its table cache beside it, recovers a vk equal to the setup's from the
  zkey alone, and `set_slot` flips the store's slots;
- `procure`, with the circuit build and the setup replaced by a chain
  circuit's on the CPU, writes every file of a setup with `.complete`
  last, installs it as `default`, and returns at once when it is there;
- `cache-push` and `cache-pull` carry a setup between stores byte for byte,
  and `cache-pull` of a key the remote lacks exits 1; `download-ceremony`
  hands its arguments to tooling/ceremony.py's `download_ceremony`."""

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


def test_cache_push_then_pull(tmp_path, capsys):
    _, _, _, res = small_setup()
    src = str(tmp_path / "ceremony.zkey")
    save_zkey(src, res.pk)
    setup = setup_tool.import_zkey(src, root=str(tmp_path / "a"))
    remote = f"file://{tmp_path / 'remote'}"
    assert setup_tool.main(["cache-push", setup, "--remote", remote]) == 0
    key = os.path.basename(setup)
    assert capsys.readouterr().out.strip() == str(tmp_path / "remote" / f"{key}.tar.gz")
    root_b = str(tmp_path / "b")
    assert setup_tool.main(["cache-pull", key, "--remote", remote, "--root", root_b, "--slot", "default"]) == 0
    got = capsys.readouterr().out.strip()
    assert got == os.path.join(root_b, key)
    assert sorted(os.listdir(got)) == sorted(os.listdir(setup))
    for name in os.listdir(setup):
        with open(os.path.join(setup, name), "rb") as f, open(os.path.join(got, name), "rb") as g:
            assert f.read() == g.read(), name
    assert os.readlink(os.path.join(root_b, "default")) == key


def test_cache_pull_of_a_missing_key_exits_1(tmp_path, capsys):
    (tmp_path / "remote").mkdir()
    root = tmp_path / "setups"
    assert setup_tool.main(["cache-pull", "zkey-0123456789abcdef", "--remote", str(tmp_path / "remote"),
                            "--root", str(root)]) == 1
    assert capsys.readouterr().err.strip() == "not found in cache"
    assert not root.exists() or not list(root.iterdir())


def test_download_ceremony_arguments(tmp_path, monkeypatch, capsys):
    """The command's arguments reach download_ceremony and the Releases it
    builds (--repo, --auth-token, else $GITHUB_TOKEN), each --checksum pin,
    --root and --slot; Releases serves a staged feed."""
    import hashlib
    import shutil

    from keyless_zk_tpu_torch.tooling import ceremony

    _, _, _, res = small_setup()
    assets = tmp_path / "assets"
    assets.mkdir()
    save_zkey(str(assets / "prover_key.zkey"), res.pk)
    with open(assets / "verification_key.json", "w") as f:
        json.dump(res.vk, f)
    (assets / "circuit_config.yaml").write_text("max_lengths: {}\n")
    feed = [{"tag_name": "ceremony-v2", "assets": [{"name": n, "browser_download_url": str(assets / n)}
                                                   for n in ceremony.CEREMONY_ASSETS]}]
    made = []

    class StagedReleases(ceremony.Releases):
        def __init__(self, repo, auth_token):
            made.append((repo, auth_token))
            super().__init__(repo, fetch=lambda url, dest, token: shutil.copyfile(url, dest), feed=feed)

    monkeypatch.setattr(ceremony, "Releases", StagedReleases)
    with open(assets / "prover_key.zkey", "rb") as f:
        pin = hashlib.sha256(f.read()).hexdigest()
    root = tmp_path / "setups"
    assert setup_tool.main(["download-ceremony", "ceremony-v2", "--repo", "org/proofs", "--auth-token", "t0k",
                            "--checksum", f"prover_key.zkey={pin}", "--root", str(root), "--slot", "default"]) == 0
    target = capsys.readouterr().out.strip()
    assert target == str(root / f"zkey-{pin[:16]}")
    assert os.readlink(root / "default") == os.path.basename(target)
    assert sorted(os.listdir(target)) == [".complete", "circuit_config.yml", "prover_key.zkey",
                                          "verification_key.json"]
    assert made == [("org/proofs", "t0k")]
    monkeypatch.setenv("GITHUB_TOKEN", "from-env")
    with pytest.raises(ValueError, match="checksum mismatch for verification_key.json"):
        setup_tool.main(["download-ceremony", "ceremony-v2", "--checksum", "verification_key.json=" + "0" * 64,
                         "--root", str(tmp_path / "other")])
    assert made[-1] == ("aptos-labs/keyless-zk-proofs", "from-env")
    assert not (tmp_path / "other").exists()


def test_show_lists_the_store(tmp_path, capsys):
    (tmp_path / "abc").mkdir()
    assert setup_tool.main(["show", "--root", str(tmp_path)]) == 0
    assert capsys.readouterr().out.split() == ["abc"]
