"""The port's VK diff and release helper (tooling/vk_diff.py,
tooling/release_helper.py) against the JAX package's, on the vk of an
in-repo setup (tests/test_torch_prover.py `native_setup`): the same diff
lists and exit codes, a perturbed on-chain VK flagged by both, the same
printed output, and byte-equal governance scripts and release files.
Nothing is fetched: the on-chain side always comes from a file."""

import contextlib
import io
import json

import pytest

from keyless_zk_tpu.tooling import onchain_vk as jax_onchain
from keyless_zk_tpu.tooling import release_helper as jax_release
from keyless_zk_tpu.tooling import vk_diff as jax_vk_diff
from keyless_zk_tpu_torch.tooling import onchain_vk, release_helper, vk_diff
from test_torch_prover import native_setup

TWPK = "0x" + "ab" * 32


@pytest.fixture(scope="module")
def vk():
    return native_setup()[0].vk


def _perturbed(onchain: dict) -> dict:
    bad = json.loads(json.dumps(onchain))
    h = bad["data"]["alpha_g1"]
    bad["data"]["alpha_g1"] = h[:-2] + ("00" if h[-2:] != "00" else "01")
    return bad


def _main(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


def test_vk_diff_matches_jax(vk, tmp_path):
    onchain = onchain_vk.snarkjs_vk_to_onchain(vk)
    assert onchain == jax_onchain.snarkjs_vk_to_onchain(vk)
    bad = _perturbed(onchain)
    assert vk_diff.diff_vks(vk, onchain) == jax_vk_diff.diff_vks(vk, onchain) == []
    diffs = vk_diff.diff_vks(vk, bad)
    assert diffs == jax_vk_diff.diff_vks(vk, bad) and len(diffs) == 1 and diffs[0].startswith("alpha_g1:")

    (tmp_path / "vk.json").write_text(json.dumps(vk))
    for name, doc in (("good", onchain), ("bad", bad)):
        (tmp_path / f"{name}.json").write_text(json.dumps(doc))
        argv = ["--json", str(tmp_path / "vk.json"), "--onchain-file", str(tmp_path / f"{name}.json"), "--debug"]
        got, want = _main(vk_diff, argv), _main(jax_vk_diff, argv)
        assert got == want and got[0] == (0 if name == "good" else 1)


@pytest.mark.parametrize("root_signer", [True, False])
def test_release_helper_matches_jax(vk, tmp_path, root_signer):
    assert release_helper.generate_script_content(vk, TWPK, root_signer) == \
        jax_release.generate_script_content(vk, TWPK, root_signer)
    (tmp_path / "vk.json").write_text(json.dumps(vk))
    (tmp_path / "twpk").write_text(TWPK + "\n")
    files = {}
    for name, mod in (("port", release_helper), ("jax", jax_release)):
        out = tmp_path / name
        if root_signer:
            argv = ["generate-root-signer-script", "--vk-path", str(tmp_path / "vk.json"),
                    "--twpk-path", str(tmp_path / "twpk"), "--out", str(out / "script.move")]
        else:
            argv = ["generate-proposal", "--aptos-core-path", str(out), "--vk-path", str(tmp_path / "vk.json"),
                    "--twpk-path", str(tmp_path / "twpk"), "--circuit-release-tag", "v1.2.3", "--tw-key-id", "7"]
        rc, text = _main(mod, argv)
        assert rc == 0
        files[name] = (text.replace(str(out), "OUT"),
                       {str(p.relative_to(out)): p.read_bytes() for p in sorted(out.rglob("*")) if p.is_file()})
    assert files["port"] == files["jax"] and files["port"][1]
