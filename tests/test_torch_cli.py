"""The port's prover CLI (`python -m keyless_zk_tpu_torch.groth16.cli`) on
the CPU: a chain-circuit setup's zkey, witness and vk written to the test's
directory, proved by `prove --device cpu` (exit 0, "verified: true", the
public signals printed), its output through `verify`; the --r1cs/--input
route, not ported, exits 2."""

import json

import pytest

from keyless_zk_tpu_torch.fields import bn254
from keyless_zk_tpu_torch.groth16 import cli
from keyless_zk_tpu_torch.groth16.wtns import save_wtns, witness_from_ints
from keyless_zk_tpu_torch.groth16.zkey import save_zkey
from torch_io_fixtures import small_setup


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    _, w, a, res = small_setup()
    paths = {k: str(d / k) for k in ("key.zkey", "w.wtns", "vk.json", "proof.json", "public.json", "bad.json")}
    save_zkey(paths["key.zkey"], res.pk)
    save_wtns(paths["w.wtns"], witness_from_ints(w, bn254.R_SCALAR))
    with open(paths["vk.json"], "w") as f:
        json.dump(res.vk, f)
    return paths, w[a]


def test_prove_then_verify(files, capsys):
    paths, public = files
    rc = cli.main(["prove", "--zkey", paths["key.zkey"], "--wtns", paths["w.wtns"], "--vk", paths["vk.json"],
                   "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert "verified: true" in err
    proof_line, public_line = out.splitlines()[:2]
    assert json.loads(public_line) == [str(public)]
    for name, line in (("proof.json", proof_line), ("public.json", public_line)):
        with open(paths[name], "w") as f:
            f.write(line)
    assert cli.main(["verify", "--vk", paths["vk.json"], "--proof", paths["proof.json"],
                     "--public", paths["public.json"]]) == 0
    assert capsys.readouterr().out.strip() == "verified: true"
    with open(paths["bad.json"], "w") as f:
        json.dump([str(public + 1)], f)
    assert cli.main(["verify", "--vk", paths["vk.json"], "--proof", paths["proof.json"],
                     "--public", paths["bad.json"]]) == 1
    assert capsys.readouterr().out.strip() == "verified: false"


@pytest.mark.parametrize("args", [["--r1cs", "main.r1cs", "--input", "input.json"], []])
def test_prove_without_a_wtns_exits_2(files, args, capsys):
    paths, _ = files
    assert cli.main(["prove", "--zkey", paths["key.zkey"], *args, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert ("not port" in err) if args else ("need --wtns" in err)
