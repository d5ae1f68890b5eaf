"""The port's prover CLI (`python -m keyless_zk_tpu_torch.groth16.cli`) on
the CPU: a chain-circuit setup's zkey, witness and vk written to the test's
directory, proved by `prove --device cpu` (exit 0, "verified: true", the
public signals printed), its output through `verify`; `prove --r1cs
--input --sym` on a circom-order chain key, whose public signals are those
of the --wtns run; without a witness, or with --r1cs and no --input, exit 2
with the JAX CLI's message."""

import json

import pytest

from keyless_zk_tpu_torch.fields import bn254
from keyless_zk_tpu_torch.groth16 import cli
from keyless_zk_tpu_torch.groth16.wtns import save_wtns, witness_from_ints
from keyless_zk_tpu_torch.groth16.zkey import save_zkey
import torch_circom_fixtures as cf
from torch_io_fixtures import TOXIC, small_setup


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


@pytest.mark.parametrize("args", [["--r1cs", "main.r1cs"], []])
def test_prove_without_a_wtns_exits_2(files, args, capsys):
    paths, _ = files
    assert cli.main(["prove", "--zkey", paths["key.zkey"], *args, "--device", "cpu"]) == 2
    assert capsys.readouterr().err.strip() == "need --wtns, or --r1cs with --input"


def test_prove_from_r1cs_and_input(tmp_path, monkeypatch, capsys):
    """A circom-order chain (is_zero and a circom-form Num2Bits(8) appended)
    set up on the CPU: `prove --r1cs --input --sym` solves the witness
    through the compiled program (kept in a temporary cache root) and its
    proof verifies; its public signals are those of `prove --wtns` with the
    same witness."""
    from keyless_zk_tpu_torch.circuits import circom_interop, groth16_setup
    from keyless_zk_tpu_torch.circuits.circom_witness import CircomWitnessProgram

    monkeypatch.setattr(circom_interop, "CACHE_ROOT", tmp_path / "cache")
    m = 4
    _, r, _, _, _ = cf.circom_chain("keyless_zk_tpu_torch", m, n_bits=8)
    paths = cf.write_circom_files(tmp_path, r, m)
    res = groth16_setup(r, toxic=TOXIC, device="cpu")
    paths |= {k: str(tmp_path / k) for k in ("key.zkey", "w.wtns", "vk.json")}
    save_zkey(paths["key.zkey"], res.pk)
    w = CircomWitnessProgram(r).compute_ints({1: pow(cf.B, m, cf.R), 2: cf.B})
    save_wtns(paths["w.wtns"], witness_from_ints(w, bn254.R_SCALAR))
    with open(paths["vk.json"], "w") as f:
        json.dump(res.vk, f)
    key = ["prove", "--zkey", paths["key.zkey"], "--vk", paths["vk.json"], "--device", "cpu"]
    publics = []
    for route in (["--r1cs", paths["circuit.r1cs"], "--input", paths["input.json"], "--sym", paths["circuit.sym"]],
                  ["--wtns", paths["w.wtns"]]):
        rc = cli.main(key + route)
        out, err = capsys.readouterr()
        assert rc == 0 and "verified: true" in err, err
        publics.append(json.loads(out.splitlines()[1]))
    assert publics[0] == publics[1] == [str(pow(cf.B, m, cf.R))]
    assert list(circom_interop.CACHE_ROOT.iterdir()) == [
        circom_interop.CACHE_ROOT / f"{circom_interop.r1cs_digest(paths['circuit.r1cs'])}.npz"]
    assert list(circom_interop.witness_from_input_json(paths["circuit.r1cs"], paths["input.json"])) == w
