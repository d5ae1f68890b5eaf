"""The port's entry points run on the card unless the caller asks for the
CPU: without a card (CUDA reported absent), each one called with its
default device raises instead of falling back to the CPU, and each one runs
when asked for the CPU. The prover takes K10's NTT plan on every device:
the kernel's passes on a card, their plain versions on the CPU."""

import pytest
import torch

from keyless_zk_tpu_torch import device as devices
from keyless_zk_tpu_torch.circuits import ConstraintSystem, groth16_setup, r1cs_from_cs
from keyless_zk_tpu_torch.groth16 import Groth16Prover, prover
from keyless_zk_tpu_torch.ops import cuda_ntt, mxu_ntt, testgen
from keyless_zk_tpu_torch.ops.ntt import NTTPlan

torch.set_num_threads(1)

SMALL_KEY = dict(n_vars=24, n_public=1, domain_pow=3, n_distinct_a=20, n_distinct_b=14, n_coefs=40)


def _tiny_r1cs():
    cs = ConstraintSystem()
    a = cs.public_wire()
    b = cs.new_wire()
    cs.constrain_eq(cs.lc(cs.mul(cs.lc(b), cs.lc(b))), cs.lc(a))
    return r1cs_from_cs(cs)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_the_card():
    assert devices.DEFAULT == "cuda"


@pytest.mark.parametrize(
    "entry",
    [
        lambda: NTTPlan(4),
        lambda: mxu_ntt.MxuNTTPlan(7),
        lambda: mxu_ntt.get_mxu_plan(7),
        lambda: cuda_ntt.CudaNTTPlan(4),
        lambda: cuda_ntt.get_cuda_plan(7),
        lambda: testgen.random_scalars(4),
        lambda: testgen.random_points(4),
        lambda: testgen.synthetic_key(1, **SMALL_KEY),
        lambda: groth16_setup(_tiny_r1cs(), toxic={"tau": 9, "alpha": 3, "beta": 4, "gamma": 5, "delta": 6}),
    ],
    ids=["NTTPlan", "MxuNTTPlan", "get_mxu_plan", "CudaNTTPlan", "get_cuda_plan", "random_scalars",
         "random_points", "synthetic_key", "groth16_setup"],
)
def test_entry_points_refuse_a_missing_card(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_prover_refuses_a_missing_card_and_runs_on_the_cpu(no_card):
    key = testgen.synthetic_key(1, device="cpu", **SMALL_KEY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Groth16Prover(key.pk)
    assert Groth16Prover(key.pk, device="cpu").device == torch.device("cpu")
    assert testgen.random_scalars(4, device="cpu").device == torch.device("cpu")


def test_plan_is_picked_by_device(monkeypatch):
    key = testgen.synthetic_key(1, device="cpu", **SMALL_KEY)
    plan = Groth16Prover(key.pk, device="cpu").plan
    assert isinstance(plan, cuda_ntt.CudaNTTPlan)
    assert (plan.domain_pow, plan.device) == (3, torch.device("cpu"))

    class Picked(Exception):
        pass

    picked = []

    def stub(dp, dev):
        picked.append((dp, dev))
        raise Picked  # the plan is the first thing the prover puts on its device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(prover, "get_cuda_plan", stub)
    with pytest.raises(Picked):
        Groth16Prover(key.pk, device="cuda")
    assert picked == [(3, torch.device("cuda"))]
