"""The port runs without JAX: fresh interpreters whose import system refuses
`jax`, `jaxlib` and the JAX package import every module of
keyless_zk_tpu_torch (parallel/ and the tools among them), prove on the CPU under a tiny synthetic key (checked
against its discrete-log oracle), run setup -> prove -> verify on a tiny
chain circuit (the setup through K3's plain versions), and run the port's
compiled witness engine: on the gadget circuit of keyless_gadget_circuit.py
(equal to the Python witness) and on an in-circuit RSA-2048 PKCS#1 check of
a JWT from the port's seeded generator (satisfied; violated with the
signature changed), and the circom route (a circom-order chain's .r1cs,
input.json and .sym through `witness_from_input_json` and the compiled
program; equal to the native witness). `chip_smoke.py` imports nothing of
JAX either, at its top level or inside its functions."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "keyless_zk_tpu")

REFUSE = r'''
import sys

BLOCKED = ("jax", "jaxlib", "keyless_zk_tpu")


def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("refused in this process: " + name)
        return None


sys.meta_path.insert(0, Refuse())
'''

DONE = r'''
loaded = [m for m in sys.modules if blocked(m)]
assert not loaded, loaded
print("NO_JAX_OK")
'''

PROVE = REFUSE + r'''
import importlib
import pkgutil

import torch

torch.set_num_threads(1)
import keyless_zk_tpu_torch

modules = [m.name for m in pkgutil.walk_packages(keyless_zk_tpu_torch.__path__, "keyless_zk_tpu_torch.")]
for name in modules:
    importlib.import_module(name)
assert len(modules) >= 20, modules
# parallel/ (its torch.distributed modules import without a process group)
# and the tools are among them
assert {"keyless_zk_tpu_torch.parallel", "keyless_zk_tpu_torch.parallel.batch_prover",
        "keyless_zk_tpu_torch.parallel.distributed", "keyless_zk_tpu_torch.parallel.sharded",
        "keyless_zk_tpu_torch.parallel.sharded_prover", "keyless_zk_tpu_torch.tooling.vk_diff",
        "keyless_zk_tpu_torch.tooling.release_helper", "keyless_zk_tpu_torch.tooling.ceremony",
        "keyless_zk_tpu_torch.circuits.circom_witness",
        "keyless_zk_tpu_torch.circuits.circom_interop"} <= set(modules), modules

from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.groth16 import Groth16Prover
from keyless_zk_tpu_torch.ops import testgen

key = testgen.synthetic_key(
    4, n_vars=24, n_public=1, domain_pow=3, n_distinct_a=20, n_distinct_b=14, n_coefs=40, device="cpu"
)
prover = Groth16Prover(key.pk, device="cpu")
proof = prover.prove(key.witness, r=11, s=13)
want = testgen.expected_proof(key, tf.decode_ints(prover.last_h[0], tf.FR), 11, 13)
assert (proof.pi_a, proof.pi_b, proof.pi_c) == want, "proof differs from the dlog oracle"
''' + DONE

SETUP = REFUSE + r'''
import torch

torch.set_num_threads(1)
from keyless_zk_tpu_torch.circuits import ConstraintSystem, groth16_setup, r1cs_from_cs
from keyless_zk_tpu_torch.groth16 import Groth16Prover, verify_groth16

cs = ConstraintSystem()
a = cs.public_wire()
cs.set_input_hint([a], "a")
b = cs.new_wire()
cs.set_input_hint([b], "b")
x = b
for _ in range(3):
    x = cs.mul(cs.lc(x), cs.lc(b))
cs.constrain_eq(cs.lc(x), cs.lc(a))
w = cs.compute_witness(a=3**4, b=3)
res = groth16_setup(r1cs_from_cs(cs), toxic={"tau": 99, "alpha": 3, "beta": 4, "gamma": 5, "delta": 6},
                    device_threshold=0, device="cpu")
proof = Groth16Prover(res.pk, device="cpu").prove(cs.witness_np(w), r=5, s=6).to_json_dict()
assert verify_groth16(res.vk, [w[a]], proof)
assert not verify_groth16(res.vk, [w[a] + 1], proof)
''' + DONE

WITNESS = REFUSE + r'''
import hashlib
import sys

sys.path.insert(0, "tests")
import keyless_gadget_circuit as kg
from keyless_zk_tpu_torch.circuits import ConstraintSystem
from keyless_zk_tpu_torch.circuits.rsa_gadget import rsa_pkcs1_verify
from keyless_zk_tpu_torch.circuits.witness_engine import CompiledWitnessProgram
from keyless_zk_tpu_torch.hashes import poseidon_hash
from keyless_zk_tpu_torch.input_processing.testjwt import make_test_jwt

cs, _ = kg.build("keyless_zk_tpu_torch", "engine")
kw = kg.inputs(poseidon_hash, "engine")
prog = CompiledWitnessProgram(cs)
wires = prog.compute_witness(**kw)
assert prog.witness_ints(wires) == cs.compute_witness(**kw)
assert prog.check_witness(wires) is None


def limbs(v, bits, k):
    return [(v >> (bits * i)) & ((1 << bits) - 1) for i in range(k)]


tj = make_test_jwt(seed=6)
unsigned = tj.vi.jwt_parts.unsigned_undecoded().encode()
cs = ConstraintSystem()
ws = {}
for name, k in (("sig", 32), ("mod", 32), ("hashed", 4)):
    ws[name] = cs.new_wires(k)
    cs.set_input_hint(ws[name], name)
    for w in ws[name]:
        cs.to_bits(cs.lc(w), 64)
rsa_pkcs1_verify(cs, ws["sig"], ws["mod"], [cs.lc(h) for h in ws["hashed"]])
prog = CompiledWitnessProgram(cs)
sig = tj.vi.jwt_parts.signature_int()
kw = {"sig": limbs(sig, 64, 32), "mod": limbs(tj.rsa_key.n, 64, 32),
      "hashed": limbs(int.from_bytes(hashlib.sha256(unsigned).digest(), "big"), 64, 4)}
assert prog.check_witness(prog.compute_witness(**kw)) is None
kw["sig"] = limbs(sig ^ 1, 64, 32)
assert prog.check_witness(prog.compute_witness(**kw)) is not None

# the circom route: a circom-order chain with an is_zero and a circom-form
# Num2Bits, from its .r1cs, input.json and .sym through the compiled program
import tempfile
from pathlib import Path

import torch_circom_fixtures as cf
from keyless_zk_tpu_torch.circuits import circom_interop

cs, r, perm, bits, x = cf.circom_chain("keyless_zk_tpu_torch", 40)
with tempfile.TemporaryDirectory() as d:
    circom_interop.CACHE_ROOT = Path(d) / "cache"
    paths = cf.write_circom_files(Path(d), r, 40)
    w = circom_interop.witness_from_input_json(paths["circuit.r1cs"], paths["input.json"], paths["circuit.sym"])
    assert len(list(circom_interop.CACHE_ROOT.iterdir())) == 1
native = cs.compute_witness(**{k: int(v) for k, v in cf.chain_inputs(40).items()})
assert [w[perm[i]] for i in range(cs.n_wires)] == native
assert [w[b] for b in bits] == [(w[x] >> i) & 1 for i in range(254)]
''' + DONE

IMPORT_CHIP_SMOKE = REFUSE + r'''
import chip_smoke

assert callable(chip_smoke.main)
''' + DONE


def _run(code: str) -> None:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "NO_JAX_OK" in out.stdout


def test_port_proves_without_jax():
    _run(PROVE)


def test_port_sets_up_proves_and_verifies_without_jax():
    _run(SETUP)


def test_port_witness_engine_runs_without_jax():
    _run(WITNESS)


def test_chip_smoke_imports_no_jax():
    """Every import statement of chip_smoke.py, the ones inside its
    functions too, names no JAX module; and it imports under the refusal."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "keyless_zk_tpu_torch.ops" in names
    assert not [n for n in names if any(n == b or n.startswith(b + ".") for b in BLOCKED)]
    _run(IMPORT_CHIP_SMOKE)
