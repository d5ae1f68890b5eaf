"""The port runs without JAX: a fresh interpreter whose import system
refuses `jax`, `jaxlib` and the JAX package imports keyless_zk_tpu_torch,
makes a tiny synthetic key, proves on the CPU and checks the proof against
the key's discrete-log oracle."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import sys

BLOCKED = ("jax", "jaxlib", "keyless_zk_tpu")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("refused in this process: " + name)
        return None


sys.meta_path.insert(0, Refuse())
import torch

torch.set_num_threads(1)
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.groth16 import Groth16Prover
from keyless_zk_tpu_torch.ops import testgen

key = testgen.synthetic_key(
    4, n_vars=24, n_public=1, domain_pow=3, n_distinct_a=20, n_distinct_b=14, n_coefs=40
)
prover = Groth16Prover(key.pk)
proof = prover.prove(key.witness, r=11, s=13)
want = testgen.expected_proof(key, tf.decode_ints(prover.last_h, tf.FR), 11, 13)
assert (proof.pi_a, proof.pi_b, proof.pi_c) == want, "proof differs from the dlog oracle"
loaded = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not loaded, loaded
print("NO_JAX_OK")
'''


def test_port_proves_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "NO_JAX_OK" in out.stdout
