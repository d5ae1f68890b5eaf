"""The bytes behind `msm_roofline`, counted from the key file: on a
container written here from the format itself, and on a key the
program's setup writes (cross-checked against its own loader's tables).
And the verification key read from the key file by the same parser, which
the judge holds the setup's verification_key.json to."""

import copy
import json
import struct

import numpy as np
import pytest

from zkbench import yardstick
from zkbench.reference import judge
from zkbench.reference.bn254 import Q


def _container(path, sections):
    with open(path, "wb") as f:
        f.write(b"zkey" + struct.pack("<II", 1, len(sections)))
        for s_type, payload in sections:
            f.write(struct.pack("<IQ", s_type, len(payload)))
            f.write(payload)


def _table(rng, n, width, dups, zeros):
    rows = rng.integers(1, 255, size=(n, width), dtype=np.uint8)
    for i in range(dups):  # row i + 1 repeats row 0
        rows[i + 1] = rows[0]
    rows[n - zeros:] = 0
    return rows, n - dups - zeros


def test_counts_distinct_points_from_the_format(tmp_path):
    rng = np.random.default_rng(5)
    n_vars, n_pub, domain = 40, 1, 64
    head = struct.pack("<I", 32) + bytes(32) + struct.pack("<I", 32) + bytes(32) + struct.pack("<III", n_vars, n_pub, domain)
    tables, want = {}, {}
    for name, s_type, width, n, dups, zeros in (("a", 5, 64, n_vars, 3, 2), ("b1", 6, 64, n_vars, 0, 5),
                                               ("b2", 7, 128, n_vars, 7, 1), ("c", 8, 64, n_vars - n_pub - 1, 2, 0),
                                               ("h", 9, 64, domain, 0, 0)):
        tables[s_type], want[name] = _table(rng, n, width, dups, zeros)
    path = tmp_path / "k.zkey"
    _container(path, [(1, struct.pack("<I", 1)), (2, head + bytes(640)), (3, b""), (4, struct.pack("<I", 0))]
               + [(s, t.tobytes()) for s, t in tables.items()])
    counts = yardstick.key_counts(path, tmp_path)
    assert counts == {"n_vars": n_vars, "n_public": n_pub, "domain_size": domain, "distinct": want}
    assert yardstick.key_counts(path, tmp_path) == counts  # from the kept counts
    points = sum(want[t] * (128 if t == "b2" else 64) for t in want)
    for b in (1, 8):
        assert yardstick.msm_floor_bytes(counts, b) == points + b * ((n_vars + domain) * 32 + 4 * 64 + 128)


def test_counts_match_the_programs_tables(tmp_path):
    from keyless_zk_tpu_torch.circuits import ConstraintSystem
    from keyless_zk_tpu_torch.circuits.r1cs_file import r1cs_from_cs
    from keyless_zk_tpu_torch.circuits.setup import groth16_setup
    from keyless_zk_tpu_torch.groth16.zkey import load_zkey, save_zkey

    cs = ConstraintSystem()
    x = cs.public_wire()
    y = cs.new_wire()
    for _ in range(5):  # repeated products: equal columns, equal points
        cs.mul(cs.lc(x), cs.lc(y))
    path = tmp_path / "k.zkey"
    save_zkey(str(path), groth16_setup(r1cs_from_cs(cs), device="cpu").pk)
    pk = load_zkey(str(path))
    counts = yardstick.key_counts(path)

    def distinct(t):
        flat = np.concatenate([t.x.reshape(len(t.inf), -1), t.y.reshape(len(t.inf), -1)], axis=1)[~t.inf]
        return len(np.unique(flat, axis=0))

    assert counts["n_vars"] == pk.n_vars and counts["domain_size"] == pk.domain_size
    assert counts["distinct"] == {k: distinct(getattr(pk, f"points_{k}")) for k in ("a", "b1", "b2", "c", "h")}


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3"])
def test_peak_table_names_the_card(kind):
    assert yardstick.HBM_BYTES_PER_S[kind] == 3.35e12


@pytest.fixture(scope="module")
def small_setup(tmp_path_factory):
    """A key file and its verification-key JSON as the program's setup
    writes them, for a circuit with one public input, and a copy of the
    key that carries the IC points in its section 3, as snarkjs writes it."""
    from keyless_zk_tpu_torch.circuits import ConstraintSystem
    from keyless_zk_tpu_torch.circuits.r1cs_file import r1cs_from_cs
    from keyless_zk_tpu_torch.circuits.setup import groth16_setup
    from keyless_zk_tpu_torch.groth16.zkey import save_zkey

    cs = ConstraintSystem()
    x = cs.public_wire()
    cs.mul(cs.lc(x), cs.lc(x))
    res = groth16_setup(r1cs_from_cs(cs), device="cpu")
    d = tmp_path_factory.mktemp("vk")
    path = d / "k.zkey"
    save_zkey(str(path), res.pk)
    vk = json.loads(json.dumps(res.vk))
    raw = path.read_bytes()
    secs = yardstick._sections(path)
    mont = lambda v: (int(v) << 256) % Q  # noqa: E731
    ic = b"".join(mont(p[0]).to_bytes(32, "little") + mont(p[1]).to_bytes(32, "little") for p in vk["IC"])
    with_ic = d / "with_ic.zkey"
    _container(with_ic, [(t, ic if t == 3 else raw[off:off + size]) for t, (off, size) in sorted(secs.items())])
    return path, with_ic, vk


@pytest.mark.parametrize("alter", [None, "vk_alpha_1", "vk_beta_2", "vk_gamma_2", "vk_delta_2", "IC"])
def test_the_vk_is_checked_against_the_key_it_came_with(small_setup, alter):
    path, with_ic, vk = small_setup
    assert yardstick.zkey_vk(path, Q)["ic"] == []  # the program's setup keeps the IC points apart
    if alter is not None:
        vk = copy.deepcopy(vk)
        target = vk[alter][-1] if alter == "IC" else vk[alter]
        if isinstance(target[0], list):
            target[0][0] = str((int(target[0][0]) + 1) % Q)
        else:
            target[0] = str((int(target[0]) + 1) % Q)
    assert judge.vk_mismatch(vk, yardstick.zkey_vk(with_ic, Q)) == (alter is not None)
    assert judge.vk_mismatch(vk, yardstick.zkey_vk(path, Q)) == (alter not in (None, "IC"))


def test_the_key_must_be_over_bn254(small_setup):
    with pytest.raises(ValueError):
        yardstick.zkey_vk(small_setup[0], Q - 2)
