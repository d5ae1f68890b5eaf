"""The port's snarkjs/circom file I/O against the JAX package's:

- `save_zkey`, `save_wtns` and `save_r1cs` write the bytes the JAX writers
  write for the same key, witness and R1CS (a synthetic key with points at
  infinity planted, the port's chain-circuit setup, the gadget circuit's
  R1CS in both wire orders);
- files from either package load in the other to equal arrays and vk
  tuples;
- loading a zkey writes nothing (no table cache, with HOME moved into the
  test's directory)."""

import dataclasses
import os

import numpy as np
import pytest

import keyless_gadget_circuit as kg
from keyless_zk_tpu.circuits import r1cs_file as jax_r1cs_file
from keyless_zk_tpu.groth16 import wtns as jax_wtns
from keyless_zk_tpu.groth16 import zkey as jax_zkey
from keyless_zk_tpu_torch.circuits import r1cs_file
from keyless_zk_tpu_torch.fields import bn254
from keyless_zk_tpu_torch.groth16 import wtns, zkey
from keyless_zk_tpu_torch.ops import testgen
from torch_io_fixtures import small_setup


def synthetic_pk():
    """A tiny synthetic key with rows at infinity planted in every table
    and IC points."""
    key = testgen.synthetic_key(4, n_vars=24, n_public=1, domain_pow=3, n_distinct_a=20, n_distinct_b=14,
                                n_coefs=40, device="cpu")
    pk = key.pk
    for name in ("points_a", "points_b1", "points_b2", "points_c", "points_h"):
        t = getattr(pk, name)
        inf = np.asarray(t.inf, bool).copy()
        inf[[1, -1]] = True
        setattr(pk, name, dataclasses.replace(t, inf=inf))
    return dataclasses.replace(pk, vk_ic=(pk.vk_alpha1, None))


KEYS = {"synthetic": synthetic_pk, "chain setup": lambda: small_setup()[3].pk}


def assert_keys_equal(a, b):
    for f in dataclasses.fields(zkey.ProvingKey):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name.startswith("points_"):
            for part in ("x", "y", "inf"):
                assert np.array_equal(getattr(x, part), getattr(y, part)), (f.name, part)
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def canonical(pk):
    """pk as a file holds it: coordinates zero at infinity."""
    out = dataclasses.replace(pk)
    for name in ("points_a", "points_b1", "points_b2", "points_c", "points_h"):
        t = getattr(pk, name)
        x, y = t.x.copy(), t.y.copy()
        x[t.inf], y[t.inf] = 0, 0
        setattr(out, name, dataclasses.replace(t, x=x, y=y))
    return out


@pytest.mark.parametrize("source", KEYS)
def test_zkey_bytes_equal_jax_and_files_cross(source, tmp_path):
    pk = KEYS[source]()
    mine, theirs = str(tmp_path / "port.zkey"), str(tmp_path / "jax.zkey")
    zkey.save_zkey(mine, pk)
    jax_zkey.save_zkey(theirs, pk)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    want = canonical(pk)
    assert_keys_equal(zkey.load_zkey(theirs), want)
    assert_keys_equal(jax_zkey.load_zkey(mine, cache=False), want)


def test_wtns_bytes_equal_jax_and_files_cross(tmp_path):
    _, w, _, _ = small_setup(with_ic=False)
    values = w + [bn254.R_SCALAR - 1, 0]
    mine, theirs = str(tmp_path / "port.wtns"), str(tmp_path / "jax.wtns")
    wtns.save_wtns(mine, wtns.witness_from_ints(values, bn254.R_SCALAR))
    jax_wtns.save_wtns(theirs, jax_wtns.witness_from_ints(values, bn254.R_SCALAR))
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    a, b = wtns.load_wtns(theirs), jax_wtns.load_wtns(mine)
    assert (a.n8, a.prime, a.n_vars) == (b.n8, b.prime, b.n_vars) == (32, bn254.R_SCALAR, len(values))
    assert np.array_equal(a.values, b.values)


@pytest.mark.parametrize("order", ["r1cs_from_cs", "r1cs_circom_order"])
def test_r1cs_bytes_equal_jax_and_files_cross(order, tmp_path):
    cs, _ = kg.build("keyless_zk_tpu_torch", "setup")
    jcs, _ = kg.build("keyless_zk_tpu", "setup")
    r = getattr(r1cs_file, order)(cs)
    jr = getattr(jax_r1cs_file, order)(jcs)
    if order == "r1cs_circom_order":
        (r, perm), (jr, jperm) = r, jr
        assert perm == jperm
    assert (r.A, r.B, r.C, r.n_pub_out, r.n_pub_in) == (jr.A, jr.B, jr.C, jr.n_pub_out, jr.n_pub_in)
    # a row out of wire order and a coefficient above the prime: both writers sort and reduce
    r.A[0] = dict(reversed(list({**r.A[0], 5: bn254.R_SCALAR + 3}.items())))
    mine, theirs = str(tmp_path / "port.r1cs"), str(tmp_path / "jax.r1cs")
    r1cs_file.save_r1cs(mine, r)
    jax_r1cs_file.save_r1cs(theirs, r)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    a, b = r1cs_file.load_r1cs(theirs), jax_r1cs_file.load_r1cs(mine)
    for x in (a, b):
        assert (x.n_wires, x.n_constraints, x.n_public) == (r.n_wires, r.n_constraints, r.n_public)
        assert x.A == [{k: v % bn254.R_SCALAR for k, v in row.items()} for row in r.A]
        assert (x.B, x.C) == (r.B, r.C)


def test_load_zkey_writes_nothing(tmp_path, monkeypatch):
    """The reader keeps no cache: loading a zkey leaves its directory and
    the home directory as they were."""
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    pk = synthetic_pk()
    path = str(tmp_path / "k.zkey")
    zkey.save_zkey(path, pk)
    assert_keys_equal(zkey.load_zkey(path), canonical(pk))
    assert sorted(os.listdir(tmp_path)) == ["home", "k.zkey"] and os.listdir(home) == []
