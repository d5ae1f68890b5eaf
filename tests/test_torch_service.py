"""The port's prover service (keyless_zk_tpu_torch/service) against the JAX
package's (keyless_zk_tpu/service), with test JWTs from the port's seeded
generator handed to both as the same JWT string:

- the endpoints answer with the same status, headers and body;
- request validation accepts and rejects the same requests with the same
  messages (the cases of tests/test_service.py);
- `success_response`, BCS, on-chain point compression and Ed25519 are
  byte-equal on seeded inputs;
- the metrics exposition, the HTTP back-pressure gate, the native-pairing
  guard, the config's unimplemented settings refused and its batch
  settings accepted as the JAX package accepts them;
- the prove pipeline end to end over HTTP on the CPU, with a stand-in
  circuit that takes the keyless inputs and exposes their public-inputs
  hash: 200, a proof that verifies, a training-wheels signature that
  verifies, the nine phases timed; and with `batch_proving`, two requests
  at once through the BatchProver, both 200 and verifying."""

import dataclasses
import http.client
import json
import random
import threading
import time
import unittest.mock as mock

import pytest

from keyless_zk_tpu.curves import ref_curve as jax_curve
from keyless_zk_tpu.service import bcs as jax_bcs
from keyless_zk_tpu.service import handler as jax_handler
from keyless_zk_tpu.service import metrics as jax_metrics
from keyless_zk_tpu.service import types as jax_types
from keyless_zk_tpu.service.config import ProverServiceConfig as JaxConfig
from keyless_zk_tpu.service.jwk import RsaJwk as JaxRsaJwk
from keyless_zk_tpu.service.prover_state import ProverServiceState as JaxState
from keyless_zk_tpu.service.training_wheels import preprocess_and_validate_request as jax_validate
from keyless_zk_tpu.tooling import onchain_vk as jax_onchain
from keyless_zk_tpu.utils import ed25519 as jax_ed25519
from keyless_zk_tpu_torch.circuits import ConstraintSystem
from keyless_zk_tpu_torch.groth16 import pairing_native, verify_groth16
from keyless_zk_tpu_torch.input_processing.testjwt import EPK_BLINDER, EXP_HORIZON, IAT, make_test_jwt, prove_request
from keyless_zk_tpu_torch.service import bcs, handler, metrics, prover_state, server, types
from keyless_zk_tpu_torch.service.config import ProverServiceConfig
from keyless_zk_tpu_torch.service.jwk import RsaJwk
from keyless_zk_tpu_torch.service.prover_state import ProverServiceState
from keyless_zk_tpu_torch.service.training_wheels import preprocess_and_validate_request
from keyless_zk_tpu_torch.tooling import onchain_vk
from keyless_zk_tpu_torch.utils import ed25519
from test_keyless_circuit import SMALL as JAX_SMALL
from torch_keyless_fixtures import SMALL


def states(tj=None):
    """(port state, JAX state) at the SMALL configuration, the same setup
    root, and with `tj`'s RSA key in both JWK caches."""
    mine = ProverServiceState.new_for_testing(keyless_config=SMALL, device="cpu")
    theirs = JaxState.new_for_testing(keyless_config=JAX_SMALL)
    theirs.config.resources_dir = mine.config.resources_dir
    if tj is not None:
        iss, kid = tj.vi.jwt.payload.iss, tj.vi.jwt.header.kid
        mine.jwk_cache.insert(iss, RsaJwk(kid=kid, n=tj.rsa_key.n))
        theirs.jwk_cache.insert(iss, JaxRsaJwk(kid=kid, n=tj.rsa_key.n))
    return mine, theirs


class StandIn:
    """A prover that is there (so /v0/prove gets past its first check)."""


ENDPOINTS = {
    "healthcheck": ("GET", "/healthcheck", b"", False),
    "about": ("GET", "/about", b"", False),
    "config": ("GET", "/config", b"", False),
    "cached jwk": ("GET", "/cached/jwk", b"", False),
    "options": ("OPTIONS", "/v0/prove", b"", False),
    "unknown path": ("GET", "/nope", b"", False),
    "prove, no prover": ("POST", "/v0/prove", b"{}", False),
    "prove, bad json": ("POST", "/v0/prove", b"not json", True),
    "prove, missing field": ("POST", "/v0/prove", b'{"jwt_b64": "x"}', True),
}


@pytest.mark.parametrize("name", ENDPOINTS)
def test_endpoints_answer_as_jax(name):
    method, path, body, stand_in = ENDPOINTS[name]
    mine, theirs = states(make_test_jwt(seed=0))
    if stand_in:
        mine.prover, mine.witness_prog = StandIn(), StandIn()
        theirs.prover, theirs.cs = StandIn(), StandIn()
    got = handler.handle_request(mine, method, path, body)
    want = jax_handler.handle_request(theirs, method, path, body)
    if path == "/about":  # the build package is named after each package
        assert got[2].pop("build_package") == "keyless-zk-tpu-torch"
        assert want[2].pop("build_package") == "keyless-zk-tpu"
    assert got == want


def _mutations():
    return {
        "good": (lambda d: None, 100),
        "signature": (lambda d: d.update(jwt_b64=d["jwt_b64"][:-8] + "AAAAAAAA"), 100),
        "nonce": (lambda d: d.update(epk_blinder=(EPK_BLINDER + 1).to_bytes(31, "little").hex()), 100),
        "horizon": (lambda d: d.update(exp_date_secs=IAT + EXP_HORIZON + 1), 100),
        "uid key": (lambda d: d.update(uid_key="phone"), 100),
        "future iat": (lambda d: None, -3600),
        "unknown kid": (lambda d: d.update(jwt_b64=make_test_jwt(seed=0, kid="other").jwt_str), 100),
        "missing field": (lambda d: d.pop("pepper"), 100),
    }


@pytest.mark.parametrize("case", _mutations())
def test_validation_matches_jax(case):
    mutate, dt = _mutations()[case]
    tj = make_test_jwt(seed=0)
    mine, theirs = states(tj)
    d = prove_request(tj)
    mutate(d)

    def outcome(req_cls, validate, cache, bad):
        try:
            vi = validate(req_cls.from_json_dict(dict(d)), cache, now_secs=IAT + dt)
        except bad as e:
            return ("rejected", str(e))
        return ("accepted", vi.uid_val, vi.pubkey_modulus, vi.epk_bytes, vi.pepper_fr, vi.exp_date_secs,
                vi.jwt_parts.unsigned_undecoded())

    got = outcome(types.RequestInput, preprocess_and_validate_request, mine.jwk_cache, types.BadRequest)
    want = outcome(jax_types.RequestInput, jax_validate, theirs.jwk_cache, jax_types.BadRequest)
    assert got == want
    assert got[0] == ("accepted" if case == "good" else "rejected")


def _proof_json(seed: int) -> dict:
    rng = random.Random(seed)
    a = jax_curve.G1.mul(jax_curve.G1_GEN, rng.randrange(1, 1 << 250))
    b = jax_curve.G2.mul(jax_curve.G2_GEN, rng.randrange(1, 1 << 250))
    c = jax_curve.G1.mul(jax_curve.G1_GEN, rng.randrange(1, 1 << 250))
    return {"pi_a": [str(a[0]), str(a[1]), "1"],
            "pi_b": [[str(b[0][0]), str(b[0][1])], [str(b[1][0]), str(b[1][1])], ["1", "0"]],
            "pi_c": [str(c[0]), str(c[1]), "1"], "protocol": "groth16"}


@pytest.mark.parametrize("seed", [1, 2])
def test_response_bcs_compression_and_signatures_byte_equal(seed):
    rng = random.Random(seed)
    proof = _proof_json(seed)
    pih = rng.randrange(1 << 254)
    sk = rng.randbytes(32)
    msg = bcs.proof_and_statement_signing_message(proof, pih)
    assert msg == jax_bcs.proof_and_statement_signing_message(proof, pih) and len(msg) == 192
    assert ed25519.public_key(sk) == jax_ed25519.public_key(sk)
    sig = ed25519.sign(sk, msg)
    assert sig == jax_ed25519.sign(sk, msg)
    assert ed25519.verify(ed25519.public_key(sk), msg, sig)
    assert not ed25519.verify(ed25519.public_key(sk), msg[:-1] + bytes([msg[-1] ^ 1]), sig)
    tw = bcs.ephemeral_signature_bcs(sig)
    assert tw == jax_bcs.ephemeral_signature_bcs(sig) and bcs.ephemeral_signature_from_bcs(tw) == sig
    assert types.success_response(proof, pih, tw.hex()) == jax_types.success_response(proof, pih, tw.hex())
    assert [bcs.uleb128(n) for n in (0, 127, 128, 300, 1 << 35)] == [
        jax_bcs.uleb128(n) for n in (0, 127, 128, 300, 1 << 35)]
    a = (int(proof["pi_a"][0]), int(proof["pi_a"][1]))
    b = tuple((int(x), int(y)) for x, y in proof["pi_b"][:2])
    for pt, comp, decomp, jcomp in ((a, onchain_vk.compress_g1, onchain_vk.decompress_g1, jax_onchain.compress_g1),
                                    (b, onchain_vk.compress_g2, onchain_vk.decompress_g2, jax_onchain.compress_g2)):
        enc = comp(pt)
        assert enc == jcomp(pt) and decomp(enc) == pt
        assert comp(None) == jcomp(None) and decomp(comp(None)) is None


def test_onchain_vk_matches_jax():
    from torch_io_fixtures import small_setup

    _, _, _, res = small_setup()
    vk = onchain_vk.vk_json_from_pk(res.pk)
    assert vk == jax_onchain.vk_json_from_pk(res.pk) == res.vk
    assert onchain_vk.snarkjs_vk_to_onchain(vk) == jax_onchain.snarkjs_vk_to_onchain(vk)


def test_metrics_exposition_matches_jax():
    assert metrics.PROVE_PHASES == jax_metrics.PROVE_PHASES and len(metrics.PROVE_PHASES) == 9
    texts = []
    for mod in (metrics, jax_metrics):
        reg = mod.Registry()
        h = reg.histogram("x_seconds", "help", ("phase",))
        c = reg.counter("x_total", "help", ("outcome",))
        for i, v in enumerate((1e-6, 0.003, 0.5, 40.0)):
            h.observe(v, phase=mod.PROVE_PHASES[i])
        c.inc(outcome="success")
        texts.append(reg.expose())
    assert texts[0] == texts[1]
    metrics.REQUEST_HANDLING_SECONDS.observe(0.01, endpoint="/healthcheck", method="GET", code="200")
    text = metrics.REGISTRY.expose()
    assert "keyless_prover_service_request_handling_seconds_bucket" in text and 'endpoint="/healthcheck"' in text


def test_config_yaml_matches_jax(tmp_path):
    p = tmp_path / "cfg.yml"
    p.write_text("port: 9000\nmetrics_port: 9200\noidc_providers:\n  - iss: a\n    endpoint_url: b\n")
    assert dataclasses.asdict(ProverServiceConfig.from_yaml(str(p))) == {
        **dataclasses.asdict(JaxConfig.from_yaml(str(p))), "resources_dir": ProverServiceConfig().resources_dir}
    assert ProverServiceConfig().resources_dir.endswith("/.local/share/keyless_zk_tpu_torch/setups")
    p.write_text("no_such_field: 1\n")
    with pytest.raises(ValueError, match="unknown config fields"):
        ProverServiceConfig.from_yaml(str(p))


@pytest.mark.parametrize("line", ["enable_test_provider: true", "enable_federated_jwks: true",
                                  "batch_proving: true", "max_batch: 4"])
def test_unimplemented_config_field_is_refused(tmp_path, line):
    """The JAX package accepts these settings. The port refuses any value
    but the default where nothing here acts on it (the test provider,
    federated JWKs), and takes the batch settings as the JAX config does."""
    p = tmp_path / "cfg.yml"
    p.write_text(line + "\n")
    theirs = JaxConfig.from_yaml(str(p))
    name = line.split(":")[0]
    if name in ("batch_proving", "max_batch"):
        assert getattr(ProverServiceConfig.from_yaml(str(p)), name) == getattr(theirs, name)
        return
    with pytest.raises(ValueError, match="unsupported config: " + name):
        ProverServiceConfig.from_yaml(str(p))


def test_batch_proving_is_refused_at_start(monkeypatch):
    """A batch of fewer than one proof is refused at start. With
    `batch_proving` and a batch size, the start builds a BatchProver around
    the prover, and two requests at once go through it without the
    prover's lock: both 200, their proofs and signatures verifying."""
    state = ProverServiceState.new_for_testing(keyless_config=SMALL, device="cpu")
    state.config.batch_proving, state.config.max_batch = True, 0
    built = []
    monkeypatch.setattr(prover_state, "build_keyless_circuit", lambda kc: built.append(kc) or stand_in_circuit())
    for persist in (False, True):
        with pytest.raises(ValueError, match="unsupported config: max_batch: 0"):
            state.init_prover_from_native_setup(persist=persist)
    assert not built and state.prover is None

    state.config.max_batch = 4
    jwts = [make_test_jwt(seed=s, kid=f"k{s}") for s in (6, 7)]
    for tj in jwts:
        state.jwk_cache.insert(tj.vi.jwt.payload.iss, RsaJwk(kid=tj.vi.jwt.header.kid, n=tj.rsa_key.n))
    state.init_prover_from_native_setup()
    assert state.batch_prover is not None and state.batch_prover.max_batch == 4
    assert state.batch_prover.prover is state.prover
    monkeypatch.setattr(state, "prove_lock", None)  # the batched path takes no lock
    srv = server.start_prover_service(state, 0, host="127.0.0.1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    results = {}

    def post(i):
        results[i] = _post_prove(srv.server_address[1], jwts[i])

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        srv.shutdown()
        srv.server_close()
        state.batch_prover.shutdown()
    for i in range(2):
        _check_prove_response(state, *results[i])
    sizes = list(state.batch_prover.batch_sizes)  # together, or one after the other
    assert sizes in ([2], [1, 1])
    assert [b["batch_size"] for b in list(state.breakdowns)[-2:]] == [max(sizes)] * 2


def test_http_backpressure_gate():
    """One slot: a second request while it is held answers 503 with
    Retry-After; the next one after it is released answers 200."""
    state = ProverServiceState.new_for_testing(keyless_config=SMALL, device="cpu")
    entered, release = threading.Event(), threading.Event()
    real = handler.handle_request

    def slow(st, method, path, body):
        if path == "/slow":
            entered.set()  # /slow holds the slot from here until released
            release.wait(10)
            return 200, {}, {"status": "ok"}
        return real(st, method, path, body)

    with mock.patch.object(server, "handle_request", slow):
        srv = server.ThreadingHTTPServer(("127.0.0.1", 0), server._make_handler(state, max_inflight=1,
                                                                              request_timeout=5))
        port = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            c1 = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            c1.request("GET", "/slow")
            assert entered.wait(10)
            c2 = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            c2.request("GET", "/healthcheck")
            r2 = c2.getresponse()
            assert (r2.status, r2.getheader("Retry-After")) == (503, "1")
            r2.read()
            release.set()
            r1 = c1.getresponse()
            assert r1.status == 200
            r1.read()
            # the server frees the slot after it has written /slow's response,
            # so the client may read it first: wait a bounded time for the
            # slot, then the request must be answered 200
            deadline = time.monotonic() + 5
            while True:
                c3 = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                c3.request("GET", "/healthcheck")
                r3 = c3.getresponse()
                r3.read()
                if r3.status != 503 or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            assert r3.status == 200
        finally:
            release.set()
            srv.shutdown()
            srv.server_close()


def test_native_pairing_guard(monkeypatch, capsys):
    """Without the native pairing the service says so (WARN line, backend
    metric) and, under require_native_pairing, fails its healthcheck."""
    state = ProverServiceState.new_for_testing(keyless_config=SMALL, device="cpu")
    state.config.require_native_pairing = True
    monkeypatch.setattr(pairing_native, "available", lambda: False)
    assert state.check_pairing_backend() == "python_fallback"
    err = capsys.readouterr().err
    assert "native pairing" in err and "WARN" in err
    assert metrics.PAIRING_BACKEND._values.get(("python_fallback",), 0) >= 1
    code, _, payload = handler.handle_request(state, "GET", "/healthcheck", b"")
    assert code == 503 and payload["status"] == "unhealthy"
    monkeypatch.setattr(pairing_native, "available", lambda: True)
    assert state.check_pairing_backend() == "native"
    assert handler.handle_request(state, "GET", "/healthcheck", b"")[0] == 200
    monkeypatch.setattr(pairing_native, "available", lambda: False)
    state.config.require_native_pairing = False
    state.check_pairing_backend()
    assert handler.handle_request(state, "GET", "/healthcheck", b"")[0] == 200


def stand_in_circuit():
    """A circuit whose one public wire is the keyless input
    `public_inputs_hash` (and one product of it): the service's pipeline
    runs unchanged on it, and its proofs verify against the hash."""
    cs = ConstraintSystem()
    x = cs.public_wire()
    cs.set_input_hint([x], "public_inputs_hash")
    cs.mul(cs.lc(x), cs.lc(x))
    return cs


def _post_prove(port: int, tj) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v0/prove", body=json.dumps(prove_request(tj)).encode())
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _check_prove_response(state, status, payload):
    """200, a proof that verifies against the response's public-inputs hash
    (and not against another), a training-wheels signature that verifies."""
    assert status == 200, payload
    pih_bytes = bytes.fromhex(payload["public_inputs_hash"])
    pih = int.from_bytes(pih_bytes, "little")
    a = onchain_vk.decompress_g1(bytes(payload["proof"]["a"]))
    b = onchain_vk.decompress_g2(bytes(payload["proof"]["b"]))
    c = onchain_vk.decompress_g1(bytes(payload["proof"]["c"]))
    proof = {"pi_a": [str(a[0]), str(a[1]), "1"],
             "pi_b": [[str(b[0][0]), str(b[0][1])], [str(b[1][0]), str(b[1][1])], ["1", "0"]],
             "pi_c": [str(c[0]), str(c[1]), "1"]}
    assert verify_groth16(state.vk, [pih], proof)
    assert not verify_groth16(state.vk, [pih + 1], proof)
    msg = bcs.GROTH16_PROOF_AND_STATEMENT_SEED + bytes(payload["proof"]["a"]) + bytes(payload["proof"]["b"]) \
        + bytes(payload["proof"]["c"]) + pih_bytes
    sig = bcs.ephemeral_signature_from_bcs(bytes.fromhex(payload["training_wheels_signature"]))
    assert ed25519.verify(state.tw_keypair.pk, msg, sig)


def test_prove_pipeline_over_http(monkeypatch):
    tj = make_test_jwt(seed=5, kid="k5")
    state = ProverServiceState.new_for_testing(keyless_config=SMALL, device="cpu")
    state.jwk_cache.insert(tj.vi.jwt.payload.iss, RsaJwk(kid="k5", n=tj.rsa_key.n))
    monkeypatch.setattr(prover_state, "build_keyless_circuit", lambda kc: stand_in_circuit())
    state.init_prover_from_native_setup()
    assert set(state.startup_s) == {"circuit_build", "witness_program_compile", "setup", "prover_construction"}
    assert state.batch_prover is None
    srv = server.start_prover_service(state, 0, host="127.0.0.1")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        status, payload = _post_prove(srv.server_address[1], tj)
    finally:
        srv.shutdown()
        srv.server_close()
    _check_prove_response(state, status, payload)
    assert list(state.breakdowns[-1]["phases_ms"]) == list(metrics.PROVE_PHASES)
    assert state.breakdowns[-1]["batch_size"] == 1
