"""CLI: prove / verify with snarkjs artifacts.

Mirrors the reference's FullProver surface (rust-rapidsnark/src/lib.rs:45-98:
new(zkey) + prove(wtns) -> proof JSON) as a command line:

    python -m keyless_zk_tpu_torch.groth16.cli prove --zkey Z --wtns W [--vk VK] [--device cpu]
    python -m keyless_zk_tpu_torch.groth16.cli prove --zkey Z --r1cs R --input I [--sym S] [--vk VK] [--device cpu]
    python -m keyless_zk_tpu_torch.groth16.cli verify --vk VK --proof P --public I

`prove` prints the proof JSON and the public signals on stdout, and its
times and, with --vk, "verified: true|false" on stderr. It proves on the
card unless --device says otherwise. Without --wtns it solves the witness
in circom's wire order from a circom .r1cs and input.json
(circuits/circom_interop.py; --sym maps the inputs by signal name).

A jax-free copy of keyless_zk_tpu/groth16/cli.py.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .. import device as devices
from ..circuits.circom_interop import witness_from_input_json
from ..fields import bn254
from ..fields.limbs import limbs_to_ints
from .pairing import verify_groth16
from .prover import Groth16Prover
from .wtns import load_wtns, witness_from_ints
from .zkey import load_zkey


def _public_signals(pk, wtns) -> list[int]:
    return limbs_to_ints(wtns.values[1 : 1 + pk.n_public])


def _load_witness(args):
    """Witness from --wtns, or solved from --r1cs + --input (circom wire
    order, see circuits/circom_interop.py) when no .wtns is given."""
    if args.wtns:
        return load_wtns(args.wtns)
    w = witness_from_input_json(args.r1cs, args.input, args.sym)
    return witness_from_ints([int(x) for x in w], bn254.R_SCALAR)


def cmd_prove(args) -> int:
    if not args.wtns and not (args.r1cs and args.input):
        print("need --wtns, or --r1cs with --input", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    pk = load_zkey(args.zkey)
    wtns = _load_witness(args)
    prover = Groth16Prover(pk, args.device)
    t1 = time.monotonic()
    proof = prover.prove(wtns.values)
    t2 = time.monotonic()
    public_signals = [str(v) for v in _public_signals(pk, wtns)]
    print(json.dumps(proof.to_json_dict()))
    print(json.dumps(public_signals))
    print(f"setup: {t1 - t0:.3f}s  prove: {t2 - t1:.3f}s", file=sys.stderr)
    if args.vk:
        with open(args.vk) as f:
            vk = json.load(f)
        ok = verify_groth16(vk, _public_signals(pk, wtns), proof.to_json_dict())
        print(f"verified: {str(ok).lower()}", file=sys.stderr)
        return 0 if ok else 1
    return 0


def cmd_verify(args) -> int:
    with open(args.vk) as f:
        vk = json.load(f)
    with open(args.proof) as f:
        proof = json.load(f)
    with open(args.public) as f:
        public_inputs = [int(x) for x in json.load(f)]
    ok = verify_groth16(vk, public_inputs, proof)
    print(f"verified: {str(ok).lower()}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="keyless_zk_tpu_torch.groth16")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prove", help="produce a Groth16 proof from zkey + wtns")
    p.add_argument("--zkey", required=True)
    p.add_argument("--wtns", help="snarkjs witness file (as the reference consumes)")
    p.add_argument("--r1cs", help="circom .r1cs: solve the witness natively instead")
    p.add_argument("--input", help="circom input.json (with --r1cs)")
    p.add_argument("--sym", help="circom .sym table for input-name mapping")
    p.add_argument("--vk", help="snarkjs verification key JSON; verify after proving")
    p.add_argument("--device", default=devices.DEFAULT, help="torch device to prove on (default: the card)")
    p.set_defaults(fn=cmd_prove)
    v = sub.add_parser("verify", help="verify a snarkjs proof JSON")
    v.add_argument("--vk", required=True)
    v.add_argument("--proof", required=True)
    v.add_argument("--public", required=True)
    v.set_defaults(fn=cmd_verify)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
