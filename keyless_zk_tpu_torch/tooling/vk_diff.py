"""vk-diff: compare a snarkjs VK against an on-chain (or file) VK.

Mirror of vk-diff/src/main.rs:24-142: converts both sides to the on-chain
representation and diffs them; exit code 1 on mismatch.  Sources may be
local files or URLs (the reference fetches the on-chain VK from
`https://api.{network}.aptoslabs.com/...`).

A jax-free copy of keyless_zk_tpu/tooling/vk_diff.py over this package's
tooling/onchain_vk.py. Run as
`python -m keyless_zk_tpu_torch.tooling.vk_diff --json VK --onchain-file F`.
"""

from __future__ import annotations

import argparse
import json
import sys

from .onchain_vk import snarkjs_vk_to_onchain

APTOS_VK_URL_TEMPLATE = (
    "https://api.{network}.aptoslabs.com/v1/accounts/0x1/resource/"
    "0x1::keyless_account::Groth16VerificationKey"
)


def _read_source(src: str) -> str:
    if src.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(src, timeout=15) as r:  # noqa: S310
            return r.read().decode()
    with open(src) as f:
        return f.read()


def diff_vks(snarkjs_vk: dict, onchain_vk: dict) -> list[str]:
    """Field-by-field differences (empty == match)."""
    ours = snarkjs_vk_to_onchain(snarkjs_vk)
    diffs = []
    theirs_data = onchain_vk.get("data", onchain_vk)
    for key in ("alpha_g1", "beta_g2", "delta_g2", "gamma_g2", "gamma_abc_g1"):
        if ours["data"][key] != theirs_data.get(key):
            diffs.append(
                f"{key}: local={ours['data'][key]} on-chain={theirs_data.get(key)}"
            )
    return diffs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="keyless-zk-tpu-vk-diff")
    ap.add_argument("--json", "-j", required=True, help="snarkjs VK JSON (path or URL)")
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--network", "-n", choices=["devnet", "testnet", "mainnet"])
    group.add_argument("--onchain-file", help="on-chain VK JSON from a file")
    ap.add_argument("--debug", "-d", action="store_true")
    args = ap.parse_args(argv)

    snarkjs_vk = json.loads(_read_source(args.json))
    if args.onchain_file:
        onchain = json.loads(_read_source(args.onchain_file))
    else:
        onchain = json.loads(
            _read_source(APTOS_VK_URL_TEMPLATE.format(network=args.network))
        )
    if args.debug:
        print(json.dumps(snarkjs_vk_to_onchain(snarkjs_vk), indent=2))

    diffs = diff_vks(snarkjs_vk, onchain)
    if diffs:
        for d in diffs:
            print(f"MISMATCH {d}")
        return 1
    print("The verification keys match!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
