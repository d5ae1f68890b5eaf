"""release-helper: generate keyless-config governance artifacts.

Mirror of release-helper/src/main.rs:31-310: the root-signer / multi-step
Move governance script embedding the new on-chain VK + training-wheels
pubkey, and the release YAML.

A jax-free copy of keyless_zk_tpu/tooling/release_helper.py over this
package's tooling/onchain_vk.py. Run as
`python -m keyless_zk_tpu_torch.tooling.release_helper generate-root-signer-script ...`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .onchain_vk import snarkjs_vk_to_onchain

_SCRIPT_TEMPLATE = """
script {{
    use aptos_framework::keyless_account;
    use aptos_framework::aptos_governance;
    use std::option;
    fun main({main_param}) {{
        let framework_signer = {signer_expr};

        let alpha_g1 = x"{alpha_g1}";
        let beta_g2 = x"{beta_g2}";
        let gamma_g2 = x"{gamma_g2}";
        let delta_g2 = x"{delta_g2}";
        let gamma_abc_g1 = vector[
            x"{ic0}",
            x"{ic1}",
        ];
        let vk = keyless_account::new_groth16_verification_key(alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc_g1);
        keyless_account::set_groth16_verification_key_for_next_epoch(&framework_signer, vk);
        let pk_bytes = x"{twpk}";
        keyless_account::update_training_wheels_for_next_epoch(&framework_signer, option::some(pk_bytes));
        aptos_governance::reconfigure(&framework_signer);
    }}
}}
"""

_RELEASE_YAML_TEMPLATE = """---
remote_endpoint: {remote_endpoint}
name: "keyless_config_update"
proposals:
  - name: keyless_config_update
    metadata:
      title: "Update to circuit release {tag} + training-wheel key ID {tw_key_id}"
      description: ""
    execution_mode: MultiStep
    update_sequence:
      - RawScript: aptos-move/aptos-release-builder/data/proposals/keyless-config-update.move
"""


def _strip0x(s: str) -> str:
    assert s.startswith("0x"), s
    return s[2:]


def generate_script_content(vk_json: dict, twpk_hex: str, root_signer: bool) -> str:
    """Move governance script (main.rs:207-265)."""
    vk = snarkjs_vk_to_onchain(vk_json)["data"]
    if root_signer:
        main_param = "core_resources: &signer"
        signer_expr = "aptos_governance::get_signer_testnet_only(core_resources, @0x1)"
    else:
        main_param = "proposal_id: u64"
        signer_expr = (
            "aptos_governance::resolve_multi_step_proposal(proposal_id, @0x1, {{ script_hash }},)"
        )
    return _SCRIPT_TEMPLATE.format(
        main_param=main_param,
        signer_expr=signer_expr,
        alpha_g1=_strip0x(vk["alpha_g1"]),
        beta_g2=_strip0x(vk["beta_g2"]),
        gamma_g2=_strip0x(vk["gamma_g2"]),
        delta_g2=_strip0x(vk["delta_g2"]),
        ic0=_strip0x(vk["gamma_abc_g1"][0]),
        ic1=_strip0x(vk["gamma_abc_g1"][1]),
        twpk=_strip0x(twpk_hex.strip()),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="keyless-zk-tpu-release-helper")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rs = sub.add_parser("generate-root-signer-script")
    rs.add_argument("--vk-path", required=True)
    rs.add_argument("--twpk-path", required=True)
    rs.add_argument("--out", required=True)

    gp = sub.add_parser("generate-proposal")
    gp.add_argument("--aptos-core-path", required=True)
    gp.add_argument("--vk-path", required=True)
    gp.add_argument("--twpk-path", required=True)
    gp.add_argument("--circuit-release-tag", required=True)
    gp.add_argument("--tw-key-id", required=True)
    gp.add_argument("--remote-endpoint", default="https://api.mainnet.aptoslabs.com")

    args = ap.parse_args(argv)
    with open(args.vk_path) as f:
        vk_json = json.load(f)
    with open(args.twpk_path) as f:
        twpk = f.read().strip()

    if args.cmd == "generate-root-signer-script":
        content = generate_script_content(vk_json, twpk, root_signer=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(content)
        print(f"Successfully generated root signer script at path: {args.out}")
    else:
        base = os.path.join(args.aptos_core_path, "aptos-move/aptos-release-builder/data")
        os.makedirs(os.path.join(base, "proposals"), exist_ok=True)
        with open(os.path.join(base, "keyless-config-update.yaml"), "w") as f:
            f.write(
                _RELEASE_YAML_TEMPLATE.format(
                    remote_endpoint=args.remote_endpoint,
                    tag=args.circuit_release_tag,
                    tw_key_id=args.tw_key_id,
                )
            )
        with open(os.path.join(base, "proposals/keyless-config-update.move"), "w") as f:
            f.write(generate_script_content(vk_json, twpk, root_signer=False))
        print("Successfully generated governance proposal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
