"""Ceremony procurement + remote setup cache.

Mirrors the reference's release/caching tooling:

- `Releases` / `download_ceremony`: fetch a released trusted-setup ceremony
  (prover_key.zkey + verification_key.json + circuit_config.yaml) from a
  GitHub releases feed and install it into the content-addressed setup
  store (scripts/python/setups/gh_release.py:20-72, ceremony_setup.py:
  13-50). Unlike the reference we don't ship witness-generator binaries —
  witness generation is native (circuits/witness_engine.py,
  circuits/circom_witness.py).
- `cache_push` / `cache_pull`: tar.gz a whole setup directory to/from a
  remote cache location so one machine's procurement (circuit build +
  setup MSMs) serves a fleet (scripts/python/setups/cache.py:23-58's GCS
  bucket, generalized to file:// and https:// remotes — this image has no
  GCS SDK and zero egress, so the transport is injectable and file:// is
  first-class for tests/NFS).

Asset checksums are pinned the way the reference pins its ptau download
(testing_setup.py:15-17, :32-41): pass `checksums={asset: sha256hex}`; any
mismatch aborts the install.

A jax-free copy of keyless_zk_tpu/tooling/ceremony.py, on top of the port's
setup_tool.import_zkey/set_slot and its store (service.config
.DEFAULT_SETUP_ROOT, ~/.local/share/keyless_zk_tpu_torch/setups). The
default fetch is urllib's, which also reads file:// URLs.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tarfile
import tempfile
import urllib.request

from ..service.config import DEFAULT_SETUP_ROOT
from .setup_tool import import_zkey, set_slot

CEREMONY_ASSETS = (
    "prover_key.zkey",
    "verification_key.json",
    "circuit_config.yaml",
)


def _default_fetch(url: str, dest: str, auth_token: str | None = None) -> None:
    req = urllib.request.Request(url)
    if auth_token:
        req.add_header("Authorization", f"token {auth_token}")
        req.add_header("Accept", "application/octet-stream")
    with urllib.request.urlopen(req) as r, open(dest, "wb") as f:
        shutil.copyfileobj(r, f)


def _read_json(url: str, auth_token: str | None, fetch) -> object:
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "payload.json")
        fetch(url, p, auth_token)
        with open(p) as f:
            return json.load(f)


class ReleaseNotFound(Exception):
    pass


class ReleaseMissingRequiredAsset(Exception):
    pass


class Releases:
    """GitHub releases feed (gh_release.py:20-58), transport-injectable."""

    def __init__(
        self,
        repo: str = "aptos-labs/keyless-zk-proofs",
        auth_token: str | None = None,
        fetch=None,
        feed: list | None = None,
    ):
        self.auth_token = auth_token
        self.fetch = fetch or _default_fetch
        if feed is None:
            feed = _read_json(
                f"https://api.github.com/repos/{repo}/releases",
                auth_token,
                self.fetch,
            )
        self.data = sorted(feed, key=lambda r: r.get("created_at", ""))

    def release_names(self) -> list[str]:
        return [r["tag_name"] for r in self.data]

    def release_with_name(self, name: str) -> dict:
        for r in self.data:
            if r["tag_name"] == name:
                return r
        raise ReleaseNotFound(name)

    def get_assets(self, release_name: str, asset_names) -> list[dict]:
        release = self.release_with_name(release_name)
        out = []
        for want in asset_names:
            for asset in release.get("assets", ()):
                if asset["name"] == want:
                    out.append(asset)
                    break
            else:
                raise ReleaseMissingRequiredAsset(f"{release_name}: {want}")
        return out

    def download_assets(self, release_name: str, asset_names, dest_dir: str):
        for asset in self.get_assets(release_name, asset_names):
            url = asset["url"] if self.auth_token else asset["browser_download_url"]
            self.fetch(url, os.path.join(dest_dir, asset["name"]), self.auth_token)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def download_ceremony(
    release_name: str,
    root: str = DEFAULT_SETUP_ROOT,
    repo: str = "aptos-labs/keyless-zk-proofs",
    auth_token: str | None = None,
    checksums: dict[str, str] | None = None,
    releases: Releases | None = None,
    slot: str = "new",
) -> str:
    """Fetch a released ceremony and install it into the setup store.

    Returns the installed setup directory. The zkey lands content-addressed
    (import_zkey), so re-downloading an identical release is idempotent.
    """
    rel = releases or Releases(repo, auth_token)
    with tempfile.TemporaryDirectory() as td:
        rel.download_assets(release_name, CEREMONY_ASSETS, td)
        for asset, want in (checksums or {}).items():
            got = _file_sha256(os.path.join(td, asset))
            if got != want:
                raise ValueError(
                    f"checksum mismatch for {asset}: got {got}, pinned {want}"
                )
        # reference renames circuit_config.yaml -> .yml (ceremony_setup.py:50)
        return import_zkey(
            os.path.join(td, "prover_key.zkey"),
            vk_path=os.path.join(td, "verification_key.json"),
            circuit_config_path=os.path.join(td, "circuit_config.yaml"),
            root=root,
            slot=slot,
        )


# ---- remote setup cache (cache.py analog) -----------------------------------


def _remote_join(remote: str, name: str) -> str:
    return remote.rstrip("/") + "/" + name


def cache_push(setup_dir: str, remote: str) -> str:
    """tar.gz an installed setup and store it at the remote (file:// or a
    local path). Returns the blob location."""
    key = os.path.basename(os.path.normpath(setup_dir))
    if remote.startswith("file://"):
        remote = remote[len("file://"):]
    if "://" in remote:
        raise ValueError("push supports file:// / local-path remotes")
    os.makedirs(remote, exist_ok=True)
    blob = _remote_join(remote, key + ".tar.gz")
    tmp = blob + f".tmp{os.getpid()}"
    with tarfile.open(tmp, "w:gz") as tar:
        tar.add(setup_dir, arcname=key)
    os.replace(tmp, blob)
    return blob


def cache_pull(
    key: str,
    remote: str,
    root: str = DEFAULT_SETUP_ROOT,
    slot: str | None = None,
    fetch=None,
) -> str | None:
    """Fetch setup `key` from the remote cache into the local store.

    Returns the setup dir, or None when the blob isn't present (the caller
    then procures locally and cache_push-es, cache.py:23-58's flow)."""
    name = key + ".tar.gz"
    fetch = fetch or _default_fetch
    with tempfile.TemporaryDirectory() as td:
        local_blob = os.path.join(td, name)
        if remote.startswith(("http://", "https://")):
            try:
                fetch(_remote_join(remote, name), local_blob, None)
            except OSError:  # urllib's HTTPError/URLError among them: no such blob
                return None
        else:
            if remote.startswith("file://"):
                remote = remote[len("file://"):]
            src = _remote_join(remote, name)
            if not os.path.exists(src):
                return None
            shutil.copyfile(src, local_blob)
        os.makedirs(root, exist_ok=True)
        with tarfile.open(local_blob, "r:gz") as tar:
            tar.extractall(path=root, filter="data")
    target = os.path.join(root, key)
    if slot:
        set_slot(root, key, slot)
    return target
