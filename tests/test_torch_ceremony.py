"""The port's ceremony download and remote setup cache
(keyless_zk_tpu_torch/tooling/ceremony.py), on a staged release feed whose
assets are a small chain setup made by the port (prover_key.zkey,
verification_key.json, a stand-in circuit_config.yaml):

- install through an injected fetch and through file:// URLs with the
  default (urllib) fetch: the store's files byte-equal to the assets, the
  config renamed .yml, the `new` slot, a second install idempotent; the JAX
  package's `download_ceremony` on the same feed installs the same
  directory name with the same bytes;
- checksum pinning: the right pins install, a wrong one raises and installs
  nothing;
- a missing release and a missing asset raise;
- cache_push / cache_pull round trip (plain paths, file:// and an http(s)
  remote through an injected fetch): byte-equal files, the slot set; a key
  the remote lacks gives None."""

import filecmp
import hashlib
import json
import os
import shutil

import pytest

from keyless_zk_tpu.tooling import ceremony as jax_ceremony
from keyless_zk_tpu_torch.groth16.zkey import save_zkey
from keyless_zk_tpu_torch.tooling import ceremony
from torch_io_fixtures import small_setup

ASSETS = ceremony.CEREMONY_ASSETS
STORE_NAMES = {"prover_key.zkey": "prover_key.zkey", "verification_key.json": "verification_key.json",
               "circuit_config.yaml": "circuit_config.yml"}


def copy_fetch(url, dest, auth_token=None):
    assert url.startswith("file://"), url
    shutil.copyfile(url[len("file://"):], dest)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """(assets dir, feed): one release, ceremony-v1, plus an older one
    without assets."""
    d = tmp_path_factory.mktemp("release") / "assets"
    d.mkdir()
    _, _, _, res = small_setup()
    save_zkey(str(d / "prover_key.zkey"), res.pk)
    with open(d / "verification_key.json", "w") as f:
        json.dump(res.vk, f)
    (d / "circuit_config.yaml").write_text("max_lengths: {}\nhas_input_skip_aud_checks: true\n")
    assets = [{"name": n, "browser_download_url": f"file://{d}/{n}", "url": f"file://{d}/{n}"} for n in ASSETS]
    feed = [{"tag_name": "ceremony-v1", "created_at": "2024-05-01T00:00:00Z", "assets": assets},
            {"tag_name": "ceremony-v0", "created_at": "2024-01-01T00:00:00Z", "assets": []}]
    return d, feed


def sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def assert_installed(path, assets_dir):
    assert sorted(os.listdir(path)) == sorted([".complete", *STORE_NAMES.values()])
    for asset, stored in STORE_NAMES.items():
        assert filecmp.cmp(os.path.join(assets_dir, asset), os.path.join(path, stored), shallow=False), asset


@pytest.mark.parametrize("fetch", [copy_fetch, None], ids=["injected_fetch", "urllib_file_urls"])
def test_download_ceremony_installs_the_release(release, tmp_path, fetch):
    assets_dir, feed = release
    rel = ceremony.Releases(feed=feed, fetch=fetch)
    assert rel.release_names() == ["ceremony-v0", "ceremony-v1"]
    root = str(tmp_path / "setups")
    path = ceremony.download_ceremony("ceremony-v1", root=root, releases=rel)
    assert_installed(path, assets_dir)
    assert os.path.basename(path) == "zkey-" + sha256(assets_dir / "prover_key.zkey")[:16]
    assert os.path.realpath(os.path.join(root, "new")) == os.path.realpath(path)
    assert ceremony.download_ceremony("ceremony-v1", root=root, releases=rel, slot="default") == path
    assert os.path.realpath(os.path.join(root, "default")) == os.path.realpath(path)


def test_jax_download_ceremony_installs_the_same_setup(release, tmp_path):
    assets_dir, feed = release
    path = ceremony.download_ceremony("ceremony-v1", root=str(tmp_path / "port"),
                                      releases=ceremony.Releases(feed=feed, fetch=copy_fetch))
    jpath = jax_ceremony.download_ceremony("ceremony-v1", root=str(tmp_path / "jax"),
                                           releases=jax_ceremony.Releases(feed=feed, fetch=copy_fetch))
    assert os.path.basename(path) == os.path.basename(jpath)
    for name in os.listdir(path):  # the JAX store also keeps its device-format table cache
        assert filecmp.cmp(os.path.join(path, name), os.path.join(jpath, name), shallow=False), name


def test_download_ceremony_checksum_pinning(release, tmp_path):
    assets_dir, feed = release
    rel = ceremony.Releases(feed=feed, fetch=copy_fetch)
    pins = {asset: sha256(assets_dir / asset) for asset in ASSETS}
    path = ceremony.download_ceremony("ceremony-v1", root=str(tmp_path / "good"), releases=rel, checksums=pins)
    assert_installed(path, assets_dir)
    root = tmp_path / "bad"
    for asset in ASSETS:
        with pytest.raises(ValueError, match=f"checksum mismatch for {asset}"):
            ceremony.download_ceremony("ceremony-v1", root=str(root), releases=rel,
                                       checksums=pins | {asset: "0" * 64})
    assert not root.exists(), "a setup was installed under a wrong pin"


def test_missing_release_and_asset(release, tmp_path):
    _, feed = release
    rel = ceremony.Releases(feed=feed, fetch=copy_fetch)
    with pytest.raises(ceremony.ReleaseNotFound):
        rel.release_with_name("nope")
    with pytest.raises(ceremony.ReleaseMissingRequiredAsset, match="wgen_c.zip"):
        rel.get_assets("ceremony-v1", ["prover_key.zkey", "wgen_c.zip"])
    with pytest.raises(ceremony.ReleaseMissingRequiredAsset, match="ceremony-v0"):
        ceremony.download_ceremony("ceremony-v0", root=str(tmp_path / "setups"), releases=rel)
    assert not (tmp_path / "setups").exists()


@pytest.mark.parametrize("scheme", ["path", "file", "https"])
def test_cache_push_pull_round_trip(release, tmp_path, scheme):
    assets_dir, feed = release
    setup = ceremony.download_ceremony("ceremony-v1", root=str(tmp_path / "host_a"),
                                       releases=ceremony.Releases(feed=feed, fetch=copy_fetch))
    key = os.path.basename(setup)
    remote_dir = tmp_path / "remote_cache"
    blob = ceremony.cache_push(setup, f"file://{remote_dir}" if scheme == "file" else str(remote_dir))
    assert blob == f"{remote_dir}/{key}.tar.gz" and os.path.exists(blob)
    fetched = []

    def http_fetch(url, dest, auth_token=None):
        fetched.append(url)
        name = url.rsplit("/", 1)[1]
        if not (remote_dir / name).exists():
            raise FileNotFoundError(url)  # urllib raises HTTPError, an OSError, for a 404
        shutil.copyfile(remote_dir / name, dest)

    remote = {"path": str(remote_dir), "file": f"file://{remote_dir}", "https": "https://setup-cache.invalid/c"}[scheme]
    root_b = str(tmp_path / "host_b")
    got = ceremony.cache_pull(key, remote, root=root_b, slot="default", fetch=http_fetch)
    assert got == os.path.join(root_b, key)
    assert not filecmp.dircmp(setup, got).diff_files and sorted(os.listdir(got)) == sorted(os.listdir(setup))
    assert_installed(got, assets_dir)
    assert os.path.realpath(os.path.join(root_b, "default")) == os.path.realpath(got)
    assert ceremony.cache_pull("zkey-deadbeef", remote, root=root_b, fetch=http_fetch) is None
    assert fetched == ([f"{remote}/{key}.tar.gz", f"{remote}/zkey-deadbeef.tar.gz"] if scheme == "https" else [])
    with pytest.raises(ValueError, match="push supports"):
        ceremony.cache_push(setup, "https://setup-cache.invalid/c")
