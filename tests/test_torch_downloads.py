"""The port's checkpoint resolution and download half against the JAX
package's, with every hub call mocked (no network): the same local
resolution, the same hub dispatch and fallback, the same errors without
egress, the same manifests, and the download CLI's exit codes. Exact
equality throughout."""

import pytest

from acestep_tpu.utils import downloads as jdl
from acestep_tpu.utils import downloads_cli as jcli
from acestep_torch.utils import downloads as tdl
from acestep_torch.utils import downloads_cli as tcli

SIDES = {"jax": (jdl, jcli), "torch": (tdl, tcli)}


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Any probe or hub call a scenario does not mock fails loudly."""
    def refuse(*a, **k):
        raise AssertionError("network access attempted")

    for dl, _ in SIDES.values():
        monkeypatch.setattr(dl, "_probe", refuse)
        monkeypatch.setattr(dl, "_download_hf", refuse)
        monkeypatch.setattr(dl, "_download_modelscope", refuse)
        monkeypatch.setattr(dl, "_VERIFIED_DIRS", set())


def _local(dl, root):
    model = root / "acestep-v15-turbo"
    model.mkdir(parents=True)
    (model / "config.json").write_text("{}")
    (model / "model.safetensors").write_bytes(b"x")
    return (dl.ensure_model("acestep-v15-turbo", root=str(root),
                            allow_download=False) == str(model),
            dl.ensure_main_model(str(root)) == str(model),
            dl.resolve_local("acestep-v15-turbo", str(root)) == str(model))


def _no_egress(dl, root, monkeypatch, setup):
    monkeypatch.setattr(dl, "has_egress", lambda *a, **k: False)
    setup(root)
    with pytest.raises(FileNotFoundError) as err:
        dl.ensure_model("vae", root=str(root))
    return str(err.value).replace(str(root), "<root>")


def _smart(dl, root, monkeypatch, *, prefer=None, hf_ok=False, ms_ok=True,
           probe=True, env=None):
    calls = []

    def hub(name, ok):
        def fn(repo, target):
            calls.append((name, repo, target == str(root)))
            if not ok:
                raise RuntimeError(f"{name} 403")
        return fn

    monkeypatch.setattr(dl, "_download_hf", hub("hf", hf_ok))
    monkeypatch.setattr(dl, "_download_modelscope", hub("ms", ms_ok))
    monkeypatch.setattr(dl, "_probe", lambda *a, **k: probe)
    if env is None:
        monkeypatch.delenv("ACESTEP_DOWNLOAD_SOURCE", raising=False)
    else:
        monkeypatch.setenv("ACESTEP_DOWNLOAD_SOURCE", env)
    try:
        out = dl.smart_download("ACE-Step/x", str(root), prefer_source=prefer)
    except RuntimeError as e:
        out = ("error", str(e))
    return out, calls


def test_local_resolution_equal(tmp_path):
    got = {s: _local(dl, tmp_path / s) for s, (dl, _) in SIDES.items()}
    assert got["torch"] == got["jax"] == (True, True, True)


@pytest.mark.parametrize("case", ["missing", "empty_dir", "config_only"])
def test_no_egress_errors_equal(tmp_path, monkeypatch, case):
    def setup(root):
        root.mkdir(parents=True)
        if case != "missing":
            (root / "vae").mkdir()
        if case == "config_only":
            (root / "vae" / "config.json").write_text("{}")

    got = {s: _no_egress(dl, tmp_path / s, monkeypatch, setup)
           for s, (dl, _) in SIDES.items()}
    assert got["torch"] == got["jax"]
    assert "ACESTEP_CHECKPOINT_DIR" in got["torch"]
    assert "<root>/vae" in got["torch"]


@pytest.mark.parametrize("kw", [
    dict(),                                     # probe picks HF, falls back
    dict(probe=False),                          # probe fails: ModelScope first
    dict(prefer="modelscope"),
    dict(prefer="huggingface", hf_ok=True),
    dict(env="modelscope"),
    dict(ms_ok=False),                          # both fail
])
def test_smart_download_dispatch_equal(tmp_path, monkeypatch, kw):
    got = {s: _smart(dl, tmp_path, monkeypatch, **kw)
           for s, (dl, _) in SIDES.items()}
    assert got["torch"] == got["jax"]


def test_ensure_model_downloads_through_the_mocked_hub(tmp_path, monkeypatch):
    """With egress, ensure_model downloads into <root>/<name>.partial,
    writes the manifest and renames; the same files on both sides."""
    def run(dl, root):
        monkeypatch.setattr(dl, "has_egress", lambda *a, **k: True)
        monkeypatch.setattr(dl, "_probe", lambda *a, **k: True)

        def hf(repo, target):
            with open(f"{target}/model.safetensors", "wb") as f:
                f.write(repo.encode())

        monkeypatch.setattr(dl, "_download_hf", hf)
        path = dl.ensure_model("vae", root=str(root))
        return (path == str(root / "vae"), sorted(p.name for p in
                                                  (root / "vae").iterdir()),
                dl.verify_checkpoint(path))

    got = {s: run(dl, tmp_path / s) for s, (dl, _) in SIDES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == ["checksums.json", "model.safetensors"]


def test_manifest_and_corruption_equal(tmp_path):
    def run(dl, root):
        ckpt = root / "vae"
        ckpt.mkdir(parents=True)
        (ckpt / "model.safetensors").write_bytes(b"good")
        (ckpt / "config.json").write_text("{}")
        hashes = dl.write_manifest(str(ckpt))
        ok = dl.verify_checkpoint(str(ckpt))
        (ckpt / "model.safetensors").write_bytes(b"bad")
        bad = dl.verify_checkpoint(str(ckpt))
        with pytest.raises(RuntimeError, match="integrity"):
            dl.ensure_model("vae", root=str(root), allow_download=False)
        skip = dl.ensure_model("vae", root=str(root), allow_download=False,
                               verify=False) == str(ckpt)
        return hashes, ok, bad, skip

    got = {s: run(dl, tmp_path / s) for s, (dl, _) in SIDES.items()}
    assert got["torch"] == got["jax"]


def test_download_cli_equal(tmp_path, capsys):
    def run(cli, root):
        model = root / "acestep-v15-turbo"
        model.mkdir(parents=True)
        (model / "config.json").write_text("{}")
        (model / "model.safetensors").write_bytes(b"weights")
        rcs = [cli.main(["acestep-v15-turbo", "--root", str(root),
                         "--no-download", "--write-manifest", "--verify"])]
        out = capsys.readouterr().out.replace(str(root), "<root>")
        (model / "model.safetensors").write_bytes(b"tampered")
        rcs.append(cli.main(["acestep-v15-turbo", "--root", str(root),
                             "--no-download", "--verify"]))
        rcs.append(cli.main(["vae", "--root", str(root), "--no-download"]))
        err = capsys.readouterr().err.replace(str(root), "<root>")
        return rcs, out, err

    got = {s: run(cli, tmp_path / s) for s, (_, cli) in SIDES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [0, 1, 1]
    assert set(tdl.REPO_IDS) == set(jdl.REPO_IDS)
