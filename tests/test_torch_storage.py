"""The port's storage initializer (serve/storage.py) in the cases of the
JAX package's tests/test_storage.py, each outcome equal to the JAX
module's on the same inputs, and `--storage-uri` on the port's server:
a bundle directory served in place and a digest-pinned archive fetched
under $TMPDIR/tpk-models/<i> before it is registered."""

import hashlib
import json
import os
import tarfile
import tempfile
import urllib.request

import pytest

from kubeflow_tpu.serve import storage as jstorage
from kubeflow_tpu_torch.serve import server as tserver
from kubeflow_tpu_torch.serve import storage
from kubeflow_tpu_torch.serve.runtimes import export_for_serving


def _outcome(mod, uri, dest):
    """What `mod.download` does: ("ok", path relative to its root) or
    (exception type, message)."""
    try:
        return "ok", mod.download(uri, dest)
    except Exception as e:
        return type(e).__name__, str(e)


def test_local_dir_served_in_place(tmp_path):
    src = tmp_path / "model"
    src.mkdir()
    (src / "w.bin").write_bytes(b"weights")
    out = storage.download(str(src), str(tmp_path / "dest"))
    assert out == str(src)  # no copy for local dirs


def test_file_scheme_and_tar_extraction(tmp_path):
    src = tmp_path / "model"
    src.mkdir()
    (src / "w.bin").write_bytes(b"weights")
    tar = tmp_path / "model.tar"
    with tarfile.open(tar, "w") as tf:
        tf.add(src / "w.bin", arcname="w.bin")
    dest = tmp_path / "dest"
    out = storage.download(f"file://{tar}", str(dest))
    assert out == str(dest)
    assert (dest / "w.bin").read_bytes() == b"weights"


def test_pvc_scheme_resolves_under_root(tmp_path, monkeypatch):
    claim = tmp_path / "claims" / "models" / "m"
    claim.mkdir(parents=True)
    monkeypatch.setenv("TPK_PVC_ROOT", str(tmp_path / "claims"))
    out = storage.download("pvc://models/m", str(tmp_path / "dest"))
    assert out == str(claim)


def test_remote_schemes_refused_loudly(tmp_path):
    for scheme in storage.REMOTE_SCHEMES:
        with pytest.raises(NotImplementedError, match="egress"):
            storage.download(f"{scheme}bucket/model", str(tmp_path / "d"))


def test_digest_pinning(tmp_path):
    blob = tmp_path / "m.bin"
    blob.write_bytes(b"model bytes")
    good = hashlib.sha256(b"model bytes").hexdigest()
    out = storage.download(f"file://{blob}#sha256={good}",
                           str(tmp_path / "dest"))
    assert os.path.exists(os.path.join(out, "m.bin"))
    with pytest.raises(ValueError, match="digest mismatch"):
        storage.download(f"file://{blob}#sha256={'0' * 64}",
                         str(tmp_path / "dest2"))
    assert not os.path.exists(tmp_path / "dest2" / "m.bin")
    d = tmp_path / "dir"
    d.mkdir()
    with pytest.raises(ValueError, match="FILE source"):
        storage.download(f"{d}#sha256={good}", str(tmp_path / "dest3"))
    with pytest.raises(FileNotFoundError):
        storage.download(f"file://{blob}#md5=abc", str(tmp_path / "dest4"))
    with pytest.raises(ValueError, match="sha256"):
        storage.download("s3://bucket/model.tar#md5=abc",
                         str(tmp_path / "dest5"))
    with pytest.raises(ValueError, match="sha256"):
        storage.download(f"s3://bucket/model.tar#sha256={good[:10]}",
                         str(tmp_path / "dest6"))


def test_hash_in_filename_still_loads(tmp_path):
    blob = tmp_path / "ckpt#v2.bin"
    blob.write_bytes(b"model bytes")
    out = storage.download(str(blob), str(tmp_path / "dest"))
    assert os.path.exists(os.path.join(out, "ckpt#v2.bin"))
    good = hashlib.sha256(b"model bytes").hexdigest()
    out = storage.download(f"{blob}#sha256={good}", str(tmp_path / "dest2"))
    assert os.path.exists(os.path.join(out, "ckpt#v2.bin"))


@pytest.mark.parametrize("case", [
    "dir", "tar", "zip", "plain_file", "digest_ok", "digest_bad",
    "digest_dir", "md5_local", "missing", "s3", "gs_bad_pin", "https",
])
def test_outcomes_equal_the_jax_module(tmp_path, case):
    """The same uri under both modules: the same result (relative to each
    call's own destination) or the same error."""
    import zipfile

    src = tmp_path / "src"
    src.mkdir()
    (src / "w.bin").write_bytes(b"w")
    with tarfile.open(tmp_path / "m.tar", "w") as tf:
        tf.add(src / "w.bin", arcname="w.bin")
    with zipfile.ZipFile(tmp_path / "m.zip", "w") as zf:
        zf.write(src / "w.bin", arcname="w.bin")
    digest = hashlib.sha256((tmp_path / "m.tar").read_bytes()).hexdigest()
    uri = {"dir": str(src), "tar": f"file://{tmp_path}/m.tar",
           "zip": str(tmp_path / "m.zip"), "plain_file": str(src / "w.bin"),
           "digest_ok": f"{tmp_path}/m.tar#sha256={digest}",
           "digest_bad": f"{tmp_path}/m.tar#sha256={'f' * 64}",
           "digest_dir": f"{src}#sha256={digest}",
           "md5_local": f"{src}/w.bin#md5=1", "missing": str(tmp_path / "x"),
           "s3": "s3://b/m", "gs_bad_pin": "gs://b/m#sha256=12",
           "https": "https://h/m.tar"}[case]
    got = _outcome(storage, uri, str(tmp_path / "port"))
    ref = _outcome(jstorage, uri, str(tmp_path / "jax"))
    assert got[0] == ref[0]
    if got[0] == "ok":
        assert got[1].replace("port", "jax") == ref[1]
        if os.path.isdir(got[1]) and got[1] != str(src):
            assert sorted(os.listdir(got[1])) == sorted(os.listdir(ref[1]))
    else:
        assert got[1].replace("port", "jax") == ref[1].replace("port", "jax")


GEN = {"slots": 1, "max_len": 32, "chunk": 4, "prefill_buckets": [8]}


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _generate(base, name, ids):
    req = urllib.request.Request(
        f"{base}/v1/models/{name}:generate", method="POST",
        data=json.dumps({"input_ids": ids, "max_tokens": 4}).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_server_storage_uri(tmp_path, monkeypatch, capsys):
    """--storage-uri beside --model-dir: a directory served in place and a
    pinned tarball extracted under $TMPDIR/tpk-models/1; all three models
    answer, and the two copies of one bundle give the same ids."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    kw = dict(model="llama_tiny", seed=3, extra={"generative": GEN},
              model_kwargs={"dtype": "float32", "num_layers": 1})
    a = export_for_serving(str(tmp_path / "a"), **kw)
    b = export_for_serving(str(tmp_path / "b"), **kw)
    tar = tmp_path / "b.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        tf.add(os.path.join(b, "model.json"), arcname="model.json")
    digest = hashlib.sha256(tar.read_bytes()).hexdigest()
    server, port = tserver.start([
        "--model-dir", a, "--storage-uri", f"file://{a}",
        "--storage-uri", f"file://{tar}#sha256={digest}",
        "--name", "m0", "--name", "m1", "--name", "m2",
        "--port", "0", "--host", "127.0.0.1", "--device", "cpu"])
    base = f"http://127.0.0.1:{port}"
    try:
        assert _get(f"{base}/v1/models")["models"] == ["m0", "m1", "m2"]
        assert server.repo.model_dir("m1") == a
        fetched = os.path.join(str(tmp_path / "tmp"), "tpk-models", "1")
        assert server.repo.model_dir("m2") == fetched
        assert os.path.exists(os.path.join(fetched, "model.json"))
        outs = [_generate(base, n, [5, 9, 2])["output_ids"]
                for n in ("m0", "m1", "m2")]
        assert outs[0] == outs[1] == outs[2]
    finally:
        server.stop()
    events = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert [e["event"] for e in events] == ["model_loaded"] * 3 + ["serving"]


def test_server_needs_a_model(capsys):
    with pytest.raises(SystemExit):
        tserver.start(["--device", "cpu"])
    assert "--storage-uri" in capsys.readouterr().err
    with pytest.raises(ValueError, match="digest mismatch"):
        tserver.start(["--storage-uri", f"{__file__}#sha256={'0' * 64}",
                       "--device", "cpu"])
