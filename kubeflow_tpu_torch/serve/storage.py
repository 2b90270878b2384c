"""Storage initializer: KServe's model-download initContainer, in-process.

The port's copy of `kubeflow_tpu/serve/storage.py` (that module imports
nothing of JAX; this package keeps its own copy all the same). The
reference runs ⟨kserve: python/kserve/kserve/storage — Storage.download⟩ as
an initContainer pulling s3/gcs/pvc/http URIs to /mnt/models before the
server starts. Local schemes are real; remote schemes fail with a clear
error instead of a silent stub (this build has no network egress): the
`download()` signature and the archive/dir handling match the reference's
contract so a networked fetcher can slot in behind the same call.

Integrity: `uri` may carry a digest fragment `#sha256=<hex>` (the OCI/
KServe-style pinning). For file/pvc sources the materialized file is
hashed and a mismatch fails loudly BEFORE anything is extracted — a
corrupt or swapped model must never reach the server. Directories cannot
be digest-pinned (no canonical serialization); passing a digest for a
directory is an error rather than a silent skip.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import tarfile
import zipfile

LOCAL_SCHEMES = ("file://", "pvc://", "")
REMOTE_SCHEMES = ("s3://", "gs://", "gcs://", "http://", "https://", "hdfs://")


def _split_digest(uri: str) -> tuple[str, str | None]:
    """Split a trailing `#sha256=<64-hex>` digest pin off `uri`.

    Only a fragment that is EXACTLY a sha256 digest counts as a pin.
    On remote URIs ANY other fragment (`#md5=...`, truncated/typo'd hex,
    empty) is a loud ValueError — the user clearly intended an integrity
    pin and silently shipping it to the store as part of the key would
    drop it. On local paths anything else is part of the filename ('#'
    is legal there, e.g. `data#v2/model.tar`) and a bad path already
    fails loudly as FileNotFoundError."""
    base, sep, frag = uri.rpartition("#")
    if sep and re.fullmatch(r"sha256=[0-9a-fA-F]{64}", frag):
        return base, frag[len("sha256="):].lower()
    if sep and uri.startswith(REMOTE_SCHEMES):
        raise ValueError(
            f"unsupported digest fragment {frag!r} (use #sha256=<64-hex>)")
    return uri, None


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(uri: str, dest: str) -> str:
    """Materializes `uri` under `dest`; returns the model directory path."""
    os.makedirs(dest, exist_ok=True)
    uri, digest = _split_digest(uri)
    for scheme in REMOTE_SCHEMES:
        if uri.startswith(scheme):
            raise NotImplementedError(
                f"remote storage {scheme} requires network egress; mount the "
                f"model locally and use file:// (reference parity: KServe "
                f"storage-initializer would fetch this)")
    path = uri[len("file://"):] if uri.startswith("file://") else uri
    if uri.startswith("pvc://"):
        # pvc://{claim}/{path} — claims are mounted under $TPK_PVC_ROOT.
        root = os.environ.get("TPK_PVC_ROOT", "/mnt/pvc")
        path = os.path.join(root, uri[len("pvc://"):])
    if not os.path.exists(path):
        raise FileNotFoundError(f"model uri {uri!r} -> {path!r} not found")
    if os.path.isdir(path):
        if digest:
            raise ValueError(
                f"digest pinning needs a FILE source; {path!r} is a "
                "directory (no canonical bytes to hash)")
        return path  # local dirs are served in place, no copy
    if digest:
        got = _sha256_file(path)
        if got != digest:
            raise ValueError(
                f"model digest mismatch for {uri!r}: expected sha256 "
                f"{digest}, file hashes {got} — refusing to serve a "
                "corrupt/swapped model")
    if tarfile.is_tarfile(path):
        with tarfile.open(path) as tf:
            tf.extractall(dest, filter="data")
        return dest
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            zf.extractall(dest)
        return dest
    shutil.copy2(path, dest)
    return dest
