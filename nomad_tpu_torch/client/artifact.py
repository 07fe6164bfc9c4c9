"""Artifact fetching for task prestart (ref
client/allocrunner/taskrunner/artifact_hook.go + the go-getter subset the
jobspec exposes: http/https/file sources, checksum verification, archive
unpacking).

A job declares artifacts per task:

    artifact { source = "https://example.com/tool.tar.gz"
               destination = "local/bin"
               options { checksum = "sha256:abc..." } }

The fetcher downloads (or copies) the source into the task directory,
verifies any declared checksum, and unpacks recognized archives unless
`options.archive = "false"` — matching go-getter's default-unpack
behavior the reference relies on.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import urllib.parse
import urllib.request
import zipfile


class ArtifactError(Exception):
    pass


_ARCHIVE_EXTS = (".tar.gz", ".tgz", ".tar.bz2", ".tbz2", ".tar.xz",
                 ".txz", ".tar", ".zip")


def _confined(root: str, target: str) -> bool:
    """True when realpath(target) stays inside realpath(root) — the one
    sandbox rule for destinations, tar members/links and zip members
    (sibling-prefix dirs like root + '-evil' must not pass)."""
    root_real = os.path.realpath(root)
    target_real = os.path.realpath(target)
    return target_real == root_real or \
        target_real.startswith(root_real + os.sep)


def _verify_checksum(path: str, spec: str) -> None:
    """spec: '<algo>:<hexdigest>' (go-getter checksum option)."""
    try:
        algo, want = spec.split(":", 1)
    except ValueError:
        raise ArtifactError(f"malformed checksum {spec!r}")
    try:
        h = hashlib.new(algo.strip().lower())
    except ValueError:
        raise ArtifactError(f"unsupported checksum algorithm {algo!r}")
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    got = h.hexdigest()
    if got != want.strip().lower():
        raise ArtifactError(
            f"checksum mismatch: want {algo}:{want}, got {algo}:{got}")


def _is_archive(name: str) -> bool:
    return name.lower().endswith(_ARCHIVE_EXTS)


def _safe_extract_tar(tf: tarfile.TarFile, dest: str) -> None:
    for member in tf.getmembers():
        if not _confined(dest, os.path.join(dest, member.name)):
            raise ArtifactError(f"archive member escapes dest: {member.name}")
        if member.islnk() or member.issym():
            link = os.path.join(dest, os.path.dirname(member.name),
                                member.linkname)
            if not _confined(dest, link):
                raise ArtifactError(
                    f"archive link escapes dest: {member.name}")
    tf.extractall(dest, filter="data")


def _unpack(path: str, dest: str) -> None:
    name = path.lower()
    if name.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            for member in zf.namelist():
                if not _confined(dest, os.path.join(dest, member)):
                    raise ArtifactError(
                        f"archive member escapes dest: {member}")
            zf.extractall(dest)
    else:
        mode = "r:*"
        with tarfile.open(path, mode) as tf:
            _safe_extract_tar(tf, dest)
    os.unlink(path)


def fetch_artifact(artifact, task_dir: str, timeout: float = 30.0) -> str:
    """Fetch one TaskArtifact into the task directory.

    Returns the destination directory. Raises ArtifactError on any
    failure (the caller turns that into a task setup failure, ref
    artifact_hook.go Prestart -> wrapped as a recoverable error).
    """
    source = artifact.getter_source
    if not source:
        raise ArtifactError("artifact has no source")
    opts = artifact.getter_options or {}
    dest_rel = artifact.relative_dest or "local/"
    # the destination is job-controlled: confine it to the task dir the
    # same way the fs endpoints do (client.py _fs_path) — absolute paths
    # and ../ traversal must not write outside the sandbox
    dest = os.path.realpath(
        os.path.join(task_dir, dest_rel.lstrip("/")))
    if not _confined(task_dir, dest):
        raise ArtifactError(
            f"artifact destination escapes the task dir: {dest_rel!r}")

    parsed = urllib.parse.urlparse(source)
    fname = os.path.basename(parsed.path or source) or "artifact"
    staging = os.path.join(dest, fname)

    try:
        os.makedirs(dest, exist_ok=True)
        if parsed.scheme in ("http", "https"):
            try:
                with urllib.request.urlopen(source, timeout=timeout) \
                        as resp, open(staging, "wb") as out:
                    shutil.copyfileobj(resp, out)
            except Exception as e:    # noqa: BLE001 - network/protocol
                raise ArtifactError(f"fetch {source!r} failed: {e}") from e
        elif parsed.scheme in ("", "file"):
            src_path = parsed.path if parsed.scheme == "file" else source
            if not os.path.exists(src_path):
                raise ArtifactError(f"artifact source not found: {src_path}")
            shutil.copy2(src_path, staging)
        else:
            raise ArtifactError(
                f"unsupported artifact scheme {parsed.scheme!r}")

        checksum = opts.get("checksum", "")
        if checksum:
            _verify_checksum(staging, checksum)

        unpack = _is_archive(fname) and \
            str(opts.get("archive", "true")).lower() != "false"
        if unpack:
            try:
                _unpack(staging, dest)
            except (tarfile.TarError, zipfile.BadZipFile) as e:
                raise ArtifactError(f"unpack {fname!r} failed: {e}") from e
        else:
            mode = opts.get("mode", "")
            if mode:
                try:
                    os.chmod(staging, int(mode, 8))
                except ValueError:
                    pass
    except OSError as e:
        # directory-as-source, dest path collisions, ENOSPC, stale
        # mounts ... all become recoverable setup failures — an escaped
        # OSError would kill the alloc-runner thread and strand the alloc
        raise ArtifactError(f"artifact io error: {e}") from e
    return dest
