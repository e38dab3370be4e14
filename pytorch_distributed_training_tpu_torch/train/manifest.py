"""Per-checkpoint integrity manifests: commit markers that can prove it
(counterpart: the JAX package's ``train/manifest.py``).

A step directory that exists is not a step whose bytes are right: a torn
copy, a disk error, a stray ``rm`` or a truncated transfer leave a step
that ``latest_step()`` returns and a restore then dies (or half-loads)
on. The manifest is written AFTER a step has committed
(``train/checkpoint.py``: the ``torch.distributed.checkpoint`` write is
renamed into place first), next to it, and records:

- the saved dict's structure (``{name: {shape, dtype}}`` of every tensor
  the step holds, whole shapes, so the summary is the same on every rank
  and sharding);
- a file inventory of the committed step directory (per-file byte size
  and sha256): truncation and partial writes by size, bit rot and
  overwrites by digest;
- torch's version and a wall-clock stamp (where JAX records jax and
  orbax).

``write_manifest`` keeps the JAX order of durability: every file the
manifest names, and its directory, is fsynced before the seal rename, and
the rename is fsynced after; a crash mid-publish leaves an unsealed step,
never a seal over torn bytes.

``verify_step`` is the one checker behind ``Checkpointer.restore``'s
fall-back-to-the-newest-verified-step walk and the offline
``cli/verify_checkpoint.py``. Levels: ``"size"`` (existence and byte
sizes) and ``"digest"`` (a full sha256 re-hash: same-size corruption,
what ``--strict`` uses). A step with no manifest verifies only with
``legacy_ok``. Everything here is file-level and carried over as it is,
so a damaged directory gets the same verdict from both packages.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

MANIFEST_NAME = "pdt_manifest.json"
MANIFEST_FORMAT = 1

VERIFY_LEVELS = ("off", "size", "digest")


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _sha256_all(paths: list[str]) -> list[str]:
    """``_sha256`` of every path, in order, hashed on up to 8 threads
    (hashlib lets go of the GIL on large blocks, and a save writes
    several files)."""
    if len(paths) < 2:
        return [_sha256(p) for p in paths]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(8, len(paths), os.cpu_count() or 1)) as ex:
        return list(ex.map(_sha256, paths))


def _walk_files(step_path: str):
    for root, _dirs, files in os.walk(step_path):
        for name in sorted(files):
            if name == MANIFEST_NAME:
                continue
            full = os.path.join(root, name)
            yield os.path.relpath(full, step_path), full


def tree_summary(tensors: dict) -> dict[str, dict]:
    """``{name: {shape, dtype}}`` of a flat dict of tensors (the saved
    dict, flattened as ``torch.distributed.checkpoint`` names its items):
    whole shapes (a ``DTensor``'s global one), so the summary is the same
    on every rank and sharding."""
    return {name: {"shape": list(getattr(t, "shape", ())),
                   "dtype": str(getattr(t, "dtype", type(t).__name__))}
            for name, t in sorted(tensors.items())}


def build_manifest(step_path: str, step: int, tree: dict | None = None) -> dict:
    """Inventory a COMMITTED step directory. ``tree`` is a prebuilt
    ``tree_summary``, captured at save time."""
    import torch

    walked = list(_walk_files(step_path))
    digests = _sha256_all([full for _, full in walked])
    files = {rel: {"bytes": os.path.getsize(full), "sha256": digest}
             for (rel, full), digest in zip(walked, digests)}
    manifest = {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        "files": files,
        "versions": {"torch": torch.__version__},
        "written_at": time.time(),
    }
    if tree is not None:
        manifest["tree"] = tree
    return manifest


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (a directory's fsync is how POSIX
    makes a rename or a creation in it durable)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_manifest(step_path: str, manifest: dict) -> str:
    """Seal a committed step: every file the manifest names and the
    directories holding them fsynced, then the manifest written to a
    ``.tmp``, fsynced and renamed into place, then the step directory
    fsynced. A crash leaves no manifest or one whose bytes are on disk."""
    dirs = {step_path}
    for rel in manifest.get("files", {}):
        full = os.path.join(step_path, rel)
        _fsync_path(full)
        dirs.add(os.path.dirname(full))
    for d in dirs:
        _fsync_path(d)
    path = os.path.join(step_path, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_path(step_path)  # make the rename itself durable
    return path


def read_manifest(step_path: str) -> dict | None:
    """The step's manifest; None when it has none, ``{}`` when it has one
    that cannot be read (corrupt, not legacy)."""
    path = os.path.join(step_path, MANIFEST_NAME)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (FileNotFoundError, NotADirectoryError):
        return None
    except (json.JSONDecodeError, OSError):
        return {}
    if not isinstance(manifest, dict) or "files" not in manifest:
        return {}
    return manifest


def verify_step(
    step_path: str, *, level: str = "size", legacy_ok: bool = False
) -> tuple[bool, str]:
    """Check a committed step against its manifest: ``(ok, reason)``,
    ``reason`` ``"ok"`` or the first failure found."""
    if level not in VERIFY_LEVELS:
        raise ValueError(
            f"verify level must be one of {VERIFY_LEVELS}, got {level!r}"
        )
    if level == "off":
        return True, "ok"
    if not os.path.isdir(step_path):
        return False, "step directory missing"
    manifest = read_manifest(step_path)
    if manifest is None:
        if legacy_ok:
            return True, "no manifest (legacy checkpoint, accepted)"
        return False, "no manifest"
    if not manifest:
        return False, "manifest unreadable"
    files = manifest["files"]
    if not files:
        return False, "manifest lists no files"
    # the sizes in order up to the first failure, then the digests of the
    # files before it (hashed together): the first failure in file order,
    # as one file at a time would find it
    sized, failure = [], None
    for rel, want in files.items():
        try:
            size = os.path.getsize(os.path.join(step_path, rel))
        except OSError:
            failure = f"file missing: {rel}"
            break
        if size != want["bytes"]:
            failure = (f"size mismatch: {rel} has {size} bytes, "
                       f"manifest says {want['bytes']}")
            break
        sized.append(rel)
    if level == "digest":
        digests = _sha256_all([os.path.join(step_path, r) for r in sized])
        for rel, digest in zip(sized, digests):
            if digest != files[rel]["sha256"]:
                return False, f"digest mismatch: {rel}"
    if failure is not None:
        return False, failure
    return True, "ok"
