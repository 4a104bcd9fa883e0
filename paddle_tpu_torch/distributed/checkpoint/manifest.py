"""Commit manifest for crash-safe checkpoints (counterpart of
``paddle_tpu/distributed/checkpoint/manifest.py``, the same file format).

A checkpoint directory is COMMITTED only once it contains a manifest listing
every file with its size and crc32. The writer produces the manifest after
the body write and renames the whole directory into place afterwards, so:

  * a directory without a manifest is torn (the writer died mid-save) and
    must never be restored;
  * a directory whose bytes no longer match the manifest (bit rot, partial
    overwrite, deliberate corruption) is detectable before restore.

Kept dependency-light (stdlib only): resume-path verification imports it
without torch.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Optional, Tuple

MANIFEST_NAME = "pt_manifest.json"
_CHUNK = 1 << 20


def manifest_path(root: str) -> str:
    return os.path.join(root, MANIFEST_NAME)


def fsync_dir(path: str) -> None:
    """Durably record a directory entry (the rename that commits a
    checkpoint is only crash-safe once its parent directory is synced)."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _iter_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if dirpath == root and fn == MANIFEST_NAME:
                continue
            full = os.path.join(dirpath, fn)
            yield os.path.relpath(full, root), full


def _crc32(path: str) -> int:
    h = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h = zlib.crc32(chunk, h)
    return h & 0xFFFFFFFF


def write_manifest(root: str, meta: Optional[dict] = None) -> dict:
    """Checksum every file under `root` and write the manifest atomically
    (tmp + rename + dir fsync). Call only after the body write finished —
    this is the commit record torn-write detection keys off."""
    files: Dict[str, dict] = {}
    for rel, full in _iter_files(root):
        files[rel] = {"size": os.path.getsize(full), "crc32": _crc32(full)}
    doc = {"format": 1, "files": files}
    if meta:
        doc["meta"] = meta
    tmp = manifest_path(root) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, manifest_path(root))
    fsync_dir(root)
    return doc


def read_manifest(root: str) -> Optional[dict]:
    try:
        with open(manifest_path(root)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc.get("files"), dict) else None


def is_complete(root: str) -> bool:
    """Cheap commit check: manifest present/parses and every listed file
    exists with the recorded size (no checksumming)."""
    return verify(root, deep=False)[0]


def verify(root: str, deep: bool = True) -> Tuple[bool, str]:
    """(ok, reason). `deep` re-checksums every file; shallow checks
    existence + size only."""
    if not os.path.isdir(root):
        return False, "not a directory"
    doc = read_manifest(root)
    if doc is None:
        return False, "no commit manifest (torn/incomplete write)"
    for rel, ent in sorted(doc["files"].items()):
        full = os.path.join(root, rel)
        if not os.path.isfile(full):
            return False, f"missing file {rel!r}"
        size = os.path.getsize(full)
        if size != ent.get("size"):
            return False, f"size mismatch for {rel!r}: {size} != {ent.get('size')}"
        if deep and _crc32(full) != ent.get("crc32"):
            return False, f"checksum mismatch for {rel!r}"
    return True, "ok"
