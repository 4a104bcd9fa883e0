"""Distributed checkpoints: each rank writes its own pieces, any layout
restores (counterpart of ``paddle_tpu/distributed/checkpoint/__init__.py``).

The reference hands its global arrays to Orbax. Here a value of the state
dict is one of:

- a ``DTensor`` placed by ``paddle.distributed`` (``shard_tensor``,
  ``converter.canonical_state_dict``'s split entries): this rank's block
  under its mesh spec (a ``Partial`` axis summed first);
- a plain tensor or array: the whole value, held by every rank whose dict
  has the key (a pipeline stage's entries are in its ranks' dicts only);
- anything else (a scheduler's dict, a number): pickled.

``save_state_dict`` gathers every rank's list of pieces (key, global
shape, dtype, the region of the global array it covers, its spec) and each
distinct region is written once, by the lowest rank that holds it (a
replicated tensor by the first rank of its replica group): rank ``r``
appends its pieces' bytes to ``rank{r}.bin`` and lists them in
``rank{r}.json``. The commit manifest (``manifest.py``: every file's size
and crc32) carries the layout record of ``reshard.py`` in its meta: the
saving mesh (the global mesh) and each leaf's shape, dtype and spec.

The commit is atomic: the ranks write under ``<path>.ptsave-tmp``; after
a barrier the first rank writes the manifest and renames the directory to
``path``. A kill at any point leaves the old directory or a
``.ptsave-tmp``, never a torn directory under the final name, and a
directory without a manifest is never read.

``async_save=True`` copies every piece to host memory (pinned for a CUDA
tensor) before it returns, and a thread writes from those copies: the
port's optimizers update parameters in place, so a later read could see
another step's values (the reference's immutable JAX arrays need no
copy). The handle's ``wait_until_finished()`` (every rank calls it) joins
the writer and commits.

``load_state_dict(path, state_dict)`` copies into the live tensors in
place and keeps their layout: for a placed tensor this rank reads the
region of the memory-bounded read spec ``reshard.plan_restore_spec``
gives (the saved granularity on the live mesh's axes), from the pieces
that overlap it and only their overlap (``np.memmap``), and the planned
slice / all-to-all / all-gather steps carry it to the live layout; a plain
tensor reads its whole value. A key the checkpoint lacks raises
``KeyError``, a global shape that differs ``ValueError``, as the
reference's. Without ``state_dict`` it returns every value whole (CPU
tensors).
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import manifest as _manifest

#: suffix for in-flight (uncommitted) checkpoint directories
TMP_SUFFIX = ".ptsave-tmp"


def _dist():
    from .. import env

    return env.is_initialized() and env.get_world_size() > 1


def _rank() -> int:
    from ..env import get_rank

    return get_rank() if _dist() else 0


def _barrier():
    if _dist():
        from .. import collective

        collective.barrier()


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) and v and not _is_leaf_dict(key):
            yield from _flatten(v, key)
        else:
            yield key, v


def _is_leaf_dict(key: str) -> bool:
    """A scheduler's state (``LR_Scheduler``) is one pickled leaf."""
    return key.rsplit("/", 1)[-1].rsplit(".", 1)[-1] == "LR_Scheduler"


def _piece(key, v):
    """``(local block, global shape, region, spec)`` of a tensor value."""
    from torch.distributed.tensor import DTensor

    from .. import collective
    from ..auto_parallel import placements_to_spec
    from ..reshard import _norm_spec, local_region

    if isinstance(v, DTensor):
        mesh = v.process_mesh
        local = v.to_local().detach()
        partial = [i for i, p in enumerate(v.placements) if p.is_partial()]
        if partial:
            local = local.clone()
            for i in partial:
                collective.all_reduce(local, group=mesh.get_group(i))
        spec = _norm_spec(placements_to_spec(mesh, v.placements, v.dim()),
                          v.dim())
        return local, tuple(v.shape), local_region(v.shape, mesh, spec), spec
    t = torch.as_tensor(v).detach()
    shape = tuple(t.shape)
    return t, shape, [(0, n) for n in shape], ((),) * len(shape)


class _Plan:
    """What this rank writes: its pieces and pickled entries, and the
    layout record of the whole checkpoint."""

    def __init__(self, state_dict, host_copy: bool):
        from ..reshard import LeafLayout, dtype_name

        me = _rank()
        mine, extras, meta = [], {}, []
        for key, v in _flatten(state_dict):
            if isinstance(v, (torch.Tensor, np.ndarray)):
                local, shape, region, spec = _piece(key, v)
                mine.append((key, local))
                meta.append((key, shape, dtype_name(local.dtype),
                             [tuple(r) for r in region],
                             [list(e) for e in spec]))
            else:
                extras[key] = v
                meta.append((key, None, None, None, None))
        everyone = [meta]
        if _dist():
            from .. import collective

            everyone = collective.all_gather_object([], meta)
        writer, layouts = {}, {}
        for r, entries in enumerate(everyone):
            for key, shape, dtype, region, spec in entries:
                k = (key, None if region is None else tuple(region))
                writer.setdefault(k, r)
                if shape is not None and key not in layouts:
                    layouts[key] = LeafLayout(
                        tuple(shape), dtype,
                        tuple(tuple(e) for e in spec))
        by_key = {m[0]: m for m in meta}
        self.pieces = []
        for key, local in mine:
            region = tuple(tuple(r) for r in by_key[key][3])
            if writer[(key, region)] != me:
                continue
            data = local.contiguous()
            if host_copy:
                if data.is_cuda:
                    host = torch.empty(data.shape, dtype=data.dtype,
                                       pin_memory=True)
                    data = host.copy_(data)
                else:
                    data = data.clone()
            self.pieces.append((key, region, data))
        self.extras = {k: v for k, v in extras.items()
                       if writer[(k, None)] == me}
        self.layouts = layouts

    def write(self, root: str, rank: int):
        from ..reshard import dtype_name

        index, off = [], 0
        with open(os.path.join(root, f"rank{rank}.bin"), "wb") as f:
            for key, region, data in self.pieces:
                flat = data.detach().reshape(-1).cpu()
                raw = flat.view(torch.uint8).numpy() if flat.numel() else \
                    np.zeros(0, np.uint8)
                f.write(memoryview(raw))
                index.append({"key": key, "region": [list(r) for r in region],
                              "dtype": dtype_name(data.dtype), "offset": off,
                              "nbytes": int(raw.nbytes)})
                off += int(raw.nbytes)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump({"pieces": index, "extras": sorted(self.extras)}, f)
        if self.extras:
            with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
                pickle.dump(self.extras, f)


class _AtomicCommit:
    """The first rank turns the finished write under the tmp name into a
    committed checkpoint: chaos fault point (``chaos.on_commit``) ->
    checksum manifest -> atomic rename -> parent-dir fsync -> chaos fault
    point (``chaos.after_commit``). A kill at ANY point leaves either the previous committed dir or
    a ``.ptsave-tmp`` leftover, never a torn final dir."""

    def __init__(self, tmp: str, final: str, meta: Optional[dict] = None):
        self.tmp = tmp
        self.final = final
        self.meta = meta

    def run(self):
        from ...testing import chaos

        _barrier()  # every rank's pieces are on disk
        if _rank() == 0:
            chaos.on_commit(self.tmp, self.final)
            _manifest.write_manifest(self.tmp, meta=self.meta)
            if self.tmp != self.final:
                if os.path.exists(self.final):
                    shutil.rmtree(self.final)
                os.replace(self.tmp, self.final)
                _manifest.fsync_dir(os.path.dirname(self.final))
            chaos.after_commit(self.final)
        _barrier()


class PendingSave:
    """Handle of an async save: the pieces are host copies already; the
    write runs on a thread and the commit (manifest + rename) happens in
    ``wait_until_finished()``, which every rank calls. Until then the
    checkpoint does not exist under its final name."""

    def __init__(self, thread, commit: _AtomicCommit):
        self._thread = thread
        self._commit = commit
        self.done = False
        self.path = commit.final

    @property
    def tmp_path(self) -> str:
        return self._commit.tmp

    def wait_until_finished(self):
        if self.done:
            return
        self._thread.join()
        if self._thread.error is not None:
            raise self._thread.error
        self._commit.run()
        self.done = True


class _Writer(threading.Thread):
    def __init__(self, plan, root, rank):
        super().__init__(daemon=True)
        self._plan, self._root, self._rank = plan, root, rank
        self.error = None

    def run(self):
        try:
            self._plan.write(self._root, self._rank)
        except BaseException as e:  # re-raised by wait_until_finished
            self.error = e


def _layout_meta(plan: _Plan) -> Optional[dict]:
    """Manifest meta carrying the saving mesh + each leaf's layout."""
    from ..mesh import get_global_mesh
    from ..reshard import LAYOUT_KEY, record_layouts

    rec = record_layouts(plan.layouts, get_global_mesh())
    return {LAYOUT_KEY: rec} if rec else None


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    async_save: bool = False, atomic: bool = True):
    """paddle.distributed.checkpoint.save_state_dict: every rank calls it
    (see the module docstring). Returns a :class:`PendingSave` with
    ``async_save``, else None once the checkpoint is committed."""
    path = os.path.abspath(path)
    plan = _Plan(state_dict, host_copy=async_save)
    root = path + TMP_SUFFIX if atomic else path
    if _rank() == 0:
        if os.path.exists(root) and atomic:
            shutil.rmtree(root)
        os.makedirs(root, exist_ok=True)
    _barrier()
    commit = _AtomicCommit(root, path, meta=_layout_meta(plan))
    writer = _Writer(plan, root, _rank())
    if async_save:
        writer.start()
        return PendingSave(writer, commit)
    writer.run()
    if writer.error is not None:
        raise writer.error
    commit.run()
    return None


def is_complete_checkpoint(path: str) -> bool:
    """Cheap commit check: the manifest exists and every listed file is
    present with the recorded size."""
    return _manifest.is_complete(path)


def verify_checkpoint(path: str, deep: bool = True):
    """(ok, reason). ``deep`` re-checksums every file against the commit
    manifest: catches silent byte corruption, not just truncation."""
    return _manifest.verify(path, deep=deep)


def saved_bytes(path: str, rank: Optional[int] = None) -> int:
    """The bytes of tensor data a checkpoint holds (of one rank's file)."""
    names = [f"rank{rank}.bin"] if rank is not None else [
        n for n in os.listdir(path) if n.endswith(".bin")]
    return sum(os.path.getsize(os.path.join(path, n)) for n in names)


class _Index:
    """The saved pieces of a committed checkpoint, by key."""

    def __init__(self, path: str):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint at {path!r}")
        if _manifest.read_manifest(path) is None:
            raise RuntimeError(
                f"{path!r} is not a committed checkpoint (no commit "
                "manifest: a torn or incomplete write is never restored)")
        self.path = path
        self.pieces: Dict[str, List[dict]] = {}
        self.extras: Dict[str, Any] = {}
        for name in sorted(os.listdir(path)):
            if not (name.startswith("rank") and name.endswith(".json")):
                continue
            stem = name[:-len(".json")]
            with open(os.path.join(path, name)) as f:
                doc = json.load(f)
            for p in doc["pieces"]:
                p["file"] = os.path.join(path, stem + ".bin")
                self.pieces.setdefault(p["key"], []).append(p)
            if doc["extras"]:
                with open(os.path.join(path, stem + ".pkl"), "rb") as f:
                    self.extras.update(pickle.load(f))
        from ..reshard import read_layout_record

        rec = read_layout_record(path)
        self.mesh, self.leaves = rec if rec else (None, {})

    def keys(self):
        return set(self.pieces) | set(self.extras)

    def shape(self, key):
        return self.leaves[key].shape

    def read(self, key, region, device=None) -> torch.Tensor:
        """The saved values of ``region`` (``[(start, stop)]`` a dim) of
        ``key``, read from the pieces that overlap it."""
        lay = self.leaves[key]
        dt = getattr(torch, lay.dtype)
        out = torch.empty([hi - lo for lo, hi in region], dtype=dt)
        filled = 0
        for p in self.pieces[key]:
            box = [(max(lo, plo), min(hi, phi))
                   for (lo, hi), (plo, phi) in zip(region, p["region"])]
            if any(lo >= hi for lo, hi in box) and len(box):
                continue
            src = _memmap(p, lay.dtype)
            src = src[tuple(slice(lo - plo, hi - plo) for (lo, hi), (plo, _)
                            in zip(box, p["region"]))]
            block = torch.from_numpy(np.array(src))  # a writable copy
            if lay.dtype == "bfloat16":
                block = block.view(torch.bfloat16)
            out[tuple(slice(lo - rlo, hi - rlo) for (lo, hi), (rlo, _)
                      in zip(box, region))] = block
            filled += block.numel()
        if filled != out.numel():
            raise RuntimeError(f"checkpoint {self.path!r}: the saved pieces "
                               f"of {key!r} do not cover {region}")
        return out if device is None else out.to(device)


def _memmap(piece, dtype):
    """A piece's saved array (memory-mapped: only what is sliced is
    read)."""
    np_dtype = np.int16 if dtype == "bfloat16" else np.dtype(
        "bool" if dtype == "bool" else dtype)
    shape = tuple(hi - lo for lo, hi in piece["region"])
    if not shape or piece["nbytes"] == 0:
        arr = np.fromfile(piece["file"], dtype=np_dtype,
                          count=int(np.prod(shape)), offset=piece["offset"])
        return arr.reshape(shape)
    return np.memmap(piece["file"], dtype=np_dtype, mode="r",
                     offset=piece["offset"], shape=shape)


def _target_layout(v):
    """``(mesh, spec, local tensor)`` of a live placed tensor, or ``(None,
    None, tensor)``."""
    from torch.distributed.tensor import DTensor

    from ..auto_parallel import placements_to_spec

    if isinstance(v, DTensor):
        if any(p.is_partial() for p in v.placements):
            raise NotImplementedError(
                "restoring into a Partial DTensor; see ROADMAP.md §A.7 "
                "item 4")
        mesh = v.process_mesh
        return mesh, placements_to_spec(mesh, v.placements, v.dim()), \
            v.to_local()
    return None, None, v


def _restore_leaf(index: _Index, key, target):
    from ..reshard import (apply_steps, local_region, plan_restore_spec,
                           plan_same_mesh, _sizes)

    mesh, spec, local = _target_layout(target)
    if mesh is None:
        value = index.read(key, [(0, n) for n in index.shape(key)],
                           local.device)
    else:
        read = plan_restore_spec(index.leaves[key], index.mesh, mesh, spec)
        shape = tuple(target.shape)
        value = index.read(key, local_region(shape, mesh, read),
                           local.device)
        plan = plan_same_mesh(shape, local.dtype, read, spec, _sizes(mesh),
                              key=key)
        value = apply_steps(value, plan, mesh, read)
    with torch.no_grad():
        local.copy_(value.to(local.dtype))


def _check_shapes(index: _Index, flat):
    bad = []
    for key, v in flat:
        if key in index.leaves and hasattr(v, "shape") and \
                tuple(index.shape(key)) != tuple(v.shape):
            bad.append(f"{key}: saved {tuple(index.shape(key))} vs target "
                       f"{tuple(v.shape)}")
    if bad:
        raise ValueError(
            "checkpoint leaf shapes do not match the restore target: "
            + "; ".join(bad[:3])
            + (f" (+{len(bad) - 3} more)" if len(bad) > 3 else ""))


def load_state_dict(path: str, state_dict: Optional[Dict[str, Any]] = None,
                    process_group=None, coordinator_rank: int = 0):
    """Restore (see the module docstring): into ``state_dict``'s tensors in
    place, in their layout (its non-tensor entries replaced), returning
    it; without one, every saved value whole."""
    path = os.path.abspath(path)
    index = _Index(path)
    if state_dict is None:
        out = {}
        for key in sorted(index.pieces):
            out[key] = index.read(key, [(0, n) for n in index.shape(key)])
        out.update(index.extras)
        return _unflatten(out)
    flat = list(_flatten(state_dict))
    missing = [k for k, _ in flat if k not in index.keys()]
    if missing:
        raise KeyError(
            f"checkpoint {path!r} is missing {len(missing)} entries of the "
            f"restore target: {sorted(missing)[:8]}"
            f"{' ...' if len(missing) > 8 else ''}")
    _check_shapes(index, flat)
    for key, v in flat:
        if isinstance(v, torch.Tensor):
            _restore_leaf(index, key, v)
        else:
            _assign(state_dict, key, index.extras[key])
    return state_dict


def _assign(tree, key, value):
    *parents, leaf = key.split("/")
    for p in parents:
        tree = tree[p]
    tree[leaf] = value


def _unflatten(flat):
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


save = save_state_dict
load = load_state_dict

from .converter import (  # noqa: E402,F401
    apply_canonical, canonical_state_dict, restore_canonical)

__all__ = ["PendingSave", "TMP_SUFFIX", "apply_canonical",
           "canonical_state_dict", "is_complete_checkpoint", "load",
           "load_state_dict", "restore_canonical", "save",
           "save_state_dict", "saved_bytes", "verify_checkpoint"]
