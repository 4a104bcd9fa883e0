"""Elastic, fault-tolerant training (counterpart of
``paddle_tpu/distributed/fleet/elastic.py``).

Elasticity here is fast checkpoint-resume, not rank replacement: a torch
process group cannot take a replacement for one rank, so the launcher
(``distributed/launch``) relaunches a failed host's ranks as a group, and
:class:`ElasticManager` snapshots every N steps with bounded retention and
resumes from the newest whole checkpoint, on the same layout or another
(its checkpoints are ``checkpoint.canonical_state_dict``'s topology-
independent form, written by ``checkpoint.save_state_dict``).

Crash-safety guarantees, as the reference's:

* saves commit atomically (body -> checksum manifest -> rename), so a
  kill mid-save never leaves a restorable-looking torn ``step_N/``;
* ``resume()`` restores the newest checkpoint that passes manifest
  verification, skipping torn or corrupted ones with a diagnosis, and
  raises rather than train from scratch when every committed one fails;
* retention counts only committed checkpoints and never deletes the
  newest one, whatever ``max_to_keep`` says;
* a pending async save is committed before the next save starts and at
  interpreter exit.

With a process group of more than one rank every rank calls ``save`` /
``maybe_save`` / ``resume`` together (the writer is collective); only the
first rank prunes.

Also here: the MPMD pipeline's per-stage shards (``save_stage_shard`` and
the helpers around it: its failure unit is one stage), the stage-local
live resize, and the resize signals over the coordination store.
"""
from __future__ import annotations

import atexit
import os
import shutil
import sys
from typing import Dict, Optional, Tuple

import torch

from ... import observability as _obs
from ..checkpoint import (
    TMP_SUFFIX,
    is_complete_checkpoint,
    save_state_dict,
    verify_checkpoint,
)

__all__ = [
    "ElasticManager", "stage_shard_dir", "save_stage_shard",
    "latest_stage_step", "latest_common_step", "load_stage_shard",
    "stage_live_resize", "request_resize", "poll_resize", "clear_resize",
    "request_stage_resize", "poll_stage_resize", "clear_stage_resize",
]


def _first_rank() -> bool:
    from ..checkpoint import _rank

    return _rank() == 0


class ElasticManager:
    """Checkpoint-resume driver::

        elastic = ElasticManager(ckpt_dir, save_interval=100)
        start = elastic.resume(model, optimizer)          # 0 if fresh
        for step in range(start, total):
            chaos.step_fence(step)
            loss = train_step(...)
            elastic.maybe_save(step, model, optimizer)
    """

    def __init__(self, ckpt_dir: str, save_interval: int = 100,
                 max_to_keep: int = 3, async_save: bool = False,
                 verify_on_resume: bool = True):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.save_interval = max(1, int(save_interval))
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.verify_on_resume = verify_on_resume
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._pending = None
        # an async save in flight at interpreter exit would lose the
        # newest checkpoint; commit it on the way out
        atexit.register(self._atexit_flush)

    # -- discovery ----------------------------------------------------------
    def _step_dirs(self) -> Dict[int, str]:
        out = {}
        for name in os.listdir(self.ckpt_dir):
            if name.startswith("step_") and name[5:].isdigit():
                out[int(name[5:])] = os.path.join(self.ckpt_dir, name)
        return out

    def _complete_steps(self) -> Dict[int, str]:
        """Only checkpoints whose commit manifest checks out (shallow):
        torn directories from a kill mid-save are invisible here."""
        return {s: p for s, p in self._step_dirs().items()
                if is_complete_checkpoint(p)}

    def latest_step(self) -> Optional[int]:
        steps = self._complete_steps()
        return max(steps) if steps else None

    # -- save / restore -----------------------------------------------------
    def _state(self, model, optimizer=None):
        """The topology-independent (canonical) snapshot: a pipelined stack
        by layer, optimizer entries by structured parameter path, so a
        checkpoint saved under one hybrid layout restores under another."""
        from ..checkpoint.converter import canonical_state_dict

        return canonical_state_dict(model, optimizer)

    def maybe_save(self, step: int, model, optimizer=None, extra=None
                   ) -> bool:
        if (step + 1) % self.save_interval != 0:
            return False
        self.save(step, model, optimizer, extra)
        return True

    def flush(self):
        """Commit a pending async save (manifest + atomic rename). No-op
        when nothing is in flight."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.wait_until_finished()
            # the commit added a checkpoint: re-apply retention so an async
            # tail save does not leave max_to_keep + 1 directories behind
            self._gc()

    def _atexit_flush(self):
        try:
            self.flush()
        except Exception as e:  # interpreter teardown: diagnose, not mask
            print(f"[elastic] final checkpoint flush failed: {e!r}",
                  file=sys.stderr)

    def save(self, step: int, model, optimizer=None, extra=None):
        """``extra`` (a user payload: RNG state, epoch counters, ...) goes
        to a SIDECAR checkpoint beside the canonical one, so the canonical
        tree stays exactly the live model / optimizer structure."""
        # a still-running async save commits before the next write starts:
        # two writers in one directory tree is the torn state the manifest
        # exists to rule out
        self.flush()
        path = os.path.join(self.ckpt_dir, f"step_{step}")
        self._pending = save_state_dict(
            self._state(model, optimizer), path, async_save=self.async_save)
        if extra:
            save_state_dict(dict(extra), self._extra_dir(step))
        self._gc()

    def _extra_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"extra_{step}")

    def _gc(self):
        # only the first rank prunes: it alone creates the tmp directories,
        # so no rank can sweep another's in-flight write
        if not _first_rank():
            return
        # retention counts COMMITTED checkpoints only, and even
        # max_to_keep=0 keeps the newest one
        complete = sorted(self._complete_steps())
        keep = max(1, int(self.max_to_keep))
        for victim in complete[:-keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{victim}"),
                          ignore_errors=True)
            shutil.rmtree(self._extra_dir(victim), ignore_errors=True)
        # sweep tmp leftovers of crashed writers, never the in-flight save
        active = (os.path.basename(self._pending.tmp_path)
                  if self._pending is not None else None)
        for name in os.listdir(self.ckpt_dir):
            if TMP_SUFFIX in name and name != active:
                shutil.rmtree(os.path.join(self.ckpt_dir, name),
                              ignore_errors=True)

    # -- live resize --------------------------------------------------------
    def capture(self, model, optimizer=None) -> Dict:
        """The live canonical snapshot (tensors keep their CURRENT layout):
        the source side of a live resize. Capture on the old topology,
        rebuild the model and optimizer on the new one, then
        ``live_resize``."""
        return self._state(model, optimizer)

    def live_resize(self, step: int, src_state: Dict, model,
                    optimizer=None) -> int:
        """Resume at ``step + 1`` on the CURRENT (resized) layout by
        resharding a captured live state through collectives, with no disk
        round trip. Any failure (missing leaves, shape drift, a wedged
        collective, a move the port cannot make) degrades to ``resume()``
        from the newest verified checkpoint, counted as
        ``reshard_fallback_total{why="disk_restore"}``."""
        from ..checkpoint.converter import _finish, canonical_state_dict
        from ..reshard import record_fallback, reshard_state

        dst_state = canonical_state_dict(model, optimizer)
        try:
            moved = reshard_state(src_state, dst_state, what="live")
            _copy_moved(dst_state, moved)
            _finish(optimizer, dst_state)
        except (KeyError, ValueError, TimeoutError, RuntimeError) as e:
            print(f"[elastic] live resize at step {step} failed ({e!r}); "
                  "falling back to checkpoint restore", file=sys.stderr)
            record_fallback("disk_restore", step=step, error=repr(e))
            nxt = self.resume(model, optimizer)
            _obs.event("elastic_resize", step=step, outcome="disk_restore",
                       next_step=nxt)
            return nxt
        _obs.event("elastic_resize", step=step, outcome="live",
                   next_step=step + 1, leaves=len(dst_state))
        return step + 1

    def resume(self, model, optimizer=None, extra_out=None) -> int:
        """Restore the newest VERIFIED snapshot into the live model and
        optimizer, in their layout; returns the next step to run (0 when
        there is no checkpoint). Torn directories (no commit manifest) are
        skipped with a diagnosis; a committed checkpoint that fails its
        checksum falls back to the previous one. If every committed
        checkpoint is damaged this raises instead of silently training from
        scratch. With ``extra_out`` (a dict) the ``extra`` payload of the
        restored step is put there."""
        from ..checkpoint import load_state_dict
        from ..checkpoint.converter import restore_canonical

        self.flush()
        all_steps = self._step_dirs()
        complete = self._complete_steps()
        torn = sorted(set(all_steps) - set(complete))
        if torn:
            print(f"[elastic] ignoring torn/incomplete checkpoint dir(s) "
                  f"{['step_%d' % s for s in torn]} under {self.ckpt_dir} "
                  "(no commit manifest: writer died mid-save)",
                  file=sys.stderr)
        failures = []
        for step in sorted(complete, reverse=True):
            path = complete[step]
            if self.verify_on_resume:
                ok, why = verify_checkpoint(path, deep=True)
                if not ok:
                    print(f"[elastic] skipping step_{step}: {why}; falling "
                          "back to previous complete checkpoint",
                          file=sys.stderr)
                    failures.append((step, why))
                    _obs.inc("elastic_resume_fallback_total")
                    continue
            try:
                restore_canonical(path, model, optimizer)
            except Exception as e:
                print(f"[elastic] restore of step_{step} failed ({e!r}); "
                      "falling back to previous complete checkpoint",
                      file=sys.stderr)
                failures.append((step, repr(e)))
                _obs.inc("elastic_resume_fallback_total")
                continue
            if extra_out is not None and os.path.isdir(self._extra_dir(step)):
                extra_out.update(load_state_dict(self._extra_dir(step)))
            _obs.inc("elastic_resume_total")
            _obs.event("elastic_resume", step=step, next_step=step + 1,
                       torn=torn, fallbacks=len(failures), path=path)
            return step + 1
        if failures:
            raise RuntimeError(
                "every committed checkpoint under "
                f"{self.ckpt_dir} failed verification/restore: {failures}; "
                "refusing to silently train from scratch")
        return 0


def _copy_moved(dst_state: Dict, moved: Dict) -> None:
    """Copy resharded values into the live tensors of ``dst_state``, in
    place (a DTensor's local block from the moved DTensor's)."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        for key, tgt in dst_state.items():
            src = moved[key]
            if not isinstance(tgt, torch.Tensor):
                dst_state[key] = src
                continue
            if isinstance(tgt, DTensor):
                tgt = tgt.to_local()
                src = src.to_local() if isinstance(src, DTensor) else src
            tgt.copy_(torch.as_tensor(src).to(tgt.device, tgt.dtype))


# ---------------------------------------------------------------------------
# MPMD per-stage checkpoint shards + stage-local live resize
# ---------------------------------------------------------------------------
# An MPMD pipeline's failure unit is ONE stage: each stage checkpoints its
# own shard directory and resizes alone; ElasticManager above stays the
# whole-model path.

def stage_shard_dir(base_dir: str, stage_id: int, step: int) -> str:
    return os.path.join(os.path.abspath(base_dir),
                        f"stage_{int(stage_id)}", f"step_{int(step)}")


def save_stage_shard(base_dir: str, stage_id: int, step: int,
                     state: Dict) -> str:
    """One stage's flat state (parameters and optimizer entries by name)
    into its own commit-manifested shard directory: the same atomic
    body -> manifest -> rename discipline as whole checkpoints, so a kill
    mid-save leaves a torn directory that discovery skips."""
    path = stage_shard_dir(base_dir, stage_id, step)
    save_state_dict(dict(state), path)
    return path


def _stage_steps(base_dir: str, stage_id: int):
    root = os.path.join(os.path.abspath(base_dir), f"stage_{int(stage_id)}")
    if not os.path.isdir(root):
        return None
    return {int(n[5:]) for n in os.listdir(root)
            if n.startswith("step_") and n[5:].isdigit()
            and is_complete_checkpoint(os.path.join(root, n))}


def latest_stage_step(base_dir: str, stage_id: int) -> Optional[int]:
    """The newest COMMITTED shard step of one stage, or None."""
    steps = _stage_steps(base_dir, stage_id)
    return max(steps) if steps else None


def latest_common_step(base_dir: str, num_stages: int) -> Optional[int]:
    """The newest step every stage has a committed shard of: the
    consistent restore point after a stage dies (the survivors may have
    saved one step further than the victim)."""
    steps = None
    for s in range(int(num_stages)):
        have = _stage_steps(base_dir, s)
        if have is None:
            return None
        steps = have if steps is None else (steps & have)
        if not steps:
            return None
    return max(steps)


def load_stage_shard(base_dir: str, stage_id: int, step: int) -> Dict:
    from ..checkpoint import load_state_dict

    return load_state_dict(stage_shard_dir(base_dir, stage_id, step))


def stage_live_resize(stage_id: int, state: Dict, target_shardings: Dict):
    """Move ONE stage's live state onto its new placements (a width change
    of that stage alone); nothing outside this stage's state is touched.
    A target is a device (the stage's tensors move there) or a
    ``(ProcessMesh, spec)`` pair (``reshard.reshard_array``'s planned
    path); a name without a target keeps its tensor."""
    import time as _time

    from ..reshard import record_plan_metrics, reshard_array

    t0 = _time.perf_counter()
    out, plans = {}, []
    for name, arr in state.items():
        dst = target_shardings.get(name)
        if dst is None:
            out[name] = arr
        elif isinstance(dst, tuple):
            moved, plan = reshard_array(arr, dst[0], dst[1], key=name)
            out[name] = moved
            plans.append(plan)
        else:
            out[name] = arr.to(dst)
    record_plan_metrics(plans, what="mpmd_stage",
                        seconds=_time.perf_counter() - t0)
    _obs.event("elastic_stage_resize", stage=int(stage_id),
               leaves=len(out))
    return out


# ---------------------------------------------------------------------------
# store-signalled fleet resize (the scale-event channel)
# ---------------------------------------------------------------------------
_RESIZE_KEY = "paddle_tpu/elastic/resize"


def request_resize(store, world_size: int) -> None:
    """Publish a fleet-resize request on the coordination store; workers
    polling ``poll_resize`` pick it up at their next step fence."""
    store.set(_RESIZE_KEY, str(int(world_size)))


def poll_resize(store) -> Optional[int]:
    """Non-blocking check for a pending resize: the requested world size,
    or None. The key stays set until ``clear_resize``, so late pollers (or
    a worker relaunched mid-resize) still observe it."""
    try:
        if not store.check(_RESIZE_KEY):
            return None
        v = store.get(_RESIZE_KEY)
        return int(v.decode() if isinstance(v, bytes) else v)
    except (TimeoutError, ValueError):
        return None


def clear_resize(store) -> None:
    """Acknowledge a completed resize (coordinator side)."""
    try:
        store.delete_key(_RESIZE_KEY)
    except TimeoutError:
        pass


# stage-scoped variant: resize ONE pipeline stage's width; every other
# stage keeps running
_STAGE_RESIZE_KEY = "paddle_tpu/elastic/stage_resize"


def request_stage_resize(store, stage_id: int, dp: int) -> None:
    """Publish a stage-local width change (``stage_id`` -> new dp); the
    MPMD driver resizes only that stage (``MpmdPipeline.resize_stage``)."""
    store.set(_STAGE_RESIZE_KEY, f"{int(stage_id)}:{int(dp)}")


def poll_stage_resize(store) -> Optional[Tuple[int, int]]:
    """The pending ``(stage_id, new_dp)`` stage resize, or None."""
    try:
        if not store.check(_STAGE_RESIZE_KEY):
            return None
        v = store.get(_STAGE_RESIZE_KEY)
        s, dp = (v.decode() if isinstance(v, bytes) else str(v)).split(":")
        return int(s), int(dp)
    except (TimeoutError, ValueError):
        return None


def clear_stage_resize(store) -> None:
    try:
        store.delete_key(_STAGE_RESIZE_KEY)
    except TimeoutError:
        pass
