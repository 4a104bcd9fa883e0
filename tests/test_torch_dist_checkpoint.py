"""Distributed checkpoints of the PyTorch port
(``paddle_tpu_torch/distributed/checkpoint``): saved under one layout,
resumed under another, against the reference's uninterrupted run, at
world size 4 on the CPU (gloo, one spawn), as
``tests/test_checkpoint_reshard.py`` holds the reference's: 5 steps under
layout A, ``save_state_dict(canonical_state_dict(model, opt))``, a model
built anew under layout B ``restore_canonical`` s it, and the losses of
steps 5-9 equal the reference's uninterrupted one-process run within that
test's tolerances. Held:

- dp 2 x mp 2 -> dp 4, mp 4 and one process (no topology);
- pp 2 x mp 2 -> sharding 4 at stage 3, and sharding 4 stage 3 -> pp 2 x
  mp 2;
- each rank writes only its own pieces, each piece once (the bytes a
  rank wrote against the arithmetic); the checkpoint verifies;
- ``canonical_state_dict`` of a pp 2 model with named parameters has the
  reference's keys (per layer, by structured path) and values;
- in one process (no process group): ``async_save`` writes the values as
  they were at the call although the optimizer steps in place meanwhile;
  a torn ``.ptsave-tmp`` is never restored; ``verify_checkpoint(deep=True)``
  catches a flipped byte; missing keys and shape mismatches raise as the
  reference's; ``load_state_dict`` without a target gives whole values.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.distributed.checkpoint import converter as ref_converter
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM

from paddle_tpu_torch.distributed import checkpoint as ckpt

from test_torch_fleet import _assert_params_close
from torch_port_utils import (CKPT_LM, CKPT_SWITCH, fleet_jobs, join_ranks,
                              no_mesh, numpy_state, spawn_ranks,
                              tiny_lm_data)

WORLD = 4
# tests/test_checkpoint_reshard.py
PARITY_RTOL, PARITY_ATOL = 5e-3, 1e-5
DP2_MP2 = {"dp_degree": 2, "mp_degree": 2}
PP2_MP2 = {"pp_degree": 2, "mp_degree": 2}
SH4 = {"sharding_degree": 4}
SOURCES = {
    "dp2_mp2": (DP2_MP2, 1, {"dp4": ({"dp_degree": 4}, 1),
                             "mp4": ({"mp_degree": 4}, 1),
                             "single": (None, 1)}),
    "pp2_mp2": (PP2_MP2, 1, {"sh4_z3": (SH4, 3)}),
    "sh4_z3": (SH4, 3, {"pp2_mp2": (PP2_MP2, 1)}),
}
RESUMES = [f"{s}->{t}" for s, (_, _, ts) in SOURCES.items() for t in ts]


def _ref_run(degrees, stage=1, steps=None, named=False):
    """The reference's CKPT_LM under ``DistTrainStep`` at ``degrees``: the
    losses, and (``named``) its canonical state after ``steps``."""
    data = tiny_lm_data()[:steps]
    with no_mesh():
        s = ref_fleet.DistributedStrategy()
        s.hybrid_configs.update(degrees)
        s.sharding_configs.update(stage=stage)
        ref_fleet.init(is_collective=True, strategy=s)
        paddle.seed(1234)
        model = GPTForCausalLM(GPTConfig(**CKPT_LM))
        if named:
            for i, p in enumerate(model.parameters()):
                p.name = f"named_{i}"
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=model.parameters())
        ref_fleet.distributed_model(model)
        opt = ref_fleet.distributed_optimizer(opt)
        step = ref_fleet.DistTrainStep(
            model, lambda m, ids, lbl: m(ids, labels=lbl), opt)
        losses = [float(step(Tensor(jnp.asarray(ids)),
                             Tensor(jnp.asarray(ids)))) for ids in data]
        if not named:
            return losses
        canon = ref_converter.canonical_state_dict(model, opt)
        return {k: (np.asarray(raw(v)) if hasattr(v, "shape") or
                    isinstance(v, Tensor) else v) for k, v in canon.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_ckpt")
    with no_mesh():
        paddle.seed(1234)
        state = numpy_state(GPTForCausalLM(GPTConfig(**CKPT_LM)))
    jobs = [dict(name="ckpt", kind="ckpt", model="lm", batch="lm",
                 dir=str(out), sources=SOURCES),
            dict(name="named_pp", kind="ckpt_named_pp", model="lm",
                 batch="lm")]
    ctx = spawn_ranks(fleet_jobs, WORLD, out, jobs, {"lm": state},
                      {"lm": tiny_lm_data()})
    try:
        ref = dict(baseline=_ref_run({}),
                   named_pp=_ref_run({"pp_degree": 2}, steps=2, named=True))
    finally:
        port = join_ranks(ctx, out)
    return dict(port=port, ref=ref, out=out, state=state)


@pytest.mark.parametrize("resume", RESUMES)
def test_resume_under_another_layout_continues_the_run(runs, resume):
    """Steps 5-9 after the resume equal the uninterrupted reference run
    (and so do steps 0-4 under the source layout)."""
    got = runs["port"][0]["ckpt"][resume]
    base = runs["ref"]["baseline"]
    assert len(got) == len(base) == 10
    np.testing.assert_allclose(got, base, rtol=PARITY_RTOL,
                               atol=PARITY_ATOL, err_msg=resume)
    assert got[-1] < got[0]
    if not resume.endswith("single"):
        for r in range(1, WORLD):
            assert runs["port"][r]["ckpt"][resume] == got


def _param_bytes(state):
    return sum(np.asarray(v).size * 4 for v in state.values())


@pytest.mark.parametrize("source", list(SOURCES))
def test_each_piece_is_written_once(runs, source):
    """The ranks together write the parameters and the two AdamW moments
    once, plus the scalar beta powers (4 bytes each, two a parameter):
    replicated entries by the first rank holding them, so the bytes are
    the same whatever the layout; the checkpoint verifies deeply."""
    state = runs["state"]
    n_params = len(state)
    want = 3 * _param_bytes(state) + 2 * 4 * n_params
    got = [runs["port"][r]["ckpt"][source] for r in range(WORLD)]
    assert sum(g["bytes"] for g in got) == want
    assert got[0]["verified"] == (True, "ok")
    if source == "sh4_z3":  # every rank holds slices: all of them write
        assert all(g["bytes"] > 0 for g in got)


def test_named_pp_canonical_keys_and_values_are_the_references(runs):
    """``canonical_state_dict`` at pp 2 with named parameters: the union of
    the ranks' keys is the reference's (per-layer names, optimizer entries
    by structured path, never by name or place), with its values."""
    want = runs["ref"]["named_pp"]
    got = {}
    for r in range(WORLD):
        got.update(runs["port"][r]["named_pp"]["canonical"])
    assert sorted(got) == sorted(want)
    assert any(k.startswith("__opt__.gpt.decoder.1.") for k in got)
    arrays = {k: w for k, w in want.items() if hasattr(w, "shape")}
    assert len(arrays) == len(want) == 140  # no scheduler: all arrays
    # an element whose gradient is float noise (the key third of
    # qkv_proj.bias) moves by up to lr a step under Adam on either side
    _assert_params_close({k: got[k] for k in arrays}, arrays)
    # the full optimizer state keys a pipelined named parameter by its
    # unpipelined place (ROADMAP.md §C, a known difference)
    full = runs["port"][0]["named_pp"]["full_opt"]
    assert any(k.startswith("param_") for k in full)


# -- one process, no process group -------------------------------------------
def _model():
    from paddle_tpu_torch import nn, optimizer

    torch.manual_seed(0)
    m = nn.Sequential(nn.Linear(4, 8, device="cpu"), nn.ReLU(),
                      nn.Linear(8, 2, device="cpu"))
    opt = optimizer.AdamW(learning_rate=0.1, parameters=m.parameters())
    return m, opt


def _step(m, opt):
    loss = m(torch.ones(3, 4)).square().mean()
    loss.backward()
    opt.step()
    opt.clear_grad()


def _values(d):
    return {k: v.detach().clone() for k, v in d.items()
            if isinstance(v, torch.Tensor)}


def test_async_save_writes_the_values_of_the_call(tmp_path):
    m, opt = _model()
    _step(m, opt)
    canon = ckpt.canonical_state_dict(m, opt)
    at_call = _values(canon)
    pending = ckpt.save_state_dict(canon, str(tmp_path / "a"),
                                   async_save=True)
    assert not os.path.exists(tmp_path / "a")  # not committed yet
    for _ in range(3):  # in place: the live tensors change meanwhile
        _step(m, opt)
    assert any(not torch.equal(at_call[k], v)
               for k, v in _values(ckpt.canonical_state_dict(m, opt)).items())
    pending.wait_until_finished()
    m2, opt2 = _model()
    live = ckpt.restore_canonical(str(tmp_path / "a"), m2, opt2)
    for k, v in at_call.items():
        assert torch.equal(live[k], v), k


def test_torn_tmp_is_never_restored_and_corruption_is_caught(tmp_path):
    m, opt = _model()
    canon = ckpt.canonical_state_dict(m, opt)
    path = str(tmp_path / "c")
    ckpt.save_state_dict(canon, path)
    assert ckpt.is_complete_checkpoint(path)
    # a torn save: the body under .ptsave-tmp, no commit
    pending = ckpt.save_state_dict(canon, str(tmp_path / "t"),
                                   async_save=True)
    pending._thread.join()
    assert os.path.isdir(pending.tmp_path)
    assert not os.path.exists(tmp_path / "t")
    assert not ckpt.is_complete_checkpoint(pending.tmp_path)
    with pytest.raises(RuntimeError, match="not a committed checkpoint"):
        ckpt.load_state_dict(pending.tmp_path, ckpt.canonical_state_dict(
            m, opt))
    with pytest.raises(FileNotFoundError):
        ckpt.load_state_dict(str(tmp_path / "t"), {})
    assert ckpt.verify_checkpoint(path, deep=True) == (True, "ok")
    blob = os.path.join(path, "rank0.bin")
    data = bytearray(open(blob, "rb").read())
    data[len(data) // 2] ^= 0x40
    open(blob, "wb").write(bytes(data))
    ok, why = ckpt.verify_checkpoint(path, deep=True)
    assert not ok and "checksum mismatch" in why
    assert ckpt.verify_checkpoint(path, deep=False)[0]  # sizes still agree


def test_missing_keys_and_shape_mismatches_raise(tmp_path):
    m, opt = _model()
    path = str(tmp_path / "m")
    ckpt.save_state_dict(ckpt.canonical_state_dict(m), path)
    with pytest.raises(KeyError):
        ckpt.restore_canonical(path, m, opt)  # no optimizer entries saved
    with pytest.raises(KeyError):
        ckpt.load_state_dict(path, {"nope": torch.zeros(2)})
    with pytest.raises(ValueError, match="do not match the restore target"):
        ckpt.load_state_dict(path, {"0.weight": torch.zeros(5, 8)})
    with pytest.raises(KeyError):
        ckpt.apply_canonical(m, {"0.weight": torch.zeros(4, 8)})


def test_load_without_a_target_gives_whole_values(tmp_path):
    m, opt = _model()
    _step(m, opt)
    canon = ckpt.canonical_state_dict(m, opt)
    canon["step"] = 7
    path = str(tmp_path / "w")
    ckpt.save_state_dict(canon, path)
    back = ckpt.load_state_dict(path)
    assert back["step"] == 7
    for k, v in _values(canon).items():
        assert torch.equal(back[k], v), k
    m2, opt2 = _model()
    ckpt.apply_canonical(m2, back, opt2)
    for (n, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), n
