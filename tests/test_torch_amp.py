"""AMP of the PyTorch port (``paddle_tpu_torch/amp``, ``framework/op.py``)
against the reference's ``paddle_tpu.amp`` on the tiny GPT and Llama of
``torch_port_utils`` (2 layers, Llama at G = 2), bridged weights.

The reference casts inside its op gateway (``framework/op.py::_amp_cast``);
the port casts in each op it wraps with ``amp_op``. Both gateways are
spied on here (a ``monkeypatch`` of each ``_amp_cast``): the sets of
``(op name, dtypes after the cast)`` they log over a forward must be equal,
at O1 and O2, with and without ``decorate``, with custom lists and in
fp16, and for ERNIE's encoder path at O1 / O2. Then logits, the loss and the gradients under O1 / O2 (the reference's
through its ``TrainStep`` loss, whose ``jax.value_and_grad`` is the path
that trains), ``decorate``'s in-place casts, and ``GradScaler``'s
scale / skip / update sequence against the reference's eager path.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as ref_amp
from paddle_tpu.framework import op as ref_op
from paddle_tpu.framework import rng as ref_rng
from paddle_tpu.framework.core import Tensor
from paddle_tpu.framework.op import raw
from paddle_tpu.jit import TrainStep as RefTrainStep
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import op as top
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.ops import flash_attention as fa

from torch_port_utils import (VOCAB, encoder_batch, jax_tiny_encoder,
                              jax_tiny_gpt, jax_tiny_llama, numpy_state,
                              torch_tiny_encoder, torch_tiny_gpt,
                              torch_tiny_llama)

BF16_U = 2.0 ** -8  # bf16's unit roundoff (8 significant bits)
# logits of a bf16 head product on both sides: the f32 sums inside each
# product are ordered differently, so a value can round one ulp (2 u of
# itself) apart, and the depth-2 body adds its own such roundings: four u
# of the largest logit
LOGIT_TOL = 4 * BF16_U
# the loss is rounded to bf16 on both sides (or, at O1 with a mask, made
# of bf16 per-token losses): one bf16 ulp of it, 2 u relative
LOSS_RTOL = 2 * BF16_U
# a gradient at depth 2 leaves about eight bf16 products (the dX of each
# layer above, its own dW, the attention's einsums), each of which may
# round one ulp (2 u) apart on the two sides: 16 u of the largest element
GRAD_TOL = 16 * BF16_U

MODELS = {"gpt": (jax_tiny_gpt, torch_tiny_gpt),
          "llama": (jax_tiny_llama, torch_tiny_llama)}


def _batch(t=16, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (2, t))
    labels = rng.integers(0, VOCAB, (2, t))
    labels[0, :5] = -100
    mask = (rng.random((2, t)) > 0.3).astype(np.float32)
    return ids, labels, mask


def _dt(dtype):
    """A dtype's name without the framework's prefix."""
    return str(dtype).removeprefix("torch.")


@pytest.fixture
def cast_logs(monkeypatch):
    """Spies on both gateways: ``(reference log, port log)``, each a list
    of ``(op name, dtypes after the cast)`` taken while AMP is on."""
    ref_log, port_log = [], []
    ref_cast, port_cast = ref_op._amp_cast, top._amp_cast

    def ref_spy(name, vals):
        out = ref_cast(name, vals)
        if ref_op.amp_state.enable:
            ref_log.append((name, tuple(_dt(v.dtype) for v in out)))
        return out

    def port_spy(name, *vals):
        out = port_cast(name, *vals)
        if top.amp_state.enable:
            port_log.append((name, tuple(_dt(v.dtype) for v in out
                                         if v is not None)))
        return out

    monkeypatch.setattr(ref_op, "_amp_cast", ref_spy)
    monkeypatch.setattr(top, "_amp_cast", port_spy)
    return ref_log, port_log


# (level, decorate, loss mask, extra auto_cast arguments)
CASES = {
    "O1": ("O1", False, False, {}),
    "O1-mask": ("O1", False, True, {}),
    "O2": ("O2", False, False, {}),
    "O2-mask": ("O2", False, True, {}),
    "O2-decorate": ("O2", True, True, {}),
    # white wins over black at O1; gelu / silu kept in f32
    "O1-custom": ("O1", False, False, dict(
        custom_white_list=["layer_norm_op", "rms_norm_op"],
        custom_black_list=["gelu", "silu", "parallel_cross_entropy"])),
    "O1-fp16": ("O1", False, True, dict(dtype="float16")),
    "O2-fp16": ("O2", True, False, dict(dtype="float16")),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("model", MODELS)
def test_cast_log_matches_reference(model, case, cast_logs):
    level, dec, with_mask, kw = CASES[case]
    dtype = kw.get("dtype", "bfloat16")
    ref_log, port_log = cast_logs
    jax_model, torch_model = MODELS[model]
    ids, labels, mask = _batch(t=8)
    with jax_model() as jm:
        tm = torch_model(numpy_state(jm))
        if dec:
            ref_amp.decorate(jm, level="O2", dtype=dtype)
            amp.decorate(tm, level="O2", dtype=dtype)
        with ref_amp.auto_cast(level=level, **kw):
            jm(Tensor(jnp.asarray(ids)), labels=Tensor(jnp.asarray(labels)),
               loss_mask=Tensor(jnp.asarray(mask)) if with_mask else None)
    with amp.auto_cast(level=level, **kw):
        tm(torch.from_numpy(ids), labels=torch.from_numpy(labels),
           loss_mask=torch.from_numpy(mask) if with_mask else None)
    assert ref_log and set(port_log) == set(ref_log)
    # the points the reference's spy shows for this model and level
    names = dict(port_log)
    assert names["sdpa_op" if model == "gpt" else "gqa_flash_attention"] \
        == (dtype,) * 3
    if not kw.get("custom_black_list"):
        assert names["parallel_cross_entropy"] == (dtype,)
    # the custom lists are gone again
    assert "gelu" not in top.AMP_BLACK and "rms_norm_op" not in top.AMP_WHITE


ERNIE_CASES = {"O1": ("O1", False), "O2": ("O2", False),
               "O2-decorate": ("O2", True)}


@pytest.mark.parametrize("case", ERNIE_CASES)
def test_ernie_cast_log_matches_reference(case, cast_logs):
    """The encoder path (embeddings with the task table, post-LN blocks
    under the padding mask, pooler, classifier, ``cross_entropy_op``)
    casts where the reference casts; the mask, a raw array there, is not
    cast on either side."""
    level, dec = ERNIE_CASES[case]
    ref_log, port_log = cast_logs
    head = "ErnieForSequenceClassification"
    ids, types, mask = encoder_batch(b=2, t=8)
    labels = np.array([0, 2])
    with jax_tiny_encoder("ernie", head) as jm:
        tm = torch_tiny_encoder(numpy_state(jm), "ernie", head)
        if dec:
            ref_amp.decorate(jm, level="O2")
            amp.decorate(tm, level="O2")
        with ref_amp.auto_cast(level=level):
            jm(*(Tensor(jnp.asarray(x)) for x in (ids, types, mask)),
               labels=Tensor(jnp.asarray(labels)))
    with amp.auto_cast(level=level):
        tm(*(torch.from_numpy(x) for x in (ids, types, mask)),
           labels=torch.from_numpy(labels))
    assert ref_log and set(port_log) == set(ref_log)
    names = dict(port_log)
    assert names["sdpa_op"] == ("bfloat16",) * 3
    assert names["cross_entropy_op"] == ("float32",)
    assert ("tanh", ("bfloat16",)) in port_log or level == "O1"


def test_op_lists_match_reference():
    """Every op the port casts under has the reference's name and the
    reference's list."""
    assert {"linear", "sdpa_op", "layer_norm_op", "rms_norm_op", "softmax",
            "log_softmax", "exp", "log", "matmul", "bmm"} <= top.AMP_OPS
    for name in sorted(top.AMP_OPS):
        assert name in ref_op.OP_REGISTRY, name
        assert (name in top.AMP_WHITE) == (name in ref_op.AMP_WHITE), name
        assert (name in top.AMP_BLACK) == (name in ref_op.AMP_BLACK), name
    for got, want in ((amp.white_list(), ref_amp.white_list()),
                      (amp.black_list(), ref_amp.black_list())):
        assert got.keys() == want.keys()
        for dt in got:
            for lv in ("O1", "O2"):
                assert got[dt][lv] == want[dt][lv] & top.AMP_OPS
    # copies: editing one leaves the live lists alone
    amp.white_list()["bfloat16"]["O1"].add("gelu")
    assert "gelu" not in top.AMP_WHITE


def _ref_loss_grads(jm, level, ids, labels, mask):
    """The reference's loss and gradients (f32 numpy, by parameter name)
    through its ``TrainStep`` loss closure, under ``auto_cast(level)``."""
    def loss_fn(model, i, lab, m):
        with ref_amp.auto_cast(level=level):
            return model(i, labels=lab, loss_mask=m)

    step = RefTrainStep(jm, loss_fn,
                        paddle.optimizer.SGD(parameters=jm.parameters()))
    loss_of = step._make_loss_of()
    p_vals = [p._value for p in step._params]
    b_vals = [b._value for b in step._buffers + step._extra_params]
    batch = [jnp.asarray(x) for x in (ids, labels, mask)]
    (loss, _), grads = jax.value_and_grad(loss_of, has_aux=True)(
        p_vals, (b_vals, batch, ref_rng.next_key()))
    names = {id(p): n for n, p in jm.named_parameters()}
    return (np.asarray(loss, np.float32),
            {names[id(p)]: np.asarray(g, np.float32)
             for p, g in zip(step._params, grads)})


@pytest.mark.parametrize("level, dec", [("O1", False), ("O2", False),
                                        ("O2", True)],
                         ids=["O1", "O2", "O2-decorate"])
@pytest.mark.parametrize("model", MODELS)
def test_logits_loss_grads_match_reference(model, level, dec):
    jax_model, torch_model = MODELS[model]
    ids, labels, mask = _batch()
    with jax_model() as jm:
        tm = torch_model(numpy_state(jm))
        if dec:
            ref_amp.decorate(jm, level="O2")
            amp.decorate(tm, level="O2")
        with ref_amp.auto_cast(level=level):
            want_logits = np.asarray(raw(jm(Tensor(jnp.asarray(ids)))),
                                     np.float32)
        want_loss, want = _ref_loss_grads(jm, level, ids, labels, mask)
    with amp.auto_cast(level=level):
        logits = tm(torch.from_numpy(ids))
        loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels),
                  loss_mask=torch.from_numpy(mask))
    assert logits.dtype == torch.bfloat16
    # O1: a bf16 loss times an f32 mask promotes to f32; O2 casts the mask
    assert loss.dtype == (torch.float32 if level == "O1" else torch.bfloat16)
    loss.backward()
    got_logits = logits.detach().float().numpy()
    assert np.abs(got_logits - want_logits).max() \
        <= LOGIT_TOL * np.abs(want_logits).max()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(want)
    for n, g in want.items():
        p = named[n]
        # gradients arrive in each parameter's own dtype
        assert p.grad.dtype == p.dtype, n
        err = np.abs(p.grad.float().numpy() - g).max()
        assert err <= GRAD_TOL * np.abs(g).max(), (n, err)


def test_decorate_casts_parameters_in_place():
    with jax_tiny_llama(tie_word_embeddings=True) as jm:
        state = numpy_state(jm)
        ref_opt = paddle.optimizer.AdamW(parameters=jm.parameters())
        ref_amp.decorate(jm, ref_opt, level="O2")
        ref_dtypes = {n: _dt(raw(p).dtype) for n, p in jm.named_parameters()}
        ref_buffers = {n: _dt(raw(b).dtype) for n, b in jm.named_buffers()}
    tm = torch_tiny_llama(state, tie_word_embeddings=True)
    opt = topt.AdamW(parameters=tm.parameters())
    before = {n: p for n, p in tm.named_parameters()}
    # O1 decorates nothing
    assert amp.decorate(tm, opt, level="O1") == (tm, opt)
    assert not opt._multi_precision
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    got = amp.decorate(tm, opt, level="O2")
    assert got == (tm, opt)
    assert ref_opt._use_master_weights and opt._multi_precision
    after = dict(tm.named_parameters())
    # the same Parameter objects, now bf16, as the reference's (norms too)
    assert all(after[n] is p for n, p in before.items())
    assert {n: _dt(p.dtype) for n, p in after.items()} == ref_dtypes
    assert set(ref_dtypes.values()) == {"bfloat16"}
    # the optimizer's list and the tied head still hold them
    assert all(a is b for a, b in zip(opt._parameter_list, tm.parameters()))
    # buffers (the RoPE tables) stay f32, as the reference's
    assert {n: _dt(b.dtype) for n, b in tm.named_buffers()} == ref_buffers
    assert set(ref_buffers.values()) == {"float32"}
    assert amp.decorate(tm) is tm
    amp.decorate([tm], [opt], master_weight=False)
    assert not opt._multi_precision


def test_decorated_trainstep_keeps_bf16_parameters_and_f32_moments():
    """O2 training: the parameters stay bf16, the moments and masters f32
    (the reference's ``TrainStep`` turns bf16 parameters to f32 at its first
    AdamW step, through its f32 learning rate: ROADMAP.md C.8)."""
    with jax_tiny_gpt() as jm:
        tm = torch_tiny_gpt(numpy_state(jm))
    tm.train()
    opt = topt.AdamW(learning_rate=1e-2, parameters=tm.parameters())
    amp.decorate(tm, opt, level="O2")
    ids, labels, _ = _batch()

    def loss_fn(m, i, lab):
        with amp.auto_cast(level="O2"):
            return m(i, labels=lab)

    step = TrainStep(tm, loss_fn, opt)
    losses = [float(step(torch.from_numpy(ids), torch.from_numpy(labels)))
              for _ in range(3)]
    assert losses[-1] < losses[0]
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    moments = {v.dtype for st in opt._accumulators for k, v in st.items()
               if k.startswith("moment")}
    assert moments == {torch.float32}
    assert sorted(opt._master) == list(range(len(opt._parameter_list)))
    assert all(torch.equal(p, opt._master[i].bfloat16())
               for i, p in enumerate(opt._parameter_list))


# phase 19's AdamW (chip_smoke.py ADAMW)
O2_ADAMW = dict(learning_rate=2e-4, beta1=0.9, beta2=0.95, epsilon=1e-8,
                weight_decay=0.1)
# twelve steps of about lr each take a norm gain at 1.0 below 1 - 2^-9, the
# midpoint to the next bf16 value down (1 - 2^-8), where one step (2e-4) or
# the decay alone (2e-5 a step) rounds back to 1.0
O2_STEPS = 12


def test_decorated_adamw_keeps_f32_masters_as_the_reference_eager_step():
    """O2 AdamW on a decorated tiny GPT against the reference's eager
    ``step`` with ``_use_master_weights``: the same bf16 gradients (numpy,
    from a seed) on both sides for ``O2_STEPS`` steps at phase 19's lr and
    decay. The norm gains get steady positive gradients, so they must fall
    below 1.0; one matrix gets zero gradients, so only the decay moves it."""
    with jax_tiny_gpt() as jm:
        tm = torch_tiny_gpt(numpy_state(jm))
        ref_opt = paddle.optimizer.AdamW(parameters=jm.parameters(),
                                         **O2_ADAMW)
        ref_amp.decorate(jm, ref_opt, level="O2")
        ref_params = dict(jm.named_parameters())
        opt = topt.AdamW(parameters=tm.parameters(), **O2_ADAMW)
        amp.decorate(tm, opt, level="O2")
        params = dict(tm.named_parameters())
        assert sorted(params) == sorted(ref_params)
        rng = np.random.default_rng(11)
        frozen = "gpt.decoder.0.mlp.fc_in.weight"
        start = {n: p.detach().float().numpy().copy()
                 for n, p in params.items()}
        for _ in range(O2_STEPS):
            for n, p in params.items():
                g = rng.standard_normal(p.shape).astype(np.float32)
                if n == frozen:
                    g[:] = 0
                elif "ln" in n and n.endswith(".weight"):
                    g = 0.5 + 0.1 * np.abs(g)  # steady: Adam moves ~lr
                g = torch.from_numpy(g).bfloat16()
                p.grad = g
                ref_params[n].grad = Tensor(jnp.asarray(g.float().numpy(),
                                                        jnp.bfloat16))
            opt.step()
            opt.clear_grad()
            ref_opt.step()
            ref_opt.clear_grad()
        ref_masters = {n: np.asarray(ref_opt._master[i])
                       for i, n in enumerate(ref_params)}
        ref_vals = {n: np.asarray(raw(p), np.float32)
                    for n, p in ref_params.items()}
    order = list(params)
    for i, (n, p) in enumerate(params.items()):
        m = opt._master[order.index(n)]
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32, n
        moments = [v.dtype for k, v in opt._accumulators[i].items()
                   if k.startswith("moment")]
        assert moments == [torch.float32] * 2, n
        # the masters run the reference's f32 arithmetic; the decay
        # factor is formed in f32 here and in float64 there, one f32 ulp
        # apart at most, so a few f32 roundings of each value apart
        np.testing.assert_allclose(m.numpy(), ref_masters[n], rtol=2 ** -20,
                                   atol=2 ** -20 * O2_ADAMW["learning_rate"])
        # each parameter is its master rounded, on both sides
        assert torch.equal(p, m.bfloat16()), n
        want = ref_vals[n]
        np.testing.assert_array_equal(
            want, ref_masters[n].astype(jnp.bfloat16).astype(np.float32))
        got = p.detach().float().numpy()
        # a master on a rounding boundary may round either way
        assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want)), n
        if "ln" in n and n.endswith(".weight"):
            # the gains moved below 1.0, on both sides
            assert np.all(got < 1.0) and np.all(want < 1.0), n
    # decay alone moved the frozen matrix's master, by (1 - lr * wd)^steps
    f = np.float32(1) - np.float32(O2_ADAMW["learning_rate"]) \
        * np.float32(O2_ADAMW["weight_decay"])
    decayed = start[frozen]
    for _ in range(O2_STEPS):
        decayed = decayed * f
    m = opt._master[order.index(frozen)].numpy()
    np.testing.assert_allclose(m, decayed, rtol=2 ** -20)
    assert np.all(m != start[frozen]) or not np.any(start[frozen])


def _scaler_kw():
    return dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
                decr_every_n_nan_or_inf=1)


# (step, parameter index) where a gradient element is made inf
INF_AT = {2: 0, 3: 1}
SCALER_STEPS = 6


def _ref_scaler_run(w0, b0, x, y):
    from paddle_tpu.nn.layer import Parameter

    w, b = Parameter(jnp.asarray(w0)), Parameter(jnp.asarray(b0))
    opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=[w, b])
    scaler = ref_amp.GradScaler(**_scaler_kw())
    xs, ys = Tensor(jnp.asarray(x)), Tensor(jnp.asarray(y))
    seq = []
    for i in range(SCALER_STEPS):
        loss = (((xs @ w + b) - ys) ** 2).mean()
        scaler.scale(loss).backward()
        if i in INF_AT:
            p = (w, b)[INF_AT[i]]
            p.grad._rebind(raw(p.grad).at[0].set(jnp.inf))
        scaler.step(opt)
        seq.append((scaler._found_inf, scaler.get_loss_scaling()))
        scaler.update()
        opt.clear_grad()
        seq[-1] += (scaler.get_loss_scaling(),
                    np.asarray(raw(w)).copy(), np.asarray(raw(b)).copy())
    return seq, scaler.state_dict()


def _port_scaler_run(w0, b0, x, y):
    w = torch.nn.Parameter(torch.from_numpy(w0))
    b = torch.nn.Parameter(torch.from_numpy(b0))
    opt = topt.Optimizer(learning_rate=0.1, parameters=[w, b])
    opt._rule = lambda p, g, st, lr: p.sub_(lr * g)  # SGD
    scaler = amp.GradScaler(**_scaler_kw())
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    seq = []
    for i in range(SCALER_STEPS):
        loss = (((xs @ w + b) - ys) ** 2).mean()
        scaler.scale(loss).backward()
        if i in INF_AT:
            with torch.no_grad():
                (w, b)[INF_AT[i]].grad.view(-1)[0] = float("inf")
        scaler.step(opt)
        seq.append((scaler._found_inf, scaler.get_loss_scaling()))
        scaler.update()
        opt.clear_grad()
        seq[-1] += (scaler.get_loss_scaling(), w.detach().numpy().copy(),
                    b.detach().numpy().copy())
    return seq, scaler.state_dict()


def test_grad_scaler_matches_reference():
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    b0 = rng.standard_normal(3).astype(np.float32)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 3)).astype(np.float32)
    want, want_state = _ref_scaler_run(w0, b0, x, y)
    got, got_state = _port_scaler_run(w0, b0, x, y)
    assert got_state == want_state
    for i, (g, r) in enumerate(zip(got, want)):
        assert g[:3] == r[:3], i  # found_inf, scale at step, after update
        np.testing.assert_allclose(g[3], r[3], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g[4], r[4], rtol=1e-6, atol=1e-7)
    # the infs skipped their steps and halved the scale; two good steps
    # doubled it
    assert [s[0] for s in got] == [i in INF_AT for i in range(SCALER_STEPS)]
    assert np.array_equal(got[2][3], got[1][3])
    assert [s[2] for s in got] == [2.0 ** e for e in (10, 11, 10, 9, 9, 10)]


def test_grad_scaler_step_and_state():
    """``step`` unscales and steps; the reference's ``scale`` multiplies
    under bf16 too; a disabled scaler passes through; state round-trips."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.Optimizer(learning_rate=1.0, parameters=[p])
    opt._rule = lambda q, g, st, lr: q.sub_(lr * g)
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    loss = torch.tensor(1.5, dtype=torch.bfloat16)
    assert scaler.scale(loss).dtype == torch.bfloat16
    assert float(scaler.scale(loss)) == 12.0
    assert float(ref_amp.GradScaler(init_loss_scaling=8.0).scale(
        Tensor(jnp.asarray(1.5, jnp.bfloat16)))) == 12.0
    p.grad = torch.full((3,), 8.0)
    scaler.unscale_(opt)
    # one non-finite flag on the device over all the gradients, no sync
    assert isinstance(scaler._found_inf, torch.Tensor)
    assert scaler._found_inf.shape == () and not scaler._found_inf
    assert torch.equal(p.grad, torch.ones(3))
    p.grad = torch.full((3,), 8.0)
    scaler.minimize(opt, None)
    assert torch.equal(p.detach(), torch.zeros(3))
    assert scaler.state_dict()["good_steps"] == 1
    other = amp.GradScaler()
    other.load_state_dict(scaler.state_dict())
    assert other.state_dict() == scaler.state_dict()
    off = amp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    assert scaler.is_use_dynamic_loss_scaling()


def test_auto_cast_restores_the_policy():
    assert not top.amp_state.enable
    with amp.auto_cast(custom_white_list=["gelu"], level="O2"):
        assert top.amp_state.enable and top.amp_state.level == "O2"
        assert "gelu" in top.AMP_WHITE
        with amp.autocast(enable=False):
            assert not top.amp_state.enable
        with amp.amp_guard(level="O0"):
            assert not top.amp_state.enable
        assert top.amp_state.enable
    assert not top.amp_state.enable and "gelu" not in top.AMP_WHITE
    with contextlib.suppress(RuntimeError):
        with amp.auto_cast(custom_black_list=["linear"]):
            raise RuntimeError
    # "linear" was white already: the custom black list added it and the
    # exit took it out of the black list only
    assert "linear" in top.AMP_WHITE and "linear" not in top.AMP_BLACK
    assert not top.amp_state.enable
    with pytest.raises(ValueError, match="level"):
        with amp.auto_cast(level="O3"):
            pass
    with pytest.raises(ValueError, match="dtype"):
        with amp.auto_cast(dtype="int8"):
            pass


def test_cast_rule_per_level():
    x = torch.ones(2)
    ids = torch.ones(2, dtype=torch.int64)
    with amp.auto_cast(level="O1"):
        cx, none, cids = top._amp_cast("linear", x, None, ids)
        assert cx.dtype == torch.bfloat16 and none is None and cids is ids
        assert top._amp_cast("softmax", x.bfloat16())[0].dtype \
            == torch.float32
        assert top._amp_cast("add", x)[0] is x
    with amp.auto_cast(level="O2", dtype="float16"):
        assert top._amp_cast("add", x)[0].dtype == torch.float16
        assert top._amp_cast("exp", x.half())[0].dtype == torch.float32
    assert top._amp_cast("linear", x)[0] is x
    with pytest.raises(ValueError):
        top.amp_op("x", "grey")


def test_fp16_kernels_refuse_on_the_card():
    """AMP in fp16 reaches the flash kernels' launch checks, which take f32
    and bf16 only: no fallback on the card."""
    q = torch.zeros((1, 4, 2, 64), dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        fa._check_cuda(q, q, q, None)


def test_supported_dtypes():
    assert amp.is_bfloat16_supported("cpu") and amp.is_float16_supported(
        "cpu")
    if not torch.cuda.is_available():
        assert not amp.is_bfloat16_supported()
        assert not amp.is_float16_supported("cuda")
