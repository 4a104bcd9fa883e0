"""Decoding loops for the causal LM families, GPT and Llama (counterpart of
``paddle_tpu/text/generation.py``).

* :func:`generate`: greedy or top-k / nucleus sampling. Routed through the
  model's attached ``DecodeEngine`` (``inference.enable_decode_engine``)
  when one can hold the request, else a loop that re-runs the full forward
  on the growing sequence, right-padded to power-of-two length buckets
  (the reference's compile discipline, kept so both packages run the
  same shapes; padding sits right of every position read, and causal
  attention never looks forward).
* :func:`generate_padded`: greedy decode over one fixed shape.
* :func:`beam_search`: host-side beam bookkeeping over full forwards.
* :func:`run_cached_generation`: one prefill, then one-token decode steps
  against preallocated KV caches (``model.generate`` of GPT and Llama).

Sampling is on the host, in float64 numpy over
``np.random.default_rng(seed)``, as in the reference, so for one seed both
packages draw the same stream from the same logits. The engine samples on
the device from its own generator; there, only greedy streams match the
loops'. Every function returns numpy ids: the input's dtype on the loops,
int32 on the engine route, as the reference returns them.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch


def _without_grad(fn):
    """Run ``fn`` under a fresh ``torch.no_grad()`` per call (one shared
    context object is not reentrant across nested calls)."""

    @functools.wraps(fn)
    def wrapper(*a, **k):
        with torch.no_grad():
            return fn(*a, **k)

    return wrapper


def _pow2_bucket(n: int, lo: int = 16) -> int:
    """Smallest power of two >= n, floored at ``lo``."""
    b = lo
    while b < n:
        b *= 2
    return b


def prompt_lookup_draft(context, k: int, max_ngram: int = 3):
    """Prompt-lookup decoding draft (model-free speculation): find the
    most recent earlier occurrence of the context's trailing n-gram
    (longest n <= `max_ngram` first) and propose the k tokens that
    followed it. Returns an int32 [k] array, or None when no n-gram of
    the context's tail recurs — the caller decides the fallback. Pure
    host-side numpy: only verification runs on the device.
    """
    ctx = np.asarray(context).reshape(-1)
    t = int(ctx.shape[0])
    for n in range(min(max_ngram, t - 1), 0, -1):
        tail = ctx[t - n:]
        # scan candidate starts right-to-left: the most recent match is
        # the best predictor of what follows
        for s in range(t - n - 1, -1, -1):
            if not np.array_equal(ctx[s:s + n], tail):
                continue
            follow = ctx[s + n:s + n + k]
            if follow.shape[0] == 0:
                continue
            draft = np.empty(k, np.int32)
            draft[:follow.shape[0]] = follow
            # short match: pad by repeating the last drafted token
            draft[follow.shape[0]:] = follow[-1]
            return draft
    return None


def _engine_for(model, use_engine, prompt_len: int, total_len: int):
    """The attached decode engine when it can serve this call, else None.
    ``use_engine=False`` forces the loop; None auto-selects. A request the
    engine cannot hold (prompt beyond its largest bucket, or total length
    beyond its cache) falls back to the loop."""
    if use_engine is False:
        return None
    eng = getattr(model, "_decode_engine", None)
    if eng is None:
        return None
    if total_len > eng.config.max_length or prompt_len > eng.buckets[-1]:
        return None
    return eng


def _check_length(model, needed: int):
    """Raise up front when ``needed`` positions pass the model's
    ``max_position_embeddings`` (only the engine clamps)."""
    cfg = getattr(model, "config", None)
    limit = getattr(cfg, "max_position_embeddings", None)
    if limit is not None and needed > limit:
        raise ValueError(
            f"generation needs {needed} positions but the model supports "
            f"max_position_embeddings={limit}")


def _sample_next(logits_row, top_k, top_p, temperature, rng):
    """numpy sampling over one [V] logits row."""
    x = np.asarray(logits_row, np.float64)
    if temperature is None:
        temperature = 1.0
    if temperature <= 0.0:
        return int(x.argmax())  # temperature -> 0 degenerates to greedy
    if temperature != 1.0:
        x = x / temperature
    if top_k and top_k > 0:
        k = min(int(top_k), len(x))
        kth = np.partition(x, -k)[-k]
        x = np.where(x < kth, -np.inf, x)
    p = np.exp(x - x.max())
    p = p / p.sum()
    if top_p and top_p < 1.0:
        order = np.argsort(-p)
        csum = np.cumsum(p[order])
        # the smallest prefix whose cumulative probability reaches top_p
        # (the crossing token included)
        cut = np.concatenate([[True], csum[:-1] < top_p])
        keep = order[cut]
        mask = np.zeros_like(p, bool)
        mask[keep] = True
        p = np.where(mask, p, 0.0)
        p = p / p.sum()
    return int(rng.choice(len(p), p=p))


def _next_tokens(last, do_sample, top_k, top_p, temperature, rng):
    """[B, V] logits (numpy) -> [B] next token ids."""
    if do_sample:
        return np.array([
            _sample_next(last[i], top_k, top_p, temperature, rng)
            for i in range(last.shape[0])
        ])
    return last.argmax(-1)


def _host_ids(input_ids) -> np.ndarray:
    if isinstance(input_ids, torch.Tensor):
        return input_ids.detach().cpu().numpy()
    return np.asarray(input_ids)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _last_logits(logits, index: int, model=None) -> np.ndarray:
    """Row ``index`` of ``[B, T, V]`` logits on the host, f32 (a bf16 row
    is exact in f32). A model built at mp > 1 gives its rank's vocab block,
    which its ``whole_vocab`` all-gathers (every rank of the group calls
    this together)."""
    row = logits[:, index]
    whole = getattr(model, "whole_vocab", None)
    if whole is not None:
        row = whole(row)
    return row.float().cpu().numpy()


@contextlib.contextmanager
def _eval_mode(model):
    """``model`` in eval mode for the duration; its training flag restored
    after."""
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        if was_training:
            model.train()


@_without_grad
def generate(
    model,
    input_ids,
    max_new_tokens: int = 32,
    do_sample: bool = False,
    top_k: int = 0,
    top_p: float = 1.0,
    temperature: float = 1.0,
    eos_token_id: Optional[int] = None,
    pad_token_id: Optional[int] = None,
    seed: Optional[int] = None,
    use_engine: Optional[bool] = None,
):
    """Decode continuations for a batch of prompts.

    Args:
      model: a causal LM returning ``[B, T, V]`` logits when called without
        labels (GPTForCausalLM / LlamaForCausalLM).
      input_ids: ``[B, T0]`` prompt tokens (tensor or array).
      do_sample: False = greedy; True = top-k / nucleus sampling.
      use_engine: None routes through the attached ``DecodeEngine`` when
        it can hold the request; False forces the loop. The engine samples
        on the device, so sampled streams for one ``seed`` differ between
        the two routes (greedy ones are equal).
    Returns ``[B, T0 + n]`` token ids (numpy), ``n <= max_new_tokens``
    (stops early once every row has emitted ``eos_token_id``; finished
    rows are filled with ``pad_token_id``, else eos).
    """
    with _eval_mode(model):
        ids = _host_ids(input_ids)
        b, t0 = ids.shape
        total = t0 + max_new_tokens
        eng = _engine_for(model, use_engine, t0, total)
        if eng is not None:
            out = eng.generate_batch(
                ids, max_new_tokens=max_new_tokens, do_sample=do_sample,
                top_k=top_k, top_p=top_p, temperature=temperature,
                eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                seed=seed)
            return out.astype(np.int32)
        rng = np.random.default_rng(seed)
        done = np.zeros(b, bool)
        filler = pad_token_id if pad_token_id is not None else eos_token_id
        _check_length(model, total)
        # any valid id pads a bucket: padded positions sit right of every
        # position read, and causal attention never looks forward
        bucket_fill = filler if filler is not None else 0
        dev = _model_device(model)
        for _ in range(max_new_tokens):
            cur = ids.shape[1]
            tb = min(_pow2_bucket(cur), total)
            feed = ids
            if tb > cur:
                pad = np.full((b, tb - cur), bucket_fill, ids.dtype)
                feed = np.concatenate([ids, pad], axis=1)
            logits = model(torch.as_tensor(feed, device=dev))
            last = _last_logits(logits, cur - 1, model)
            nxt = _next_tokens(last, do_sample, top_k, top_p, temperature,
                               rng)
            if eos_token_id is not None:
                nxt = np.where(done, filler, nxt)
                done |= nxt == eos_token_id
            ids = np.concatenate([ids, nxt[:, None].astype(ids.dtype)],
                                 axis=1)
            if eos_token_id is not None and done.all():
                break
        return ids


@_without_grad
def generate_padded(
    model,
    input_ids,
    max_length: int,
    eos_token_id: Optional[int] = None,
    pad_token_id: int = 0,
    use_engine: Optional[bool] = None,
):
    """Greedy decode over one fixed shape: the sequence is right-padded to
    ``max_length`` and every step re-runs the full ``[B, max_length]``
    forward. With an engine attached the call routes through it instead
    (the same greedy tokens, one token's work per step)."""
    with _eval_mode(model):
        ids = _host_ids(input_ids)
        b, t0 = ids.shape
        if t0 >= max_length:
            raise ValueError(
                f"prompt length {t0} already >= max_length {max_length}")
        eng = _engine_for(model, use_engine, t0, max_length)
        if eng is not None:
            out = eng.generate_batch(
                ids, max_new_tokens=max_length - t0,
                eos_token_id=eos_token_id, pad_token_id=pad_token_id)
            return out.astype(np.int32)
        _check_length(model, max_length)
        buf = np.full((b, max_length), pad_token_id, ids.dtype)
        buf[:, :t0] = ids
        done = np.zeros(b, bool)
        cur = t0
        dev = _model_device(model)
        while cur < max_length:
            logits = model(torch.as_tensor(buf, device=dev))
            nxt = _last_logits(logits, cur - 1, model).argmax(-1).astype(
                ids.dtype)
            if eos_token_id is not None:
                nxt = np.where(done, pad_token_id, nxt)
                done |= nxt == eos_token_id
            buf[:, cur] = nxt
            cur += 1
            if eos_token_id is not None and done.all():
                break
        return buf[:, :cur]


@_without_grad
def beam_search(
    model,
    input_ids,
    max_new_tokens: int = 32,
    num_beams: int = 4,
    length_penalty: float = 1.0,
    eos_token_id: Optional[int] = None,
):
    """Beam-search decode (PaddleNLP GenerationMixin beam semantics):
    scores are sums of float64 log-probabilities, normalised by
    ``len ** length_penalty`` at the finish. Returns ``[B, T0 + n]`` best
    sequences, right-padded with eos (else 0)."""
    with _eval_mode(model):
        ids0 = _host_ids(input_ids)
        b, t0 = ids0.shape
        _check_length(model, t0 + max_new_tokens)
        dev = _model_device(model)
        results = []
        for row in range(b):  # per-prompt beams
            beams = [(0.0, ids0[row])]  # (logprob_sum, tokens)
            finished = []
            for _ in range(max_new_tokens):
                batch = np.stack([t for _, t in beams])
                logits = model(torch.as_tensor(batch, device=dev))
                last = _last_logits(logits, -1, model).astype(np.float64)
                top = last.max(-1, keepdims=True)
                logp = last - (np.log(np.exp(last - top).sum(
                    -1, keepdims=True)) + top)
                cand = []
                for bi, (score, toks) in enumerate(beams):
                    for tok in np.argsort(-logp[bi])[:num_beams]:
                        cand.append(
                            (score + float(logp[bi][tok]),
                             np.concatenate([toks, [tok]]).astype(
                                 toks.dtype)))
                cand.sort(key=lambda x: -x[0])
                beams = []
                for score, toks in cand:
                    if eos_token_id is not None and toks[-1] == eos_token_id:
                        norm = score / (len(toks) - t0) ** length_penalty
                        finished.append((norm, toks))
                    else:
                        beams.append((score, toks))
                    if len(beams) == num_beams:
                        break
                if not beams:
                    break
            for score, toks in beams:  # unfinished beams compete too
                norm = score / max(len(toks) - t0, 1) ** length_penalty
                finished.append((norm, toks))
            finished.sort(key=lambda x: -x[0])
            results.append(finished[0][1])
        width = max(len(r) for r in results)
        pad = eos_token_id if eos_token_id is not None else 0
        out = np.full((b, width), pad, ids0.dtype)
        for i, r in enumerate(results):
            out[i, :len(r)] = r
        return out


def alloc_kv_caches(num_layers: int, batch_size: int, max_length: int,
                    num_kv_heads: int, head_dim: int, device=None):
    """Per-layer zero KV caches ``{"k", "v"}`` of ``[B, Tmax, Hkv, D]`` f32
    on ``device`` (shared by every cached model: one place owns layout and
    dtype)."""
    shape = (batch_size, max_length, num_kv_heads, head_dim)
    return [{"k": torch.zeros(shape, dtype=torch.float32, device=device),
             "v": torch.zeros(shape, dtype=torch.float32, device=device)}
            for _ in range(num_layers)]


@_without_grad
def run_cached_generation(model, cached_forward, init_cache, logits_fn,
                          input_ids, max_new_tokens=32, do_sample=False,
                          top_k=0, top_p=1.0, temperature=1.0,
                          eos_token_id=None, pad_token_id=None, seed=None):
    """The prefill + one-token-decode loop of KV-cached models.

    ``cached_forward(ids, caches, pos_or_None) -> hidden``;
    ``init_cache(batch, max_len) -> caches``;
    ``logits_fn(hidden) -> [B, t, V]``. Sampling and eos / pad filling as
    in :func:`generate`.
    """
    with _eval_mode(model):
        ids = _host_ids(input_ids)
        b, t0 = ids.shape
        max_len = t0 + max_new_tokens
        _check_length(model, max_len)
        rng = np.random.default_rng(seed)
        dev = _model_device(model)
        caches = init_cache(b, max_len)
        hidden = cached_forward(torch.as_tensor(ids, device=dev), caches,
                                None)  # prefill
        done = np.zeros(b, bool)
        filler = pad_token_id if pad_token_id is not None else eos_token_id
        for step in range(max_new_tokens):
            # project only the final position to the vocabulary
            last = _last_logits(logits_fn(hidden[:, -1:]), -1, model)
            nxt = _next_tokens(last, do_sample, top_k, top_p, temperature,
                               rng)
            if eos_token_id is not None:
                nxt = np.where(done, filler, nxt)
                done |= nxt == eos_token_id
            ids = np.concatenate([ids, nxt[:, None].astype(ids.dtype)],
                                 axis=1)
            if (eos_token_id is not None and done.all()) \
                    or step == max_new_tokens - 1:
                break
            hidden = cached_forward(torch.as_tensor(ids[:, -1:], device=dev),
                                    caches, t0 + step)
        return ids
