"""Paged-KV decode engine: continuous batching, prefix sharing, speculation
(counterpart of ``paddle_tpu/inference/engine.py``).

The scheduler, page accounting and prefix registry are the reference's,
line for line; the three programs it compiled with XLA (tail prefill per
bucket, single-token decode over all slots, multi-token speculative
verify) are plain eager functions here, and each layer's attention is the
hand-written paged-attention kernel K3 (``ops/cuda/paged_attention.cu``).

* **Paged KV cache.** A pool ``[L, num_pages, Hkv, page_size, D]`` plus a
  host int32 page table ``[S, max_pages]``. Page 0 is the reserved trash
  page: unallocated table entries, inactive slots and all-padding prefill
  pages write there. The pool is updated in place (``index_put_``) where
  the reference returned a new array.
* **Prefix caching.** Full prompt blocks are chain-hashed and shared
  through a bounded-LRU registry with refcounts; a hit prefills only the
  unique tail.
* **Speculative decode.** Prompt-lookup drafts are scored in one verify
  pass (T = k+1) and accepted while they agree with the target tokens.
* **Sampling.** The token landing at position p is drawn from a
  ``torch.Generator`` seeded from (request seed, p), so sampled streams do
  not depend on scheduling or on speculation being on. The bits differ
  from the reference's threefry stream; greedy decoding is exact.

Left for later slices: mesh / model-parallel sharding, the quantized logit
wire, versioned weight epochs, disaggregated prefill export/import,
per-tenant accounting, observability gauges and the compile cache.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.grad_comm import dequantize_absmax, quantize_absmax
from ..nn import functional as F
from ..ops.paged_attention import paged_attention_plain
from ..text.generation import prompt_lookup_draft

__all__ = [
    "DecodeEngine",
    "EngineConfig",
    "PagePool",
    "PrefixRegistry",
    "SamplingParams",
    "pow2_bucket",
]

KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}

#: paged-attention choice: "auto" = the CUDA kernel on the card and the
#: plain version for CPU tensors; "plain" = the plain version everywhere
#: (the on-card comparison baseline)
ATTN_KERNELS = ("auto", "plain")

#: the reserved all-garbage page every unallocated page-table entry (and
#: every masked write) points at; never handed out by the allocator
TRASH_PAGE = 0

_MASK64 = (1 << 64) - 1


def pow2_bucket(n: int, lo: int = 16, hi: Optional[int] = None) -> int:
    """Smallest power-of-two >= n (floored at `lo`, capped at `hi`)."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi) if hi is not None else b


def _mix_seed(a: int, b: int) -> int:
    """splitmix64 of (a, b): a 63-bit generator seed for stream a at
    position b."""
    x = (a * 0x9E3779B97F4A7C15 + b + 0x632BE59BD9B4E5B) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


@dataclass
class EngineConfig:
    """Engine geometry + cache policy."""

    num_slots: int = 8
    max_length: int = 512
    kv_dtype: str = "f32"  # f32 | bf16 | int8
    #: explicit prompt buckets; None = powers of two from min_bucket up to
    #: max_length
    prompt_buckets: Optional[Tuple[int, ...]] = None
    min_bucket: int = 16
    #: KV page size in tokens; prefix sharing works at full-page
    #: granularity
    page_size: int = 16
    #: total pages in the pool INCLUDING the trash page 0. None =
    #: 1 + num_slots * ceil(max_length / page_size)
    num_pages: Optional[int] = None
    #: hash full prompt blocks and share hit pages across requests
    prefix_cache: bool = True
    #: bounded LRU capacity of the prefix registry, in blocks (None =
    #: num_pages)
    prefix_registry_blocks: Optional[int] = None
    #: draft tokens per speculative step; 0 disables speculation
    speculate_k: int = 0
    #: longest n-gram the prompt-lookup draft matches on
    ngram: int = 3
    #: run verify only while its measured tokens/s beats plain decode
    #: (output is the same either way); False = always speculate when a
    #: draft exists
    spec_adaptive: bool = True
    #: while speculation is suppressed, re-probe every this many steps
    spec_probe_every: int = 32
    #: base seed for requests that don't carry their own
    seed: int = 0
    #: "auto" | "plain" (see ATTN_KERNELS)
    attn_kernel: str = "auto"

    def resolved_buckets(self) -> List[int]:
        if self.prompt_buckets:
            bs = sorted({min(int(b), self.max_length)
                         for b in self.prompt_buckets})
        else:
            bs, b = [], self.min_bucket
            while b < self.max_length:
                bs.append(b)
                b *= 2
            bs.append(min(b, self.max_length))
        return bs

    @property
    def max_pages(self) -> int:
        """Page-table width: pages a max_length request spans."""
        return -(-self.max_length // self.page_size)

    def resolved_num_pages(self) -> int:
        if self.num_pages is not None:
            return int(self.num_pages)
        return 1 + self.num_slots * self.max_pages


@dataclass
class SamplingParams:
    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: Optional[int] = None

    def fields(self):
        """(temperature, top_k, top_p, greedy) as the sampler takes them."""
        greedy = (not self.do_sample) or self.temperature <= 0.0
        return (max(float(self.temperature), 1e-6), int(self.top_k),
                float(self.top_p), bool(greedy))


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray
    params: SamplingParams
    #: sample-stream seed; the token at position p uses _mix_seed(seed, p)
    seed: int
    tokens: List[int] = field(default_factory=list)
    status: str = "waiting"  # waiting | running | done
    slot: int = -1
    #: every page id this request holds a reference on (shared prefix
    #: pages first, then private pages), in virtual-sequence order
    page_ids: List[int] = field(default_factory=list)


# ---------------------------------------------------------------------------
# host-side page accounting: free-list allocator + prefix registry
# ---------------------------------------------------------------------------


class PagePool:
    """Free-list page allocator with refcounts.

    Page ``TRASH_PAGE`` (0) is reserved and never allocated. A page is
    free iff its refcount is 0; ``alloc`` hands it out at refcount 1,
    sharing increfs, and the last ``decref`` returns it to the free
    list — so ``available() + pages_referenced == num_pages - 1`` holds
    at every step.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (trash page + 1)")
        self.num_pages = int(num_pages)
        # pop() hands out low page ids first
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref = np.zeros(self.num_pages, np.int64)

    def available(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def referenced(self) -> int:
        """Pages with a nonzero refcount."""
        return int((self._ref[1:] > 0).sum())

    def shared_pages(self) -> int:
        """Pages currently referenced by more than one owner."""
        return int((self._ref[1:] >= 2).sum())

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None (never partial)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, page: int):
        if page == TRASH_PAGE or self._ref[page] <= 0:
            raise ValueError(f"incref of unallocated page {page}")
        self._ref[page] += 1

    def decref(self, page: int):
        if self._ref[page] <= 0:
            raise ValueError(f"decref of free page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)


class PrefixRegistry:
    """Bounded LRU of full prompt blocks: chain hash -> page id.

    Each registered page carries one registry reference, so pages stay
    resident (and shareable) after their request finishes until LRU
    capacity or ``evict_unused`` reclaims them.
    """

    def __init__(self, pool: PagePool, capacity: int):
        self.pool = pool
        self.capacity = int(capacity)
        self._lru: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._lru)

    @staticmethod
    def block_keys(prompt: np.ndarray, page_size: int) -> List[bytes]:
        """Chain hashes of the prompt's FULL blocks: block j's key folds
        in its parent's key, so equal keys imply equal whole prefixes.
        Byte-for-byte the reference's keys."""
        keys, parent = [], b"paddle_tpu/prefix"
        t0 = int(prompt.shape[0])
        for j in range(t0 // page_size):
            blk = np.ascontiguousarray(
                prompt[j * page_size:(j + 1) * page_size], dtype=np.int64)
            parent = hashlib.blake2b(
                parent + blk.tobytes(), digest_size=16).digest()
            keys.append(parent)
        return keys

    def lookup_chain(self, keys: List[bytes]) -> List[int]:
        """Pages for the longest registered prefix of `keys`, each
        increfed for the caller (release with pool.decref)."""
        pages = []
        for key in keys:
            page = self._lru.get(key)
            if page is None:
                self.misses += 1
                break
            self._lru.move_to_end(key)
            self.pool.incref(page)
            pages.append(page)
            self.hits += 1
        return pages

    def register(self, key: bytes, page: int):
        if key in self._lru:
            self._lru.move_to_end(key)
            return
        self.pool.incref(page)
        self._lru[key] = page
        while len(self._lru) > self.capacity:
            _, old = self._lru.popitem(last=False)
            self.pool.decref(old)

    def evict_unused(self, want: int) -> int:
        """Drop up to `want` LRU entries whose page only the registry
        still references (freeing the page); returns pages freed."""
        freed = 0
        for key in list(self._lru):
            if freed >= want:
                break
            page = self._lru[key]
            if self.pool.refcount(page) == 1:
                del self._lru[key]
                self.pool.decref(page)
                freed += 1
        return freed

    def clear(self):
        for page in self._lru.values():
            self.pool.decref(page)
        self._lru.clear()


# ---------------------------------------------------------------------------
# cache plumbing (in-place writes into the device pool)
# ---------------------------------------------------------------------------


def _block_page_write(cache, scales, layer, kv, row, cached_len, true_len,
                      int8, page_size):
    """Write a prompt tail kv [1, TB, Hkv, D] (positions cached_len ...
    cached_len + TB - 1) into the pages ``row[cached_len//P + j]``.
    Pages holding padding only (entirely >= true_len) are redirected to
    the trash page so a padded tail bucket never writes past the
    request's allocation. ``row`` is the host page-table row."""
    x = kv[0]  # [TB, Hkv, D]
    tb, hkv, d = x.shape
    p = page_size
    nb = -(-tb // p)
    if nb * p != tb:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, nb * p - tb))
    blk = x.reshape(nb, p, hkv, d).transpose(1, 2)  # [nb, Hkv, P, D]
    mp = row.shape[0]
    g = cached_len // p + np.arange(nb)
    need = (true_len + p - 1) // p  # pages with any real prompt content
    idx = np.where(g < need, row[np.minimum(g, mp - 1)], TRASH_PAGE)
    idx = torch.as_tensor(idx, dtype=torch.long, device=cache.device)
    # several padding blocks may hit the trash page: plain assignment, the
    # trash content is never read unmasked
    if int8:
        q, scale = quantize_absmax(blk, axis=-1)  # scale [nb, Hkv, P, 1]
        cache[layer][idx] = q
        scales[layer][idx] = scale[..., 0]
        return
    cache[layer][idx] = blk.to(cache.dtype)


def _token_page_write(cache, scales, layer, kv, tables, positions, int8,
                      page_size):
    """Write kv [S, T, Hkv, D] at absolute positions [S, T] (device
    tensors) through the page tables [S, MP] (decode T=1, verify T=k+1).
    Inactive slots carry zeroed table rows, so their writes land on the
    trash page."""
    pg = torch.gather(tables, 1, positions // page_size).long()
    off = (positions % page_size).long()
    lay = cache[layer]
    if int8:
        q, scale = quantize_absmax(kv, axis=-1)  # scale [S, T, Hkv, 1]
        lay[pg, :, off, :] = q
        scales[layer][pg, :, off] = scale[..., 0]
        return
    lay[pg, :, off, :] = kv.to(cache.dtype)


def _layer_kv(cache, scales, layer, int8):
    """One layer's [N, Hkv, P, D] pool view, dequantized when int8."""
    lay = cache[layer]
    if int8:
        return dequantize_absmax(lay, scales[layer][..., None])
    return lay


def _sample_tokens(logits, seeds, temperature, top_k, top_p, greedy):
    """Sampling for N rows: logits [N, V] f32 on the device; seeds [N]
    host ints (one generator seed per row); temperature / top_k / top_p /
    greedy host numpy arrays [N]. Greedy rows take the argmax; the others
    draw by Gumbel-max from the temperature / top-k / top-p filtered
    logits. Returns [N] int64 on the device."""
    out = logits.argmax(dim=-1)
    rows = np.flatnonzero(~np.asarray(greedy, bool))
    if rows.size == 0:
        return out
    dev = logits.device
    idx = torch.as_tensor(rows, device=dev)
    x = logits[idx] / torch.as_tensor(temperature[rows], device=dev)[:, None]
    v = x.shape[-1]
    tk = torch.as_tensor(top_k[rows], device=dev, dtype=torch.long)
    tp = torch.as_tensor(top_p[rows], device=dev, dtype=torch.float32)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    kth = torch.gather(sorted_x, 1, (tk.clamp(1, v) - 1)[:, None])
    x = torch.where((tk[:, None] > 0) & (x < kth), neg_inf, x)
    probs = torch.softmax(x, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    keep = (torch.cumsum(sp, dim=-1) - sp) < tp[:, None]
    thr = torch.where(keep, sp, torch.tensor(float("inf"), device=dev)
                      ).amin(dim=-1, keepdim=True)
    x = torch.where((tp[:, None] < 1.0) & (probs < thr), neg_inf, x)
    for i, r in enumerate(rows):
        gen = torch.Generator(device=dev).manual_seed(int(seeds[r]))
        u = torch.rand(v, generator=gen, device=dev, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u))
        out[r] = torch.argmax(x[i] + gumbel)
    return out


class DecodeEngine:
    """Continuous-batching serving engine over a decoder-only LM.

    Usage::

        eng = DecodeEngine(model, num_slots=8, max_length=512,
                           speculate_k=4)
        rid = eng.submit(prompt_ids, max_new_tokens=64, eos_token_id=2)
        eng.run()                     # or step() from your own loop
        out = eng.result(rid)         # np.ndarray prompt + generated

    ``device`` defaults to the CUDA card; the model must already live on
    the engine's device.
    """

    def __init__(self, model, config: Optional[EngineConfig] = None, *,
                 device=None, **overrides):
        self.config = config or EngineConfig(**overrides)
        cfg = self.config
        self.device = resolve_device(device)
        if cfg.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {tuple(KV_DTYPES)}, "
                             f"got {cfg.kv_dtype!r}")
        if cfg.attn_kernel not in ATTN_KERNELS:
            raise ValueError(f"attn_kernel must be one of {ATTN_KERNELS}, "
                             f"got {cfg.attn_kernel!r}")
        if cfg.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {cfg.page_size}")
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError(f"parameter {name} is on {p.device}, the "
                                 f"engine runs on {self.device}")
        self.model = model
        model.eval()
        self.adapter = model.decode_adapter()
        ad = self.adapter
        if cfg.max_length > ad.max_positions:
            raise ValueError(
                f"max_length={cfg.max_length} exceeds the model's "
                f"max_positions={ad.max_positions}")
        if cfg.speculate_k and not getattr(ad, "multi_token_positions",
                                           False):
            raise ValueError("speculate_k > 0 needs an adapter accepting "
                             "[S, T] positions")
        self.buckets = cfg.resolved_buckets()
        self._int8 = cfg.kv_dtype == "int8"
        self._mp = cfg.max_pages
        self._num_pages = cfg.resolved_num_pages()
        shape = (ad.num_layers, self._num_pages, ad.num_kv_heads,
                 cfg.page_size, ad.head_dim)
        dev = self.device
        self._kc = torch.zeros(shape, dtype=KV_DTYPES[cfg.kv_dtype],
                               device=dev)
        self._vc = torch.zeros_like(self._kc)
        if self._int8:
            self._ksc = torch.ones(shape[:-1], dtype=torch.float32,
                                   device=dev)
            self._vsc = torch.ones_like(self._ksc)
        else:
            self._ksc = self._vsc = None
        self.pool = PagePool(self._num_pages)
        cap = (cfg.prefix_registry_blocks
               if cfg.prefix_registry_blocks is not None
               else self._num_pages)
        self.registry = (PrefixRegistry(self.pool, cap)
                         if cfg.prefix_cache else None)
        #: per-slot page tables, uploaded to every decode/verify step;
        #: freed slots are zeroed so their writes/gathers hit trash
        self._tables = np.zeros((cfg.num_slots, self._mp), np.int32)
        self.total_tokens = 0
        self.prefill_calls = 0
        self.prefill_seconds = 0.0
        #: decode-program runs, verify steps included (as the reference
        #: counts them)
        self.decode_steps = 0
        self.verify_steps = 0
        self.step_seconds = 0.0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self._t_decode_ema = None
        self._t_verify_ema = None
        self._tok_verify_ema = None
        self._steps_since_probe = 0
        self.prefix_hit_tokens = 0
        self.peak_pages_in_use = 0
        self.peak_running = 0
        #: (slots, logits) of the last decode/verify step: logits [S, V]
        #: or [S, k+1, V] over all slots; ``slots`` lists the active ones
        self.last_step: Optional[Tuple[List[int], torch.Tensor]] = None
        self._waiting: deque = deque()
        self._running: Dict[int, Request] = {}
        self._free = list(range(cfg.num_slots))[::-1]  # pop() -> slot 0
        self._requests: Dict[int, Request] = {}
        self._next_id = 0

    # -- scheduler ----------------------------------------------------------

    def submit(self, prompt, params: Optional[SamplingParams] = None,
               **kw) -> int:
        """Queue one request; returns its id. `prompt` is a 1-D int
        sequence; keyword args build a SamplingParams."""
        if params is None:
            params = SamplingParams(**kw)
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        ids = np.asarray(prompt, dtype=np.int32).reshape(-1)
        t0 = int(ids.shape[0])
        if t0 < 1:
            raise ValueError("empty prompt")
        if t0 > self.buckets[-1]:
            raise ValueError(
                f"prompt length {t0} exceeds the largest prompt bucket "
                f"{self.buckets[-1]}")
        if t0 + params.max_new_tokens > self.config.max_length:
            raise ValueError(
                f"prompt ({t0}) + max_new_tokens ({params.max_new_tokens}) "
                f"exceeds max_length={self.config.max_length}")
        total_pages = -(-(t0 + params.max_new_tokens)
                        // self.config.page_size)
        if total_pages > self._num_pages - 1:
            raise ValueError(
                f"request needs {total_pages} KV pages but the pool only "
                f"has {self._num_pages - 1}")
        rid = self._next_id
        self._next_id += 1
        seed = (int(params.seed) if params.seed is not None
                else _mix_seed(self.config.seed, rid))
        req = Request(req_id=rid, prompt=ids, params=params, seed=seed)
        self._requests[rid] = req
        self._waiting.append(req)
        return rid

    def step(self) -> bool:
        """Admit waiting requests into free slots (one tail prefill each),
        then advance every occupied slot: ONE decode step, or — when
        speculation is on and a prompt-lookup draft exists — ONE verify
        step emitting up to ``speculate_k + 1`` tokens per slot. Returns
        False when the engine is fully idle."""
        self._admit()
        if not self._running:
            if self._waiting:
                raise RuntimeError(
                    "waiting requests cannot get KV pages and no slot is "
                    "decoding; raise num_pages")
            return False
        k = self.config.speculate_k
        if k > 0 and self._spec_worthwhile(k):
            drafts, any_real = self._collect_drafts(k)
            if any_real and self._verify_headroom(k):
                self._step_verify(drafts, k)
                return True
        self._step_decode()
        return True

    def _spec_worthwhile(self, k: int) -> bool:
        """Adaptive gate: speculate when the measured step-time and
        acceptance EMAs predict verify emits more tokens/s than decode
        (always True with spec_adaptive=False). With no verify estimate
        yet — or a stale one — probe."""
        if not self.config.spec_adaptive:
            return True
        if self._t_decode_ema is None:
            return False  # measure the decode baseline first
        if self._t_verify_ema is None:
            return True
        if self._steps_since_probe >= self.config.spec_probe_every:
            return True
        if self._tok_verify_ema is None:
            return True
        return (self._tok_verify_ema * self._t_decode_ema
                > self._t_verify_ema)

    @staticmethod
    def _ema(prev, x, alpha=0.3):
        return x if prev is None else (1 - alpha) * prev + alpha * x

    def _sampling_arrays(self, rows_per_slot: int):
        """Per-slot sampling inputs (host numpy), inactive slots greedy."""
        s = self.config.num_slots
        temp = np.ones(s, np.float32)
        top_k = np.zeros(s, np.int64)
        top_p = np.ones(s, np.float32)
        greedy = np.ones(s, bool)
        for slot, req in self._running.items():
            t_, k_, p_, g_ = req.params.fields()
            temp[slot], top_k[slot], top_p[slot], greedy[slot] = t_, k_, p_, g_
        rep = lambda a: np.repeat(a, rows_per_slot)  # noqa: E731
        return rep(temp), rep(top_k), rep(top_p), rep(greedy)

    def _step_decode(self):
        s = self.config.num_slots
        active = list(self._running.items())
        tokens = np.zeros(s, np.int64)
        positions = np.zeros(s, np.int64)
        seeds = np.zeros(s, np.int64)
        for slot, req in active:
            tokens[slot] = req.tokens[-1]
            positions[slot] = len(req.prompt) + len(req.tokens) - 1
            seeds[slot] = _mix_seed(req.seed, int(positions[slot]) + 1)
        t0 = time.perf_counter()
        logits = self._decode_body(tokens, positions)
        nxt = _sample_tokens(logits, seeds, *self._sampling_arrays(1))
        nxt_host = nxt.cpu().numpy()  # the per-step host transfer: [S]
        dt = time.perf_counter() - t0
        if self.decode_steps:  # the first step pays one-time set-up
            self._t_decode_ema = self._ema(self._t_decode_ema, dt)
        self.step_seconds += dt
        self._steps_since_probe += 1
        self.decode_steps += 1
        self.last_step = ([slot for slot, _ in active], logits)
        for slot, req in active:
            self.total_tokens += 1
            self._append_token(req, int(nxt_host[slot]))
        self._update_peaks()

    def _step_verify(self, drafts: Dict[int, np.ndarray], k: int):
        """One multi-token speculative step: score cur + k drafts in a
        single target pass; accept target tokens while the draft agrees
        (position-keyed streams, so acceptance never changes WHAT is
        sampled — only how many tokens one step emits)."""
        s, k1 = self.config.num_slots, k + 1
        tokens = np.zeros((s, k1), np.int64)
        positions = np.zeros(s, np.int64)
        seeds = np.zeros((s, k1), np.int64)
        for slot, req in self._running.items():
            tokens[slot, 0] = req.tokens[-1]
            tokens[slot, 1:] = drafts[slot]
            positions[slot] = len(req.prompt) + len(req.tokens) - 1
            seeds[slot] = [_mix_seed(req.seed, int(positions[slot]) + 1 + i)
                           for i in range(k1)]
        t0 = time.perf_counter()
        logits = self._verify_body(tokens, positions)  # [S, k1, V]
        targets = _sample_tokens(
            logits.reshape(s * k1, -1), seeds.reshape(-1),
            *self._sampling_arrays(k1)).reshape(s, k1)
        targets_host = targets.cpu().numpy()
        dt = time.perf_counter() - t0
        if self.verify_steps:
            self._t_verify_ema = self._ema(self._t_verify_ema, dt)
        self.step_seconds += dt
        self._steps_since_probe = 0
        self.decode_steps += 1
        self.verify_steps += 1
        self.last_step = (list(self._running), logits)
        emitted = 0
        active_slots = len(self._running)
        for slot, req in list(self._running.items()):
            tgt = targets_host[slot]
            m = 0
            while m < k and int(drafts[slot][m]) == int(tgt[m]):
                m += 1
            self.spec_proposed += k
            self.spec_accepted += m
            for tok in tgt[:m + 1]:
                if req.status != "running":
                    break  # budget/eos hit mid-emission
                self.total_tokens += 1
                emitted += 1
                self._append_token(req, int(tok))
        if active_slots:
            self._tok_verify_ema = self._ema(
                self._tok_verify_ema, emitted / active_slots)
        self._update_peaks()

    def _collect_drafts(self, k: int):
        """Prompt-lookup drafts per running slot; slots with no n-gram
        recurrence fall back to repeating their last token."""
        drafts: Dict[int, np.ndarray] = {}
        any_real = False
        for slot, req in self._running.items():
            ctx = np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int32)])
            d = prompt_lookup_draft(ctx, k, max_ngram=self.config.ngram)
            if d is not None:
                any_real = True
            else:
                d = np.full(k, req.tokens[-1], np.int32)
            drafts[slot] = d
        return drafts, any_real

    def _verify_headroom(self, k: int) -> bool:
        """The verify step writes KV at positions p .. p+k; require them
        all inside the cache for every running slot."""
        limit = self.config.max_length - 1
        return all(
            len(r.prompt) + len(r.tokens) - 1 + k <= limit
            for r in self._running.values())

    def run(self) -> Dict[int, np.ndarray]:
        """Drive step() until every submitted request finished; returns
        {req_id: prompt + generated} for requests completed in this
        drain."""
        seen_done = {rid for rid, r in self._requests.items()
                     if r.status == "done"}
        while self._waiting or self._running:
            self.step()
        return {rid: self.result(rid) for rid, r in self._requests.items()
                if r.status == "done" and rid not in seen_done}

    def result(self, rid: int) -> np.ndarray:
        req = self._requests[rid]
        if req.status != "done":
            raise RuntimeError(f"request {rid} is {req.status}, not done")
        return np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])

    def generate_batch(self, input_ids, max_new_tokens: int = 32,
                       do_sample: bool = False, top_k: int = 0,
                       top_p: float = 1.0, temperature: float = 1.0,
                       eos_token_id=None, pad_token_id=None, seed=None):
        """Batch front end: every row becomes a request, rows that finish
        early are padded with pad_token_id (else eos, else 0). Returns an
        int64 numpy array [B, T0 + n]."""
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.detach().cpu().numpy()
        ids = np.asarray(input_ids)
        b, t0 = ids.shape
        rids = [
            self.submit(ids[i], SamplingParams(
                max_new_tokens=max_new_tokens, do_sample=do_sample,
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_token_id=eos_token_id,
                seed=None if seed is None else seed * 1000003 + i))
            for i in range(b)
        ]
        self.run()
        reqs = [self._requests[r] for r in rids]
        width = max(len(r.tokens) for r in reqs)
        filler = pad_token_id if pad_token_id is not None else (
            eos_token_id if eos_token_id is not None else 0)
        out = np.full((b, t0 + width), filler, dtype=np.int64)
        out[:, :t0] = ids
        for i, r in enumerate(reqs):
            out[i, t0:t0 + len(r.tokens)] = r.tokens
        return out

    def release_prefix_cache(self):
        """Drop every registry reference (running requests keep theirs);
        afterwards a drained engine holds zero pages."""
        if self.registry is not None:
            self.registry.clear()

    def warmup(self) -> dict:
        """Run every program once before traffic arrives — one prefill per
        prompt bucket, the decode step and (when ``speculate_k > 0``) the
        verify step — with all-zero page tables, so every KV write lands
        on the inert trash page and pool, scheduler and registry are
        untouched. Builds the kernels on first use."""
        cfg = self.config
        s = cfg.num_slots
        row = np.zeros(self._mp, np.int32)
        for tb in self.buckets:
            self._prefill_body(np.ones((1, tb), np.int64), 0, tb, row)
        positions = np.zeros(s, np.int64)
        self._decode_body(np.zeros(s, np.int64), positions)
        k = cfg.speculate_k
        if k > 0:
            self._verify_body(np.zeros((s, k + 1), np.int64), positions)
        self._sync()
        return {"buckets": len(self.buckets), "decode": True,
                "verify": k > 0}

    def stats(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "prefill_calls": self.prefill_calls,
            "prefill_seconds": self.prefill_seconds,
            "decode_steps": self.decode_steps,
            "verify_steps": self.verify_steps,
            "step_seconds": self.step_seconds,
            "total_tokens": self.total_tokens,
            "running": len(self._running),
            "waiting": len(self._waiting),
            "page_size": self.config.page_size,
            "num_pages": self._num_pages,
            "pages_free": self.pool.available(),
            "pages_shared": self.pool.shared_pages(),
            "peak_pages_in_use": self.peak_pages_in_use,
            "peak_running": self.peak_running,
            "prefix_blocks_registered": (
                len(self.registry) if self.registry is not None else 0),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "attn_kernel": self.config.attn_kernel,
            "device": str(self.device),
        }

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"no prompt bucket holds length {n}")

    def _admit(self):
        while self._free and self._waiting:
            if not self._try_prefill(self._waiting[0], self._free[-1]):
                break  # head request can't get pages yet; keep FIFO order
            self._waiting.popleft()
            self._free.pop()
        self._update_peaks()

    def _try_prefill(self, req: Request, slot: int) -> bool:
        """Reserve pages (sharing registry hits), run the tail prefill,
        register the request's own full prompt blocks. False = not enough
        free pages even after evicting unused registry entries."""
        p = self.config.page_size
        t0 = int(req.prompt.shape[0])
        total_pages = -(-(t0 + req.params.max_new_tokens) // p)
        keys: List[bytes] = []
        shared: List[int] = []
        if self.registry is not None:
            keys = PrefixRegistry.block_keys(req.prompt, p)
            # never share ALL of the prompt: the prefill needs >= 1 tail
            # token to produce the first logits (the last block is
            # recomputed instead — copy-on-write by recompute)
            shareable = min(len(keys), (t0 - 1) // p)
            shared = self.registry.lookup_chain(keys[:shareable])
        need = total_pages - len(shared)
        if self.pool.available() < need and self.registry is not None:
            self.registry.evict_unused(need - self.pool.available())
        pages = self.pool.alloc(need)
        if pages is None:
            for pg in shared:  # retry next round with a fresh lookup
                self.pool.decref(pg)
            return False
        cached_len = len(shared) * p
        row = np.zeros(self._mp, np.int32)
        row[:len(shared)] = shared
        row[len(shared):total_pages] = pages
        self._tables[slot] = row
        req.page_ids = shared + pages
        self.prefix_hit_tokens += cached_len
        # register BEFORE the prefill runs: the prefill can finish the
        # request outright (1-token budget / instant EOS), and _finish
        # drops the request's page refs — the registry's +1 must already
        # be in place so the blocks survive
        if self.registry is not None:
            for j in range(len(shared), t0 // p):
                self.registry.register(keys[j], int(row[j]))
        self._prefill(req, slot, row, cached_len)
        return True

    def _prefill(self, req: Request, slot: int, row: np.ndarray,
                 cached_len: int):
        t0 = int(req.prompt.shape[0])
        tail = req.prompt[cached_len:]
        tb = self._bucket_for(len(tail))
        ids = np.zeros((1, tb), np.int64)
        ids[0, :len(tail)] = tail
        temp, top_k, top_p, greedy = (np.asarray([x]) for x in
                                      req.params.fields())
        tp0 = time.perf_counter()
        logits = self._prefill_body(ids, cached_len, t0, row)
        # sample stream keyed by DESTINATION position: the token landing at
        # position t0 uses seed (request, t0), as the decode step would
        nxt = _sample_tokens(logits, [_mix_seed(req.seed, t0)], temp,
                             top_k, top_p, greedy)
        token = int(nxt[0])
        self.prefill_seconds += time.perf_counter() - tp0
        self.prefill_calls += 1
        req.slot = slot
        req.status = "running"
        self._running[slot] = req
        self.total_tokens += 1
        self._append_token(req, token)

    def _append_token(self, req: Request, token: int):
        req.tokens.append(token)
        p = req.params
        if len(req.tokens) >= p.max_new_tokens or (
                p.eos_token_id is not None and token == p.eos_token_id):
            self._finish(req)

    def _finish(self, req: Request):
        req.status = "done"
        if req.slot >= 0:
            del self._running[req.slot]
            self._tables[req.slot] = 0
            self._free.append(req.slot)
            req.slot = -1
        for page in req.page_ids:
            self.pool.decref(page)
        req.page_ids = []

    def _update_peaks(self):
        in_use = self._num_pages - 1 - self.pool.available()
        self.peak_pages_in_use = max(self.peak_pages_in_use, in_use)
        self.peak_running = max(self.peak_running, len(self._running))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the three programs, as eager bodies --------------------------------

    def _attend(self, q, layer, tables, start):
        """One layer of paged attention. ``auto`` hands the kernel the
        STORED pool slices (plus the absmax scale slabs when int8, dequant
        happens per page inside the kernel); ``plain`` dequantizes the
        layer's pool up front, as the reference's einsum oracle does."""
        if self.config.attn_kernel == "auto":
            return F.paged_attention(
                q.contiguous(), self._kc[layer], self._vc[layer], tables,
                start,
                k_scales=None if self._ksc is None else self._ksc[layer],
                v_scales=None if self._vsc is None else self._vsc[layer])
        return paged_attention_plain(
            q, _layer_kv(self._kc, self._ksc, layer, self._int8),
            _layer_kv(self._vc, self._vsc, layer, self._int8), tables, start)

    def _layers(self, x, pos, tables, start, write):
        """The decoder stack over the paged pool: per layer, project,
        write this call's K/V with ``write(layer, k, v)``, attend, MLP."""
        ad = self.adapter
        for l in range(ad.num_layers):
            h = ad.pre_attn(l, x)
            q, k, v = ad.qkv(l, h, pos)
            write(l, k, v)
            o = self._attend(q, l, tables, start)
            x = x + ad.attn_out(l, o)
            x = x + ad.mlp(l, x)
        return ad.final_norm(x)

    @torch.no_grad()
    def _prefill_body(self, ids, cached_len: int, true_len: int,
                      row: np.ndarray):
        """Tail prefill of one request (S=1, T=bucket): returns the last
        real token's logits [1, V] f32."""
        ad, dev = self.adapter, self.device
        tb = ids.shape[1]
        psz, int8 = self.config.page_size, self._int8
        positions = cached_len + torch.arange(tb, device=dev)
        start = torch.tensor([cached_len], dtype=torch.int32, device=dev)
        table = torch.as_tensor(row[None], device=dev)  # [1, MP] int32
        x = ad.embed(torch.as_tensor(ids, device=dev), positions)

        def write(l, k, v):
            _block_page_write(self._kc, self._ksc, l, k, row, cached_len,
                              true_len, int8, psz)
            _block_page_write(self._vc, self._vsc, l, v, row, cached_len,
                              true_len, int8, psz)

        x = self._layers(x, positions, table, start, write)
        # right-pad positions >= true_len are inert under the position
        # mask; the real last-token logits sit at tail offset
        # true_len - 1 - cached_len
        off = true_len - 1 - cached_len
        return ad.logits(x[:, off:off + 1])[:, 0].float()

    def _token_body(self, tokens, positions):
        """Decode (T=1) and verify (T=k+1) share one body: tokens [S, T],
        positions [S] (position of each slot's first token). Returns
        logits [S, T, V] f32."""
        ad, dev = self.adapter, self.device
        psz, int8 = self.config.page_size, self._int8
        t = tokens.shape[1]
        start = torch.as_tensor(positions, device=dev)
        pos2 = start[:, None] + torch.arange(t, device=dev)[None, :]
        tables = torch.as_tensor(self._tables, device=dev)
        x = ad.embed(torch.as_tensor(tokens, device=dev), pos2)

        def write(l, k, v):
            _token_page_write(self._kc, self._ksc, l, k, tables, pos2, int8,
                              psz)
            _token_page_write(self._vc, self._vsc, l, v, tables, pos2, int8,
                              psz)

        x = self._layers(x, pos2, tables, start.to(torch.int32), write)
        return ad.logits(x).float()

    @torch.no_grad()
    def _decode_body(self, tokens, positions):
        """Single-token decode over all slots: logits [S, V] f32."""
        return self._token_body(tokens[:, None], positions)[:, 0]

    @torch.no_grad()
    def _verify_body(self, tokens, positions):
        """Speculative verify, k+1 tokens per slot: logits [S, k+1, V]."""
        return self._token_body(tokens, positions)
