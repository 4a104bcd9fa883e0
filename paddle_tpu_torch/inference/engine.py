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

* **Disaggregated prefill.** ``prefill_export`` runs one prompt's prefill
  here and hands its content pages to a decode engine, which
  ``try_import_prefill`` seats straight in decode (``serving/worker.py``
  streams the pages between them).
* **Telemetry.** With ``PADDLE_TPU_TELEMETRY_DIR`` set, the reference's
  counters, gauges and spans (``srv_prefill`` / ``srv_decode`` /
  ``srv_verify``, joined to the router's trace) and the per-tenant ledger
  (``observability/accounting.py``); one env lookup a call when off.

* **Model parallelism.** ``EngineConfig(mesh=...)`` (a ``ProcessMesh``
  with an ``mp`` axis, or a hybrid group) or a model built at mp > 1
  serves on every rank of the mp group: each rank's pool and int8 scales
  hold ``Hkv / mp`` whole kv heads and K3 runs over them with the
  engine's one page table; the attention output's projection is summed
  over the group (``text/models/_mp_decode.py``) and each rank's vocab
  block of the logits is recombined, exactly (an f32 all-gather) or
  through the quantized logit wire (``mp_comm.quantized_logit_gather``:
  bf16 / int8 payload, greedy rows on its exact argmax while
  ``logit_verify`` is on). Every rank then holds the same logits and
  draws from generators seeded alike, so the ranks emit the same tokens
  and schedule alike; the adaptive speculation choice, which reads each
  rank's own clock, is the group's first rank's, broadcast each step.
  Disaggregated prefill (``prefill_export`` / ``try_import_prefill``)
  stays single-rank.

* **Versioned weight epochs.** ``begin_weight_epoch`` / ``stage_weight``
  fill a shadow set while decoding goes on; ``promote_epoch`` swaps it in
  at a request boundary: in-flight requests finish on the epoch they were
  admitted under (its values stay pinned for them), new admissions take
  the new one, and while both run each step decodes one epoch group at a
  time (``serving/online.py`` drives it over ``wt`` frames).
* **Low precision.** The residual stream runs in the model's parameter
  dtype: a ``decorate``d O2 bf16 model is served in bf16 (the adapters'
  hooks run its ops in their inputs' dtype, K3 reads the bf16 query and
  returns bf16), the pool stays as ``kv_dtype`` says and the logits are
  cast to f32 before sampling, as the reference's engine does.

Left for later slices: the compile cache (ROADMAP.md §A.8).
"""
from __future__ import annotations

import contextlib
import hashlib
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import observability as _obs
from ..device import resolve_device
from ..distributed import collective as _C
from ..distributed import mp_comm as _mp_comm
from ..distributed.grad_comm import dequantize_absmax, quantize_absmax
from ..framework.dtype import from_host, to_host
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

#: ``EngineConfig.logit_wire`` values (None inherits the mp_comm wire)
LOGIT_WIRES = (None, "off", "f32", "bf16", "int8")

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
    #: wire of the mp-sharded logit recombination: "off" / "f32" the exact
    #: all-gather, "bf16" / "int8" the quantized wire; None inherits
    #: ``mp_comm.resolve_config()`` (and its ``logit_verify``). Always
    #: "f32" at mp 1.
    logit_wire: Optional[str] = None
    #: the engine's mesh: a ``ProcessMesh`` whose ``mp`` axis (or a hybrid
    #: group whose model-parallel group) the engine shards its kv heads
    #: and vocab over; None: the model's own mp group (a model built at
    #: mp > 1), else one rank
    mesh: Optional[object] = None

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
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    #: tokens served from the prefix registry (multiple of page_size)
    cached_len: int = 0
    #: distributed-trace context from the router's dispatch record (spans
    #: are emitted only when trace_id is set)
    trace_id: Optional[str] = None
    trace_parent: Optional[str] = None
    resubmitted: bool = False
    #: phase accounting (perf_counter stamps) behind the
    #: serving_request_done event
    prefill_t0: Optional[float] = None
    prefill_s: float = 0.0
    decode_t0: Optional[float] = None
    decode_steps_n: int = 0
    verify_steps_n: int = 0
    spec_accepted_n: int = 0
    #: cost-attribution key (observability/accounting.py): "-" = untagged
    tenant: str = "-"
    slo: str = "standard"
    #: True when the prefill (and first token) ran on another engine
    imported: bool = False
    #: pro-rata KV page occupancy charged so far, page-microseconds
    acct_page_us: int = 0
    #: weight epoch this request was admitted under (per-slot epoch pin):
    #: it decodes on that epoch's weights to its end, even if the engine
    #: promotes a newer epoch mid-flight
    epoch: int = 0


def _trace_fields(req: Request, trace: Optional[dict], tenant, slo):
    """Adopt the router's trace context and the tenant / slo labels."""
    if trace:
        req.trace_id = trace.get("trace_id")
        req.trace_parent = trace.get("parent_id")
        req.resubmitted = int(trace.get("resubmits", 0) or 0) > 0
    if tenant is not None or slo is not None:
        from ..observability import accounting as _acct

        req.tenant = _acct.normalize_tenant(tenant)
        if slo:
            req.slo = str(slo)


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


def _sample_tokens(logits, seeds, temperature, top_k, top_p, greedy,
                   exact_argmax=None):
    """Sampling for N rows: logits [N, V] f32 on the device; seeds [N]
    host ints (one generator seed per row); temperature / top_k / top_p /
    greedy host numpy arrays [N]. Greedy rows take the argmax, or
    ``exact_argmax`` [N] when given (the quantized logit wire's exact
    winner); the others draw by Gumbel-max from the temperature / top-k /
    top-p filtered logits. Returns [N] int64 on the device."""
    out = (logits.argmax(dim=-1) if exact_argmax is None
           else exact_argmax.long().clone())
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
        self.adapter = ad = model.decode_adapter()
        mesh_group = self._resolve_mp(ad)
        if mesh_group is not None:
            self.adapter = ad = model.decode_adapter(mp_group=mesh_group)
        self._mesh_group = mesh_group
        #: the wt-stream address space: parameters then buffers, each
        #: tensor once under its first name, as the reference orders them
        self._state, self._state_names, seen = [], [], set()
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            if id(t) not in seen:
                seen.add(id(t))
                self._state.append(t)
                self._state_names.append(name)
        self._state_index = {n: i for i, n in enumerate(self._state_names)}
        #: versioned weight epochs (serving/online.py): the live epoch, the
        #: values (and adapter) pinned for in-flight requests of an older
        #: one, and the shadow set an open wt stream stages into
        self._epoch = 0
        self._epoch_vals: Dict[int, tuple] = {}
        self._shadow: Optional[dict] = None
        #: the mp group the engine serves over (the mesh's, or the model's
        #: own when built at mp > 1); None at mp 1
        self._mp_group = ad.mp_group
        self._mp_degree = 1 if ad.mp_group is None else ad.mp_group.nranks
        self._logit_wire, self._logit_verify = self._resolve_logit_wire()
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
        #: the attention route spans and gauges name: "cuda" (K3) or
        #: "plain" (the plain version: attn_kernel "plain", or CPU tensors)
        self._attn_kernel = ("cuda" if cfg.attn_kernel == "auto"
                             and self.device.type == "cuda" else "plain")
        _obs.set_gauge("attn_kernel_active",
                       1.0 if self._attn_kernel == "cuda" else 0.0)
        #: this rank's kv heads (whole GQA groups)
        self._kv_heads = ad.num_kv_heads // self._mp_degree
        # the plain route dequantizes both int8 pools per layer per step;
        # K3 dequantizes each page inside the kernel: the traffic avoided
        self._fused_dequant_bytes_step = (
            2 * ad.num_layers * self._num_pages * self._kv_heads
            * cfg.page_size * ad.head_dim * 4
            if self._attn_kernel == "cuda" and self._int8 else 0)
        try:  # price the choice in the auto-planner's cost model
            from ..distributed.auto_parallel.planner import plan_attn_kernel

            # the planner's names, as the reference records them: "pallas"
            # is the fused kernel (K3 here), "einsum" the plain version
            plan_attn_kernel(
                num_slots=cfg.num_slots, max_pages=self._mp,
                kv_heads=self._kv_heads,
                query_heads=ad.num_heads // self._mp_degree,
                page_size=cfg.page_size, head_dim=ad.head_dim,
                layers=ad.num_layers, kv_dtype=cfg.kv_dtype,
                selected=("pallas" if self._attn_kernel == "cuda"
                          else "einsum"))
        except Exception:  # noqa: BLE001 — pricing never gates serving
            pass
        shape = (ad.num_layers, self._num_pages, self._kv_heads,
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
        #: untagged prompt tokens prefilled on THIS engine (the integer
        #: the per-tenant ledger reconciles against)
        self.prompt_tokens_total = 0
        #: per-tenant metering, created on the first submit with
        #: accounting enabled (one None check a step when off)
        self._acct = None
        self._pg_meter = None
        #: (slots, logits) of the last decode/verify step: logits [S, V]
        #: or [S, k+1, V] over all slots; ``slots`` lists the active ones
        self.last_step: Optional[Tuple[List[int], torch.Tensor]] = None
        self._waiting: deque = deque()
        self._running: Dict[int, Request] = {}
        self._free = list(range(cfg.num_slots))[::-1]  # pop() -> slot 0
        self._requests: Dict[int, Request] = {}
        self._next_id = 0

    # -- model parallelism --------------------------------------------------

    def _resolve_mp(self, ad):
        """The mp group ``config.mesh`` names (None at mp 1), after the
        reference's check that mp divides the kv heads, made on the mesh's
        shape before any group is built."""
        mesh = self.config.mesh
        if mesh is None:
            return None
        if hasattr(mesh, "get_model_parallel_group"):  # a hybrid group
            degree = mesh.get_model_parallel_world_size()
        else:
            from ..distributed.mesh import mesh_axis_size

            degree = mesh_axis_size("mp", mesh)
        if degree > 1 and ad.num_kv_heads % degree:
            raise ValueError(
                f"mp={degree} must divide num_kv_heads={ad.num_kv_heads}: "
                "the KV pool shards by whole kv heads (GQA groups stay "
                "intact per shard)")
        if degree <= 1:
            return None
        if hasattr(mesh, "get_model_parallel_group"):
            return mesh.get_model_parallel_group()
        return mesh.get_group("mp")

    def _resolve_logit_wire(self):
        """``(wire, logit_verify)`` by the reference's rules: an explicit
        wire wins, None inherits the mp_comm activation wire, "off" is
        "f32", and mp 1 is always "f32"."""
        lw, verify = self.config.logit_wire, True
        if lw is None:
            wcfg = _mp_comm.resolve_config()
            lw = wcfg.wire_dtype if wcfg.quantized else "f32"
            verify = wcfg.logit_verify
        elif lw == "off":
            lw = "f32"
        elif lw not in LOGIT_WIRES:
            raise ValueError(
                f"logit_wire must be one of {LOGIT_WIRES}, got "
                f"{self.config.logit_wire!r}")
        if self._mp_degree <= 1:
            lw = "f32"
        return lw, verify

    def _recombine(self, logits):
        """This rank's vocab block ``[..., width]`` -> ``(logits [..., V]
        f32, the same on every rank; exact argmax or None)``: the exact
        all-gather, or the quantized wire (a vocab the mp degree divides,
        as the reference requires; else the exact gather). The bytes this
        rank sends add to ``collective.counts["logit_wire_bytes"]``."""
        if self._mp_group is None:
            return logits.float(), None
        g, v = self._mp_group, self.adapter.vocab_size
        wire = self._logit_wire
        if wire != "f32" and v % g.nranks == 0:
            wl, exact = _mp_comm.quantized_logit_gather(logits, wire, g)
            rows = int(np.prod(logits.shape[:-1]))
            _, wire_b = _mp_comm.logit_wire_bytes(rows, v, g.nranks, wire)
            _obs.set_gauge("serving_logit_wire_bytes", wire_b)
            return wl, (exact if self._logit_verify else None)
        lf = logits.float().contiguous()
        parts = _C.stacked_all_gather(lf, g)
        _C.counts["logit_wire_bytes"] += (g.nranks - 1) * lf.numel() * 4
        return torch.cat(list(parts), dim=-1)[..., :v], None

    def _agree(self, flag: bool) -> bool:
        """``flag`` as the mp group's first rank decided it (one rank, or
        a choice that reads no clock: ``flag`` itself)."""
        if self._mp_group is None or not self.config.spec_adaptive:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        _C.broadcast(t, src=self._mp_group.ranks[0], group=self._mp_group)
        return bool(t.item())

    # -- scheduler ----------------------------------------------------------

    def accounting_ledger(self, create: bool = False):
        """This engine's per-tenant metering ledger, or None while
        accounting is disabled. ``create=True`` instantiates it when
        accounting is enabled (one env lookup)."""
        if self._acct is None and create:
            from ..observability import accounting as _acct

            if _acct.enabled():
                self._acct = _acct.TenantLedger()
                self._pg_meter = _acct.PageSecondsMeter(self._acct)
        return self._acct

    def _acct_tick(self, now: float):
        """Charge KV page occupancy since the last tick to the running
        set, shared pages split pro rata."""
        self._pg_meter.tick(now, self._running.values(),
                            self.pool.refcount,
                            self._num_pages - 1 - self.pool.available())

    @staticmethod
    def _prompt_ids(prompt) -> np.ndarray:
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        ids = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if ids.shape[0] < 1:
            raise ValueError("empty prompt")
        return ids

    def _check_request(self, t0: int, params: SamplingParams):
        """The bad-request conditions of ``submit`` (reference order)."""
        if t0 > self.buckets[-1]:
            raise ValueError(
                f"prompt length {t0} exceeds the largest prompt bucket "
                f"{self.buckets[-1]}")
        if t0 + params.max_new_tokens > self.config.max_length:
            raise ValueError(
                f"prompt ({t0}) + max_new_tokens ({params.max_new_tokens}) "
                f"exceeds max_length={self.config.max_length}")

    def _request_seed(self, params: SamplingParams, rid: int) -> int:
        return (int(params.seed) if params.seed is not None
                else _mix_seed(self.config.seed, rid))

    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               trace: Optional[dict] = None, tenant: Optional[str] = None,
               slo: Optional[str] = None, **kw) -> int:
        """Queue one request; returns its id. `prompt` is a 1-D int
        sequence; keyword args build a SamplingParams. ``trace`` is the
        router's propagated span context: when given, the engine's
        prefill / decode / verify spans join that request tree.
        ``tenant`` / ``slo`` label the request for the per-tenant ledger
        (absent -> the "-" default)."""
        if params is None:
            params = SamplingParams(**kw)
        ids = self._prompt_ids(prompt)
        t0 = int(ids.shape[0])
        self._check_request(t0, params)
        total_pages = -(-(t0 + params.max_new_tokens)
                        // self.config.page_size)
        if total_pages > self._num_pages - 1:
            raise ValueError(
                f"request needs {total_pages} KV pages but the pool only "
                f"has {self._num_pages - 1}")
        rid = self._next_id
        self._next_id += 1
        req = Request(req_id=rid, prompt=ids, params=params,
                      seed=self._request_seed(params, rid),
                      submit_time=time.perf_counter())
        _trace_fields(req, trace, tenant, slo)
        self.accounting_ledger(create=True)
        self._requests[rid] = req
        self._waiting.append(req)
        _obs.inc("serving_requests_total")
        _obs.set_gauge("serving_queue_depth", float(len(self._waiting)))
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
        epochs = sorted({r.epoch for r in self._running.values()})
        if len(epochs) > 1:
            # mixed-epoch flip window: one masked decode per epoch group
            # (the other groups' table rows are zeroed, so their KV writes
            # land on the trash page and their tokens are not applied);
            # no speculation in the window: verify and decode sample the
            # same position-keyed streams, so it costs throughput, not bits
            for e in epochs:
                with self._weights_of(e):
                    self._step_decode(epoch=e)
            return True
        with self._weights_of(epochs[0]):
            k = self.config.speculate_k
            if k > 0 and self._agree(self._spec_worthwhile(k)):
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

    def _step_decode(self, epoch: Optional[int] = None):
        """One decode step of the running slots of ``epoch`` (None: every
        slot) on the weights bound now; slots of other epochs ride along
        masked."""
        if self._acct is not None:
            self._acct_tick(time.perf_counter())
        s = self.config.num_slots
        active = [(slot, req) for slot, req in self._running.items()
                  if epoch is None or req.epoch == epoch]
        tables = self._tables
        if len(active) < len(self._running):
            tables = self._tables.copy()
            tables[[slot for slot, req in self._running.items()
                    if req.epoch != epoch]] = 0
        tokens = np.zeros(s, np.int64)
        positions = np.zeros(s, np.int64)
        seeds = np.zeros(s, np.int64)
        for slot, req in active:
            tokens[slot] = req.tokens[-1]
            positions[slot] = len(req.prompt) + len(req.tokens) - 1
            seeds[slot] = _mix_seed(req.seed, int(positions[slot]) + 1)
        t0 = time.perf_counter()
        logits, exact = self._decode_body(tokens, positions, tables)
        nxt = _sample_tokens(logits, seeds, *self._sampling_arrays(1),
                             exact_argmax=exact)
        nxt_host = nxt.cpu().numpy()  # the per-step host transfer: [S]
        dt = time.perf_counter() - t0
        _obs.observe("serving_decode_step_seconds", dt)
        if self._fused_dequant_bytes_step:
            _obs.inc("attn_kernel_fused_dequant_bytes_total",
                     self._fused_dequant_bytes_step)
        if self.decode_steps:  # the first step pays one-time set-up
            self._t_decode_ema = self._ema(self._t_decode_ema, dt)
        self.step_seconds += dt
        self._steps_since_probe += 1
        self.decode_steps += 1
        self.last_step = ([slot for slot, _ in active], logits)
        for slot, req in active:
            if req.decode_t0 is None:
                req.decode_t0 = t0  # first batched step this request joined
            req.decode_steps_n += 1
            self.total_tokens += 1
            self._append_token(req, int(nxt_host[slot]))
        _obs.inc("serving_tokens_total", len(active))
        self._update_gauges()

    def _step_verify(self, drafts: Dict[int, np.ndarray], k: int):
        """One multi-token speculative step: score cur + k drafts in a
        single target pass; accept target tokens while the draft agrees
        (position-keyed streams, so acceptance never changes WHAT is
        sampled — only how many tokens one step emits)."""
        if self._acct is not None:
            self._acct_tick(time.perf_counter())
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
        logits, exact = self._verify_body(tokens, positions)  # [S, k1, V]
        targets = _sample_tokens(
            logits.reshape(s * k1, -1), seeds.reshape(-1),
            *self._sampling_arrays(k1),
            exact_argmax=None if exact is None else exact.reshape(-1)
        ).reshape(s, k1)
        targets_host = targets.cpu().numpy()
        dt = time.perf_counter() - t0
        _obs.observe("serving_decode_step_seconds", dt)
        if self._fused_dequant_bytes_step:
            _obs.inc("attn_kernel_fused_dequant_bytes_total",
                     self._fused_dequant_bytes_step)
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
            if req.decode_t0 is None:
                req.decode_t0 = t0
            req.decode_steps_n += 1
            req.verify_steps_n += 1
            req.spec_accepted_n += m
            for tok in tgt[:m + 1]:
                if req.status != "running":
                    break  # budget/eos hit mid-emission
                self.total_tokens += 1
                emitted += 1
                self._append_token(req, int(tok))
        if active_slots:
            self._tok_verify_ema = self._ema(
                self._tok_verify_ema, emitted / active_slots)
        _obs.inc("serving_tokens_total", emitted)
        _obs.set_gauge("serving_spec_accept_ratio",
                       self.spec_accepted / max(self.spec_proposed, 1))
        self._update_gauges()

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
        t0 = time.perf_counter()
        before = self.total_tokens
        seen_done = {rid for rid, r in self._requests.items()
                     if r.status == "done"}
        while self._waiting or self._running:
            self.step()
        emitted = self.total_tokens - before
        if emitted:
            _obs.set_gauge("serving_tokens_per_second",
                           emitted / max(time.perf_counter() - t0, 1e-9))
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
        self._update_gauges()

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
            "prompt_tokens_total": self.prompt_tokens_total,
            "attn_kernel": self.config.attn_kernel,
            "device": str(self.device),
            "mp": self._mp_degree,
            "kv_heads": self._kv_heads,
            "logit_wire": self._logit_wire,
            "logit_verify": self._logit_verify,
            "weight_epoch": int(self._epoch),
            "pinned_epochs": sorted(self._epoch_vals),
        }

    def occupancy(self) -> dict:
        """Scheduler-load snapshot for the serving router: the numbers
        ``serving/worker.py`` publishes each poll (least-outstanding-tokens
        dispatch reads ``outstanding_tokens``). ``compile_cache_hits``
        keeps the reference's key: the port has no compile cache
        (ROADMAP.md §A.8)."""
        outstanding = sum(r.params.max_new_tokens - len(r.tokens)
                          for r in self._running.values())
        outstanding += sum(len(r.prompt) + r.params.max_new_tokens
                           for r in self._waiting)
        return {
            "outstanding_tokens": int(outstanding),
            "running": len(self._running),
            "waiting": len(self._waiting),
            "slots_free": len(self._free),
            "pages_free": self.pool.available(),
            "prefix_hit_tokens": int(self.prefix_hit_tokens),
            "decode_steps": int(self.decode_steps),
            "total_tokens": int(self.total_tokens),
            "compile_cache_hits": 0,
            "weight_epoch": int(self._epoch),
        }

    # -- disaggregated prefill: KV-page export / import ---------------------

    def prefill_export(self, prompt, params: Optional[SamplingParams] = None,
                       *, trace: Optional[dict] = None,
                       tenant: Optional[str] = None,
                       slo: Optional[str] = None, **kw):
        """Run one prompt's prefill HERE and hand its KV pages to a decode
        engine (disaggregated serving; ``serving/worker.py`` streams the
        result over ``transport.encode_kv``).

        Only the ``ceil(t0 / page_size)`` content pages are exported — the
        decode side allocates its own generation pages — and the slabs are
        bit-equal to what a local prefill leaves in this pool (padding
        rows past ``true_len`` included), so a raw-wire import decodes
        bit-equal to a unified engine. Sampled streams additionally need
        an explicit ``params.seed`` (the router always sets one).

        Returns ``None`` when no slot (or pages) are free right now — the
        caller retries next poll; ``{"done": prompt+tokens}`` when the
        request finished at prefill (1-token budget / instant EOS); else
        ``{"first_token", "true_len", "prefill_s", "pool_dtype", "dtype",
        "k", "v" [, "ks", "vs"]}`` with k / v ``[L, n_pages, Hkv, P, D]``
        host numpy arrays (a bf16 pool's as int16 words, ``dtype``
        ``"bfloat16"``: ``framework.dtype.to_host``) plus the int8 scale
        slabs ``[L, n_pages, Hkv, P]`` when this pool is int8. Raises
        ValueError on the same bad-request conditions as ``submit``.
        """
        if params is None:
            params = SamplingParams(**kw)
        ids = self._prompt_ids(prompt)
        t0 = int(ids.shape[0])
        self._check_request(t0, params)
        p = self.config.page_size
        content_pages = -(-t0 // p)
        if content_pages > self._num_pages - 1:
            raise ValueError(
                f"prompt needs {content_pages} KV pages but the pool only "
                f"has {self._num_pages - 1}")
        if not self._free:
            return None
        slot = self._free[-1]
        keys: List[bytes] = []
        shared: List[int] = []
        if self.registry is not None:
            keys = PrefixRegistry.block_keys(ids, p)
            shareable = min(len(keys), (t0 - 1) // p)
            shared = self.registry.lookup_chain(keys[:shareable])
        need = content_pages - len(shared)
        if self.pool.available() < need and self.registry is not None:
            self.registry.evict_unused(need - self.pool.available())
        pages = self.pool.alloc(need)
        if pages is None:
            for pg in shared:
                self.pool.decref(pg)
            return None
        rid = self._next_id
        self._next_id += 1
        cached_len = len(shared) * p
        row = np.zeros(self._mp, np.int32)
        row[:len(shared)] = shared
        row[len(shared):content_pages] = pages
        self._tables[slot] = row
        req = Request(req_id=rid, prompt=ids, params=params,
                      seed=self._request_seed(params, rid),
                      submit_time=time.perf_counter())
        _trace_fields(req, trace, tenant, slo)
        self.accounting_ledger(create=True)
        req.page_ids = shared + pages
        req.cached_len = cached_len
        self.prefix_hit_tokens += cached_len
        if cached_len:
            _obs.inc("serving_prefix_hit_tokens", cached_len)
        if self.registry is not None:
            for j in range(len(shared), t0 // p):
                self.registry.register(keys[j], int(row[j]))
        self._requests[rid] = req
        self._prefill(req, slot, row, cached_len)
        self._free.pop()  # _finish may have re-appended it; net correct
        if req.status == "done":
            return {"done": self.result(rid)}
        idx = torch.as_tensor(row[:content_pages], dtype=torch.long,
                              device=self.device)
        k, dtype = to_host(self._all_heads(self._kc[:, idx]))
        v, _ = to_host(self._all_heads(self._vc[:, idx]))
        out = {
            "first_token": int(req.tokens[0]),
            "true_len": t0,
            "prefill_s": float(req.prefill_s),
            "pool_dtype": self.config.kv_dtype,
            "dtype": dtype,
            "k": k,
            "v": v,
        }
        if self._int8:
            out["ks"] = to_host(self._all_heads(self._ksc[:, idx]))[0]
            out["vs"] = to_host(self._all_heads(self._vsc[:, idx]))[0]
        if req.tenant != "-":
            # label the handoff so the decode engine's ledger keys match
            out["tenant"] = req.tenant
            out["slo"] = req.slo
        if self._acct is not None:
            # the prefill engine's half of the request: prompt + first
            # token here, KV-stream wire bytes to the decode engine
            self._acct_tick(time.perf_counter())
            self._acct.add(
                req.tenant, req.slo, prefill_tokens=int(t0),
                decode_tokens=1,
                queue_seconds=max(req.prefill_t0 - req.submit_time, 0.0),
                wire_bytes=sum(int(out[kk].nbytes)
                               for kk in ("k", "v", "ks", "vs")
                               if kk in out))
        # detach: the decode engine owns the request from its first token
        # on. The registry's refs keep this prompt's full blocks resident
        # for future prefix hits; the request's own refs drop.
        del self._running[slot]
        self._tables[slot] = 0
        self._free.append(slot)
        req.slot = -1
        for page in req.page_ids:
            self.pool.decref(page)
        req.page_ids = []
        req.status = "done"
        self._update_gauges()
        return out

    def _all_heads(self, slab: torch.Tensor) -> torch.Tensor:
        """This rank's pages ``[L, n, Hkv / mp, ...]`` with every rank's kv
        heads (dim 2, in rank order): an exported frame carries every kv
        head at any mp degree, as at mp 1. Every rank of the group calls
        it."""
        if self._mp_group is None:
            return slab
        parts = _C.stacked_all_gather(slab, self._mp_group)
        return torch.cat(list(parts), dim=2)

    def _slab(self, x, dtype: Optional[str]) -> torch.Tensor:
        """An imported slab (host array, or tensor) on this engine's
        device: at mp > 1 this rank's kv heads of the frame's (dim 2)."""
        if not isinstance(x, torch.Tensor):
            x = from_host(x, dtype, "cpu")
        if self._mp_group is not None:
            h = self._kv_heads
            r = max(self._mp_group.rank, 0)
            x = x[:, :, r * h:(r + 1) * h]
        return x.to(self.device)

    def try_import_prefill(self, prompt, params: SamplingParams, kv: dict,
                           *, trace: Optional[dict] = None,
                           tenant: Optional[str] = None,
                           slo: Optional[str] = None) -> Optional[int]:
        """Adopt a prefill computed on ANOTHER engine: write its exported
        content pages into this pool and seat the request directly in
        decode (no local prefill runs). ``kv`` is a ``prefill_export``
        payload (after any wire codec round trip; its ``dtype`` tag names
        int16 words of a bf16 pool).

        With a raw wire and matching ``kv_dtype`` the imported pages are
        bit-identical to a local prefill, so greedy decode matches a
        unified engine exactly; an int8 wire over a float pool dequantizes
        on import. Returns the new request id, or ``None`` when no slot or
        pages are free right now (the caller retries next poll). Raises
        ValueError on bad requests or a prompt/payload length mismatch.
        """
        ids = self._prompt_ids(prompt)
        t0 = int(ids.shape[0])
        if int(kv["true_len"]) != t0:
            raise ValueError(
                f"KV payload prefilled {int(kv['true_len'])} tokens but the "
                f"prompt has {t0}")
        if t0 + params.max_new_tokens > self.config.max_length:
            raise ValueError(
                f"prompt ({t0}) + max_new_tokens ({params.max_new_tokens}) "
                f"exceeds max_length={self.config.max_length}")
        p = self.config.page_size
        total_pages = -(-(t0 + params.max_new_tokens) // p)
        if total_pages > self._num_pages - 1:
            raise ValueError(
                f"request needs {total_pages} KV pages but the pool only "
                f"has {self._num_pages - 1}")
        if not self._free:
            return None
        if self.pool.available() < total_pages and self.registry is not None:
            self.registry.evict_unused(total_pages - self.pool.available())
        pages = self.pool.alloc(total_pages)
        if pages is None:
            return None
        slot = self._free.pop()
        content_pages = -(-t0 // p)
        row = np.zeros(self._mp, np.int32)
        row[:total_pages] = pages
        self._tables[slot] = row
        idx = torch.as_tensor(pages[:content_pages], dtype=torch.long,
                              device=self.device)
        dtype = kv.get("dtype")
        k_in = self._slab(kv["k"], dtype)
        v_in = self._slab(kv["v"], dtype)
        if self._int8 and "ks" in kv:
            # int8 source pool -> int8 pool: copy the quantized slabs and
            # their scales verbatim (bit-equal)
            self._kc[:, idx] = k_in.to(self._kc.dtype)
            self._vc[:, idx] = v_in.to(self._vc.dtype)
            self._ksc[:, idx] = self._slab(kv["ks"], None).float()
            self._vsc[:, idx] = self._slab(kv["vs"], None).float()
        elif self._int8:
            # float payload into an int8 pool: requantize at the
            # per-[page, head, token] granularity the prefill writes use
            qk, sk = quantize_absmax(k_in.float(), axis=-1)
            qv, sv = quantize_absmax(v_in.float(), axis=-1)
            self._kc[:, idx] = qk
            self._vc[:, idx] = qv
            self._ksc[:, idx] = sk[..., 0]
            self._vsc[:, idx] = sv[..., 0]
        else:
            if "ks" in kv:  # int8 source pool -> float pool
                k_in = dequantize_absmax(
                    k_in, self._slab(kv["ks"], None).float()[..., None])
                v_in = dequantize_absmax(
                    v_in, self._slab(kv["vs"], None).float()[..., None])
            self._kc[:, idx] = k_in.to(self._kc.dtype)
            self._vc[:, idx] = v_in.to(self._vc.dtype)
        rid = self._next_id
        self._next_id += 1
        now = time.perf_counter()
        req = Request(req_id=rid, prompt=ids, params=params,
                      seed=self._request_seed(params, rid),
                      status="running", slot=slot, submit_time=now)
        req.page_ids = list(pages)
        req.prefill_t0 = now
        req.prefill_s = float(kv.get("prefill_s", 0.0))
        req.first_token_time = now
        req.imported = True
        _trace_fields(req, trace,
                      tenant if tenant is not None else kv.get("tenant"),
                      slo if slo is not None else kv.get("slo"))
        self.accounting_ledger(create=True)
        if self.registry is not None:
            keys = PrefixRegistry.block_keys(ids, p)
            for j in range(t0 // p):
                self.registry.register(keys[j], int(row[j]))
        req.epoch = self._epoch
        self._requests[rid] = req
        self._running[slot] = req
        _obs.inc("serving_requests_total")
        # the first token was sampled (and counted) on the prefill engine;
        # _append_token handles the instant-EOS / 1-token budget edge
        self._append_token(req, int(kv["first_token"]))
        self._update_gauges()
        return rid

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
        _obs.set_gauge("serving_queue_depth", float(len(self._waiting)))
        self._update_gauges()

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
        req.cached_len = cached_len
        self.prefix_hit_tokens += cached_len
        if cached_len:
            _obs.inc("serving_prefix_hit_tokens", cached_len)
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
        logits, exact = self._prefill_body(ids, cached_len, t0, row)
        # sample stream keyed by DESTINATION position: the token landing at
        # position t0 uses seed (request, t0), as the decode step would
        nxt = _sample_tokens(logits, [_mix_seed(req.seed, t0)], temp,
                             top_k, top_p, greedy, exact_argmax=exact)
        token = int(nxt[0])
        now = time.perf_counter()
        self.prefill_seconds += now - tp0
        self.prefill_calls += 1
        req.first_token_time = now
        req.prefill_t0 = tp0
        req.prefill_s = now - tp0
        _obs.observe("serving_ttft_seconds", now - req.submit_time)
        if req.trace_id is not None:
            _obs.record_span(
                "srv_prefill", trace_id=req.trace_id,
                parent_id=req.trace_parent, dur_s=req.prefill_s,
                rid=req.req_id, bucket=int(tb), cached_len=int(cached_len),
                kernel=self._attn_kernel)
        req.slot = slot
        req.status = "running"
        req.epoch = self._epoch  # admission pins the epoch it prefilled on
        self._running[slot] = req
        self.total_tokens += 1
        self.prompt_tokens_total += t0
        _obs.inc("serving_tokens_total")
        self._append_token(req, token)

    def _append_token(self, req: Request, token: int):
        req.tokens.append(token)
        p = req.params
        if len(req.tokens) >= p.max_new_tokens or (
                p.eos_token_id is not None and token == p.eos_token_id):
            self._finish(req)

    def _finish(self, req: Request):
        req.status = "done"
        if self._acct is not None:
            # charge the page-occupancy tail while the request still holds
            # its pages, then attribute its totals to the ledger
            self._acct_tick(time.perf_counter())
            self._acct_request(req)
        if req.slot >= 0:
            del self._running[req.slot]
            self._tables[req.slot] = 0
            self._free.append(req.slot)
            req.slot = -1
            if req.epoch in self._epoch_vals and not any(
                    r.epoch == req.epoch for r in self._running.values()):
                # the last in-flight request of a retired epoch: release
                # its pinned weights
                del self._epoch_vals[req.epoch]
        for page in req.page_ids:
            self.pool.decref(page)
        req.page_ids = []
        ttft = (None if req.first_token_time is None
                else req.first_token_time - req.submit_time)
        queue_s = (None if req.prefill_t0 is None
                   else req.prefill_t0 - req.submit_time)
        decode_s = (0.0 if req.decode_t0 is None
                    else time.perf_counter() - req.decode_t0)
        if req.trace_id is not None and req.decode_t0 is not None:
            did = _obs.record_span(
                "srv_decode", trace_id=req.trace_id,
                parent_id=req.trace_parent, dur_s=decode_s,
                rid=req.req_id, steps=req.decode_steps_n,
                tokens=len(req.tokens), kernel=self._attn_kernel)
            if req.verify_steps_n:
                # the speculative share of the decode window, parented to
                # the srv_decode span it partitions
                _obs.record_span(
                    "srv_verify", trace_id=req.trace_id, parent_id=did,
                    dur_s=decode_s * req.verify_steps_n
                    / max(req.decode_steps_n, 1),
                    steps=req.verify_steps_n, accepted=req.spec_accepted_n)
        _obs.event("serving_request_done", req_id=req.req_id,
                   prompt_tokens=int(len(req.prompt)),
                   generated_tokens=len(req.tokens), ttft_seconds=ttft,
                   queue_s=queue_s, prefill_s=round(req.prefill_s, 6),
                   decode_s=round(decode_s, 6),
                   spec_accepted=req.spec_accepted_n,
                   spec_wasted=max(
                       self.config.speculate_k * req.verify_steps_n
                       - req.spec_accepted_n, 0),
                   tenant=req.tenant, slo_class=req.slo,
                   imported=req.imported, kv_page_us=req.acct_page_us,
                   resubmitted=req.resubmitted)

    def _acct_request(self, req: Request):
        """Fold one finished request into the per-tenant ledger. An
        imported request's prompt and first token were metered on the
        prefill engine (``prefill_export``), so only its remaining
        generated tokens count here."""
        wasted = max(self.config.speculate_k * req.verify_steps_n
                     - req.spec_accepted_n, 0)
        queue_s = (0.0 if req.prefill_t0 is None
                   else max(req.prefill_t0 - req.submit_time, 0.0))
        self._acct.add(
            req.tenant, req.slo, requests=1,
            prefill_tokens=0 if req.imported else int(len(req.prompt)),
            decode_tokens=len(req.tokens) - (1 if req.imported else 0),
            spec_accepted_tokens=req.spec_accepted_n,
            spec_wasted_tokens=wasted, queue_seconds=queue_s)

    def _update_gauges(self):
        in_use = self._num_pages - 1 - self.pool.available()
        self.peak_pages_in_use = max(self.peak_pages_in_use, in_use)
        self.peak_running = max(self.peak_running, len(self._running))
        if not _obs.enabled():
            return
        used = sum(len(r.prompt) + len(r.tokens)
                   for r in self._running.values())
        _obs.set_gauge("serving_batch_occupancy",
                       len(self._running) / float(self.config.num_slots))
        _obs.set_gauge("serving_kv_cache_utilization",
                       used / float((self._num_pages - 1)
                                    * self.config.page_size))
        _obs.set_gauge("serving_kv_pages_free", float(self.pool.available()))
        _obs.set_gauge("serving_kv_pages_shared",
                       float(self.pool.shared_pages()))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- versioned weight epochs (serving/online.py) ------------------------

    @property
    def weight_epoch(self) -> int:
        """The epoch new admissions are pinned to."""
        return self._epoch

    def state_keys(self) -> List[str]:
        """Leaf names in state order (parameters then buffers, each tensor
        under its first name): the wt stream's address space."""
        return list(self._state_names)

    def _make_adapter(self):
        g = self._mesh_group
        return (self.model.decode_adapter() if g is None
                else self.model.decode_adapter(mp_group=g))

    @contextlib.contextmanager
    def _weights_of(self, epoch: int):
        """Run the block on ``epoch``'s weights: the live ones, or the
        values (and the adapter built on them) pinned for an older epoch's
        in-flight requests, bound into the model's tensors for the block
        and the live ones bound back after it."""
        if epoch == self._epoch:
            yield
            return
        vals, adapter = self._epoch_vals[epoch]
        live, live_adapter = [t.data for t in self._state], self.adapter
        for t, v in zip(self._state, vals):
            t.data = v
        self.adapter = adapter
        try:
            yield
        finally:
            for t, v in zip(self._state, live):
                t.data = v
            self.adapter = live_adapter

    def begin_weight_epoch(self, epoch: int) -> bool:
        """Open the shadow set for ``epoch``: the live values, which
        :meth:`stage_weight` replaces leaf by leaf while decoding goes on
        on the live set. False (a no-op) when ``epoch`` is not newer than
        the live one: a replayed wt stream after a crash must not reopen a
        committed epoch."""
        epoch = int(epoch)
        if epoch <= self._epoch:
            return False
        self._shadow = {"epoch": epoch,
                        "vals": [t.data for t in self._state],
                        "staged": set()}
        return True

    def stage_weight(self, name: str, value) -> None:
        """Stage one leaf's new-epoch value (a host array or a tensor)
        into the shadow set, cast to the live leaf's dtype and placed on
        its device. The live set, and every in-flight request, is
        untouched until :meth:`promote_epoch`."""
        if self._shadow is None:
            raise RuntimeError("stage_weight with no open shadow epoch "
                               "(begin_weight_epoch first)")
        i = self._state_index[name]
        cur = self._state[i].data
        val = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value)
        if tuple(val.shape) != tuple(cur.shape):
            raise ValueError(
                f"staged weight {name!r} shape {tuple(val.shape)} != "
                f"live {tuple(cur.shape)}")
        self._shadow["vals"][i] = val.to(device=cur.device, dtype=cur.dtype,
                                         copy=True)
        self._shadow["staged"].add(name)

    def discard_shadow(self, epoch: Optional[int] = None) -> bool:
        """Drop an unpromoted shadow set (a weight transaction's
        rollback); ``epoch`` narrows it to that epoch's shadow. False when
        there is nothing to drop."""
        if self._shadow is None:
            return False
        if epoch is not None and self._shadow["epoch"] != int(epoch):
            return False
        self._shadow = None
        return True

    def promote_epoch(self, epoch: int) -> bool:
        """Make the staged shadow set live, at a request boundary: the
        tensors' values are swapped, no slot is drained. In-flight
        requests keep decoding on their pinned epoch (its values are kept
        for them), new admissions read the promoted set. The prefix
        registry is dropped: its pages hold the old weights' KV. An
        ``epoch`` at or below the live one, or with no matching shadow,
        is a False no-op, so a replayed swap order flips at most once. Only
        ``serving/online.py::apply_wt_frame`` calls it."""
        epoch = int(epoch)
        if epoch <= self._epoch:
            return False
        if self._shadow is None or self._shadow["epoch"] != epoch:
            return False
        if any(r.epoch == self._epoch for r in self._running.values()):
            self._epoch_vals[self._epoch] = (
                [t.data for t in self._state], self.adapter)
        for t, v in zip(self._state, self._shadow["vals"]):
            t.data = v
        self.adapter = self._make_adapter()
        self._epoch = epoch
        self._shadow = None
        # the registry's pages hold the old weights' KV and its keys hash
        # the prompt alone: a new admission must not attach them
        self.release_prefix_cache()
        live = {r.epoch for r in self._running.values()}
        for e in [e for e in self._epoch_vals if e not in live]:
            del self._epoch_vals[e]
        return True

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

    def _embed(self, ids, positions):
        """The embeddings (a model built at mp > 1 sums its vocab-parallel
        lookups over the group, exactly: the activation wire stays off
        inside the engine, as the reference's programs keep it)."""
        with _mp_comm.activation_wire_disabled():
            return self.adapter.embed(ids, positions)

    @torch.no_grad()
    def _prefill_body(self, ids, cached_len: int, true_len: int,
                      row: np.ndarray):
        """Tail prefill of one request (S=1, T=bucket): returns the last
        real token's logits [1, V] f32 and the exact argmax or None
        (:meth:`_recombine`)."""
        ad, dev = self.adapter, self.device
        tb = ids.shape[1]
        psz, int8 = self.config.page_size, self._int8
        positions = cached_len + torch.arange(tb, device=dev)
        start = torch.tensor([cached_len], dtype=torch.int32, device=dev)
        table = torch.as_tensor(row[None], device=dev)  # [1, MP] int32
        x = self._embed(torch.as_tensor(ids, device=dev), positions)

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
        return self._recombine(ad.logits(x[:, off:off + 1])[:, 0])

    def _token_body(self, tokens, positions, tables=None):
        """Decode (T=1) and verify (T=k+1) share one body: tokens [S, T],
        positions [S] (position of each slot's first token), the page
        tables (default: the engine's). Returns logits [S, T, V] f32 and
        the exact argmax or None."""
        ad, dev = self.adapter, self.device
        psz, int8 = self.config.page_size, self._int8
        t = tokens.shape[1]
        start = torch.as_tensor(positions, device=dev)
        pos2 = start[:, None] + torch.arange(t, device=dev)[None, :]
        tables = torch.as_tensor(self._tables if tables is None else tables,
                                 device=dev)
        x = self._embed(torch.as_tensor(tokens, device=dev), pos2)

        def write(l, k, v):
            _token_page_write(self._kc, self._ksc, l, k, tables, pos2, int8,
                              psz)
            _token_page_write(self._vc, self._vsc, l, v, tables, pos2, int8,
                              psz)

        x = self._layers(x, pos2, tables, start.to(torch.int32), write)
        return self._recombine(ad.logits(x))

    @torch.no_grad()
    def _decode_body(self, tokens, positions, tables=None):
        """Single-token decode over all slots: logits [S, V] f32 (and the
        exact argmax [S] or None)."""
        logits, exact = self._token_body(tokens[:, None], positions, tables)
        return logits[:, 0], (None if exact is None else exact[:, 0])

    @torch.no_grad()
    def _verify_body(self, tokens, positions):
        """Speculative verify, k+1 tokens per slot: logits [S, k+1, V]
        (and the exact argmax [S, k+1] or None)."""
        return self._token_body(tokens, positions)
