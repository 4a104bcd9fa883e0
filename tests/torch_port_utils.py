"""Shared helpers of the PyTorch-port parity tests: a tiny reference GPT,
Llama and BERT / ERNIE encoders built in ``paddle_tpu`` (JAX, CPU), the
numpy bridge of their weights, and the multi-process runner of the
distributed tests.

Importing this module loads neither JAX nor the reference package (each
helper imports what it needs), so the processes the distributed tests
spawn import it cheaply."""
import contextlib
import os
import pickle
import time

import numpy as np
import pytest

VOCAB = 61


def tiny_gpt_kwargs(**kw):
    return dict(dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, max_position_embeddings=128,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0), **kw)


@contextlib.contextmanager
def no_mesh():
    """Run the reference with no hybrid-parallel group or global mesh in
    force (a fleet test may have left one behind in this interpreter)."""
    from paddle_tpu.distributed import mesh as _mesh
    from paddle_tpu.distributed.fleet.topology import (
        get_hybrid_communicate_group, set_hybrid_communicate_group)

    prev = get_hybrid_communicate_group()
    prev_mesh = _mesh.get_global_mesh()
    set_hybrid_communicate_group(None)
    _mesh.set_global_mesh(None)
    try:
        yield
    finally:
        set_hybrid_communicate_group(prev)
        _mesh.set_global_mesh(prev_mesh)


@contextlib.contextmanager
def jax_tiny_gpt(seed=7, **kw):
    """The reference GPTForCausalLM at the tiny size (``kw`` overrides
    :func:`tiny_gpt_kwargs`), built and run under :func:`no_mesh`."""
    import paddle_tpu as paddle
    from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM

    with no_mesh():
        paddle.seed(seed)
        m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs(**kw)))
        m.eval()
        yield m


def numpy_state(model):
    """The reference model's state (parameters and buffers) as
    {name: ndarray}. A bf16 leaf (a ``decorate``d model's) comes as f32,
    which holds every bf16 value exactly: loaded into a bf16 parameter of
    the port it is the reference's value bit for bit."""
    from paddle_tpu.framework.op import raw

    out = {}
    for k, v in model.state_dict().items():
        a = np.asarray(raw(v))
        out[k] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return out


def torch_tiny_gpt(np_state, **kw):
    """The port's GPT on the CPU carrying the bridged reference weights."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs(**kw)), device="cpu")
    return m.load_numpy_state(np_state)


def tiny_llama_kwargs(group=2, **kw):
    """A 2-layer Llama whose query heads share each kv head ``group`` ways:
    G=2 at hidden 32 (4 heads, 2 kv heads), G=4 at hidden 64 (8 heads, 2
    kv heads); head_dim 8 in both."""
    heads = {2: 4, 4: 8}[group]
    return dict(dict(vocab_size=VOCAB, hidden_size=8 * heads,
                     num_hidden_layers=2, num_attention_heads=heads,
                     num_key_value_heads=heads // group,
                     max_position_embeddings=64, rope_theta=500000.0), **kw)


@contextlib.contextmanager
def jax_tiny_llama(seed=7, **kw):
    """The reference LlamaForCausalLM at :func:`tiny_llama_kwargs`' size,
    built and run under :func:`no_mesh`."""
    import paddle_tpu as paddle
    from paddle_tpu.text.models.llama import LlamaConfig, LlamaForCausalLM

    with no_mesh():
        paddle.seed(seed)
        m = LlamaForCausalLM(LlamaConfig(**tiny_llama_kwargs(**kw)))
        m.eval()
        yield m


def torch_tiny_llama(np_state, **kw):
    """The port's Llama on the CPU carrying the bridged reference state."""
    from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM)

    m = LlamaForCausalLM(LlamaConfig(**tiny_llama_kwargs(**kw)),
                         device="cpu")
    return m.load_numpy_state(np_state)


def tiny_encoder_kwargs(kind="ernie", **kw):
    """A 2-layer encoder at hidden 32 with 4 heads (head_dim 8) and
    dropouts 0; ERNIE with its task-type table."""
    base = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    if kind == "ernie":
        base.update(type_vocab_size=4, task_type_vocab_size=3)
    return dict(base, **kw)


ENCODER_HEADS = {
    "bert": ("BertModel", "BertForMaskedLM", "BertForSequenceClassification"),
    "ernie": ("ErnieModel", "ErnieForMaskedLM",
              "ErnieForSequenceClassification",
              "ErnieForTokenClassification"),
}


def _encoder_module(pkg, kind):
    import importlib

    return importlib.import_module(f"{pkg}.text.models.{kind}")


def _encoder_args(kind, head):
    return {} if head.endswith(("Model", "MaskedLM")) else {"num_classes": 3}


@contextlib.contextmanager
def jax_tiny_encoder(kind="ernie", head="ErnieForSequenceClassification",
                     seed=7, train=False, **kw):
    """The reference encoder ``head`` (a class of ``bert.py`` /
    ``ernie.py``) at :func:`tiny_encoder_kwargs`' size, built and run under
    :func:`no_mesh`; in eval mode unless ``train``."""
    import paddle_tpu as paddle

    mod = _encoder_module("paddle_tpu", kind)
    cfg = getattr(mod, f"{kind.capitalize()}Config")
    with no_mesh():
        paddle.seed(seed)
        m = getattr(mod, head)(cfg(**tiny_encoder_kwargs(kind, **kw)),
                               **_encoder_args(kind, head))
        if not train:
            m.eval()
        yield m


def torch_tiny_encoder(np_state, kind="ernie",
                       head="ErnieForSequenceClassification", **kw):
    """The port's encoder ``head`` on the CPU carrying the bridged
    reference state."""
    from paddle_tpu_torch.framework.io_state import load_numpy_state

    mod = _encoder_module("paddle_tpu_torch", kind)
    cfg = getattr(mod, f"{kind.capitalize()}Config")
    m = getattr(mod, head)(cfg(**tiny_encoder_kwargs(kind, **kw)),
                           **_encoder_args(kind, head), device="cpu")
    return load_numpy_state(m, np_state)


def encoder_batch(b=3, t=12, seed=5, kind="ernie"):
    """Ids, token types and a keep-mask ``[b, t]`` as a tokenizer gives
    them: row i keeps a prefix of a different length (the first row the
    full length), its first segment type 0 and the rest type 1; padded
    ids are 0."""
    rng = np.random.default_rng(seed)
    lengths = np.linspace(t, max(t // 3, 2), b).astype(int)
    ids = rng.integers(1, VOCAB, (b, t))
    types = np.zeros((b, t), np.int64)
    mask = np.zeros((b, t), np.int64)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
        ids[i, n:] = 0
        types[i, n // 2:n] = 1
    return ids, types, mask


# -- TF32 emulation (the tensor-core products of kernels K1, K2 and K3) ------

def tf32_round(x):
    """``cvt.rna.tf32.f32`` on a f32 tensor: round to 10 mantissa bits,
    to nearest with ties away from zero (add half of the 13 dropped bits
    to the magnitude's bit pattern, then clear them)."""
    import torch

    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """What a TF32 tensor core reads of a f32 operand: its top 19 bits
    (the low 13 mantissa bits dropped)."""
    import torch

    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def tf32_split(x):
    """The kernels' split as the tensor core sees it: ``hi`` = x rounded
    to TF32 (``cvt.rna``), ``lo`` = the exact remainder ``x - hi`` read to
    TF32 (truncated)."""
    hi = tf32_round(x)
    return hi, tf32_trunc(x.float() - hi)


def tf32_split_trunc(x):
    """The backward kernels' split (K2a, K2b) as the tensor core sees it:
    ``hi`` = x read to TF32 (truncated), ``lo`` = the exact remainder
    ``x - trunc(x)`` read to TF32 (truncated)."""
    hi = tf32_trunc(x)
    return hi, tf32_trunc(x.float() - hi)


def tf32_matmul(a, b, passes, split="rna"):
    """``a @ b`` as the kernels compute it on TF32 tensor cores: products
    of TF32 operands are exact and summed in (here: better than) f32.
    ``passes`` 1: one TF32 product of the operands as the tensor core reads
    them; 2: ``a`` split, ``b`` already exact in TF32 (a bf16 or int8
    value); 3: both split, ``lo.hi + hi.lo + hi.hi``. ``split``: ``"rna"``
    (hi rounded, :func:`tf32_split`: K1, K3) or ``"trunc"`` (hi truncated,
    :func:`tf32_split_trunc`: K2a, K2b). Returns f32."""
    import torch

    def mm(x, y):
        return torch.matmul(x.double(), y.double())

    read, halves = {"rna": (tf32_round, tf32_split),
                    "trunc": (tf32_trunc, tf32_split_trunc)}[split]
    if passes == 1:
        out = mm(read(a), read(b))
    elif passes == 2:
        if not torch.equal(tf32_round(b), b.float()):
            raise ValueError("two-pass products need b exact in TF32")
        ah, al = halves(a)
        out = mm(al, b) + mm(ah, b)
    elif passes == 3:
        ah, al = halves(a)
        bh, bl = halves(b)
        out = mm(al, bh) + mm(ah, bl) + mm(ah, bh)
    else:
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    return out.float()


# -- multi-process runs of the distributed tests (CPU, gloo) -----------------
# Each spawn rendezvouses on a file under the test's tmp_path (never a
# fixed TCP port: xdist runs files side by side), and is joined under its
# own time limit: a hung gloo collective kills the children and fails the
# one test instead of stalling the suite.

SPAWN_TIMEOUT = 240


def spawn_ranks(fn, nprocs, out_dir, *args):
    """Start ``fn(out_dir, *args)`` in ``nprocs`` processes (spawn start
    method) as ranks of one world, by the port's ``distributed.spawn``.
    Returns the context; :func:`join_ranks` collects the results."""
    from paddle_tpu_torch.distributed import spawn

    os.makedirs(out_dir, exist_ok=True)
    master = "file://" + os.path.join(str(out_dir), "rendezvous")
    return spawn(_rank_main, (fn, str(out_dir)) + tuple(args),
                 nprocs=nprocs, join=False, master=master, backend="gloo")


def join_ranks(ctx, out_dir, timeout=SPAWN_TIMEOUT):
    """Wait for the ranks (killing them past ``timeout`` s) and return
    each rank's pickled result, by rank."""
    from paddle_tpu_torch.distributed.parallel import join_spawned

    join_spawned(ctx, timeout)
    out = []
    for r in range(len(ctx.processes)):
        with open(os.path.join(str(out_dir), f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(fn, out_dir, *args):
    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist

    paddle.set_device("cpu")
    dist.init_parallel_env(backend="gloo")
    result = fn(*args)
    rank = dist.get_rank()
    with open(os.path.join(out_dir, f"rank{rank}.pkl.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(out_dir, f"rank{rank}.pkl.tmp"),
               os.path.join(out_dir, f"rank{rank}.pkl"))
    dist.barrier()
    dist.destroy_process_group()


FLEET_LR = 1e-3


def fleet_adamw(params, opt_mod, clip, multi_precision=False,
                clip_norm=1.0):
    """The AdamW of the fleet trajectories (both packages)."""
    kw = dict(multi_precision=True) if multi_precision else {}
    return opt_mod.AdamW(learning_rate=FLEET_LR, beta1=0.9, beta2=0.95,
                         epsilon=1e-8, parameters=params, weight_decay=0.1,
                         grad_clip=clip(clip_norm), **kw)


def port_model(kind, state, sequence_parallel=False, **kw):
    """The port's tiny GPT (``kind`` "gpt", vocab 64) or Llama (G = 2) on
    the CPU, built after ``fleet.init`` if any (``kw`` overrides the
    config), carrying the full reference ``state`` (unfolded names; a
    folded or pipelined stack takes it stacked, :func:`to_stacked`)."""
    if kind == "gpt":
        from paddle_tpu_torch.text.models.gpt import GPTConfig as C
        from paddle_tpu_torch.text.models.gpt import GPTForCausalLM as M

        cfg = C(**tiny_gpt_kwargs(vocab_size=64,
                                  sequence_parallel=sequence_parallel, **kw))
    else:
        from paddle_tpu_torch.text.models.llama import LlamaConfig as C
        from paddle_tpu_torch.text.models.llama import LlamaForCausalLM as M

        cfg = C(**tiny_llama_kwargs(vocab_size=64,
                                    sequence_parallel=sequence_parallel,
                                    **kw))
    m = M(cfg, device="cpu")
    return m.load_numpy_state(to_stacked(m, state))


def _stacks(model):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import SpmdPipeline

    return [(f"{p}." if p else "", m) for p, m in model.named_modules()
            if isinstance(m, SpmdPipeline)]


def to_stacked(model, state):
    """An unfolded state (``{prefix}.{layer}.{leaf}``) in the stacked
    layout of ``model``'s stacks (``{prefix}.{leaf with __}`` of shape
    ``[L, ...]``, layers in the stack's ``_layer_order``)."""
    out = dict(state)
    for prefix, m in _stacks(model):
        for leaf, key in m._leaves:
            per = [out.pop(f"{prefix}{i}.{leaf}") for i in range(m.num_layers)]
            out[prefix + key] = np.stack([per[i] for i in m._layer_order])
    return out


def from_stacked(model, state):
    """The inverse of :func:`to_stacked` on a full (gathered) state."""
    out = dict(state)
    for prefix, m in _stacks(model):
        for leaf, key in m._leaves:
            full = np.asarray(out.pop(prefix + key))
            for pos, layer in enumerate(m._layer_order):
                out[f"{prefix}{layer}.{leaf}"] = full[pos]
    return out


def fleet_job(job, state, batch):
    """One ``DistTrainStep`` trajectory on this rank: ``fleet.init`` at the
    job's degrees, the model, ``distributed_model`` /
    ``distributed_optimizer``, ``job["steps"]`` steps on the global
    ``batch``. Returns the losses, the gathered full parameters, this
    rank's own parameters and its optimizer's state counts."""
    import torch

    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.fleet.layers.mpu import is_mp_shard
    from paddle_tpu_torch.framework.io_state import gather_full_state

    fleet.init(is_collective=True, strategy=_strategy(job))
    model = port_model(job["model"], state, job.get("sp", False),
                       **job.get("config", {}))
    mpre = job.get("multi_precision", False)
    if mpre:
        model.to(torch.bfloat16)
    opt = fleet_optimizer(job, model.parameters(), topt, topt)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    if job.get("local_norms"):  # a trust ratio of the rank's part alone
        opt._inner_opt._split_sum = None
    if "mask" in batch:
        def loss_fn(m, i, lab, k):
            return m(i, labels=lab, loss_mask=k)
    else:
        def loss_fn(m, i, lab):
            return m(i, labels=lab)
    step = fleet.DistTrainStep(model, loss_fn, opt)
    args = [torch.from_numpy(batch[k]) for k in ("ids", "labels", "mask")
            if k in batch]
    collective.reset_counts()
    t0 = time.perf_counter()
    losses = [float(step(*args)) for _ in range(job.get("steps", 3))]
    hcg = fleet.get_hybrid_communicate_group()
    inner = opt._inner_opt
    out = dict(
        losses=losses, seconds=time.perf_counter() - t0,
        counts=dict(collective.counts),
        full={k: v.float().numpy()
              for k, v in gather_full_state(model).items()},
        local={n: p.detach().float().numpy()
               for n, p in model.named_parameters()},
        distributed=[n for n, p in model.named_parameters()
                     if is_mp_shard(p)],
        sequence_parallel=[n for n, p in model.named_parameters()
                           if getattr(p, "sequence_parallel", False)],
        mp_rank=hcg.get_model_parallel_rank(),
        data_rank=hcg.get_data_sharding_parallel_rank(),
        states=sum(st is not None for st in inner._accumulators),
        masters=len(inner._master),
        owned=sum(opt.owns(i) for i in range(len(inner._parameter_list))))
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def _eager_steps(model, opt, batch, rows, sync):
    """``steps`` eager steps on this rank's ``rows`` of the batch: loss,
    backward, ``sync()`` (the gradient exchange, if any), step."""
    import torch

    ids, labels = (torch.from_numpy(batch[k][rows]) for k in ("ids",
                                                              "labels"))
    losses = []
    for _ in range(3):
        loss = model(ids, labels=labels)
        loss.backward()
        sync()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def data_parallel_job(job, state, batch):
    """``DataParallel`` over the world: each rank's quarter of the batch,
    the gradients averaged by the wrapper's backward hook."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt

    model = dist.DataParallel(port_model(job["model"], state))
    opt = fleet_adamw(model.parameters(), topt, topt.ClipGradByGlobalNorm)
    k = batch["ids"].shape[0] // dist.get_world_size()
    rows = slice(dist.get_rank() * k, (dist.get_rank() + 1) * k)
    losses = _eager_steps(model, opt, batch, rows, lambda: None)
    return dict(losses=losses, full={n: p.detach().numpy() for n, p in
                                     model._layers.named_parameters()})


def group_sharded_job(job, state, batch):
    """``group_sharded_parallel`` at sharding = world size: an eager loop
    with ``fused_allreduce_gradients`` between backward and step."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.utils import hybrid_parallel_util
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=1, sharding_degree=dist.get_world_size())
    fleet.init(is_collective=True, strategy=s)
    model = port_model(job["model"], state)
    opt = fleet_adamw(model.parameters(), topt, topt.ClipGradByGlobalNorm)
    model, opt, _ = group_sharded_parallel(model, opt, job["level"])
    hcg = fleet.get_hybrid_communicate_group()
    k = batch["ids"].shape[0] // hcg.get_data_sharding_parallel_world_size()
    r = hcg.get_data_sharding_parallel_rank()
    params = list(model.parameters())
    losses = _eager_steps(
        model, opt, batch, slice(r * k, (r + 1) * k),
        lambda: hybrid_parallel_util.fused_allreduce_gradients(params))
    out = dict(losses=losses,
               full={n: p.detach().numpy()
                     for n, p in model.named_parameters()},
               states=sum(st is not None
                          for st in opt._inner_opt._accumulators))
    save_group_sharded_model(model, os.path.join(job["save_dir"], "gs"),
                             opt)
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def api_job(job, state, batch):
    """Under ``fleet.init(mp)``: ``DistributedBatchSampler``'s index lists
    with the default replicas and rank, the ``TensorParallel`` /
    ``GroupShardedStage2`` wrappers, and the sequence-parallel gradient
    hooks on a ``RowSequenceParallelLinear``'s bias."""
    import torch

    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel
    from paddle_tpu_torch.distributed.fleet.utils import (
        sequence_parallel_utils as spu)
    from paddle_tpu_torch.io import DistributedBatchSampler

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=-1, mp_degree=job["mp"])
    fleet.init(is_collective=True, strategy=s)
    out = {}
    for shuffle, drop_last in ((False, False), (True, True)):
        bs = DistributedBatchSampler(list(range(11)), batch_size=2,
                                     shuffle=shuffle, drop_last=drop_last)
        out[(shuffle, drop_last)] = (bs.nranks, bs.local_rank, list(bs),
                                     len(bs))
    model = port_model("gpt", state)
    tp = meta_parallel.TensorParallel(model)
    ids = torch.from_numpy(batch["ids"])
    with torch.no_grad():
        out["tensor_parallel"] = (
            sorted(tp.state_dict()) == sorted(model.state_dict()),
            torch.equal(tp(ids), model(ids)))
    opt = fleet_adamw(model.parameters(), topt, topt.ClipGradByGlobalNorm)
    gs = meta_parallel.GroupShardedStage2(model, opt)
    out["group_sharded_stage"] = gs._optim._stage
    row = spu.RowSequenceParallelLinear(16, 8, device="cpu")
    spu.register_sequence_parallel_allreduce_hooks(row)
    x = torch.ones(3, 4, 16 // job["mp"])
    row(x).sum().backward()
    out["sp_bias_grad"] = row.bias.grad.numpy()
    out["zero3_entry_points"] = _zero3_entry_points()
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def _zero3_entry_points():
    """``GroupShardedStage3`` and ``group_sharded_parallel(level="p_g_os")``
    at sharding = world size: what they return."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import nn, optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=1, sharding_degree=dist.get_world_size())
    fleet.init(is_collective=True, strategy=s)
    lin = nn.Linear(8, 8)
    gs = meta_parallel.GroupShardedStage3(
        lin, topt.AdamW(parameters=lin.parameters()))
    lin2 = nn.Linear(8, 8)
    _, opt, _ = group_sharded_parallel(
        lin2, topt.AdamW(parameters=lin2.parameters()), level="p_g_os")
    return dict(group_sharded_stage=gs._optim._stage,
                level_p_g_os=opt._stage,
                weight_shape=tuple(lin.weight.shape))


def _pp_strategy(job):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=job.get("dp", -1),
                            mp_degree=job.get("mp", 1),
                            pp_degree=job["pp"],
                            sharding_degree=job.get("sharding", 1),
                            sep_degree=job.get("sep", 1))
    s.sharding_configs["stage"] = job.get("stage", 1)
    s.pipeline_configs.update(schedule=job.get("schedule", "gpipe"),
                              virtual_pp_degree=job.get("vpp", 1),
                              accumulate_steps=job.get("acc", 1))
    return s


def pipeline_job(job, state, batch):
    """One pipelined ``DistTrainStep`` trajectory on this rank (the tiny
    model at ``job["layers"]`` layers, ``fleet.init`` at the job's pp /
    dp / mp / sharding and schedule). Returns the losses, the gathered
    full state (unfolded names and the stacked one), this rank's
    parameters replicated over pp, its coordinates and the schedule runner's
    counts."""
    import torch

    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        pipeline_parallel as pp)
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding_stage3 \
        import zero3_spec
    from paddle_tpu_torch.framework.io_state import gather_full_state

    fleet.init(is_collective=True, strategy=_pp_strategy(job))
    model = port_model(job["model"], state, job.get("sp", False),
                       num_hidden_layers=job["layers"],
                       use_recompute=job.get("use_recompute", False))
    if job.get("bf16"):
        model.bfloat16()
    alive = _watch_gathered() if job.get("stage") == 3 else None
    opt = fleet_adamw(model.parameters(), topt, topt.ClipGradByGlobalNorm,
                      clip_norm=job.get("clip", 1.0))
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    if "mask" in batch:
        def loss_fn(m, i, lab, k):
            return m(i, labels=lab, loss_mask=k)
    else:
        def loss_fn(m, i, lab):
            return m(i, labels=lab)
    step = fleet.DistTrainStep(model, loss_fn, opt)
    args = [torch.from_numpy(batch[k]) for k in ("ids", "labels", "mask")
            if k in batch]
    collective.reset_counts()
    pp.reset_counts()
    steps = job.get("steps", 3)
    losses = [float(step(*args)) for _ in range(steps)]
    counts = dict(collective.counts)
    hcg = fleet.get_hybrid_communicate_group()
    stacked = {k: v.float().numpy()
               for k, v in gather_full_state(model).items()}
    out = dict(
        losses=losses, stacked=stacked, full=from_stacked(model, stacked),
        replicated={n: p.detach().float().numpy()
                    for n, p in model.named_parameters()
                    if not pp.is_pipeline_local(p)},
        stage=hcg.get_stage_id(), mp_rank=hcg.get_model_parallel_rank(),
        microbatches=pp.counts["forward_ops"] // (
            pp.pipelined_stack(model).num_virtual_stages * steps),
        # the bytes a gather of each ZeRO-3 slice brings from the others
        slice_bytes={n: p.numel() * p.element_size()
                     * (zero3_spec(p).group.nranks - 1)
                     for n, p in model.named_parameters() if zero3_spec(p)},
        counts=dict(pp.counts), collective=counts,
        staged=counts.get("p2p_staged_bytes", 0),
        p2p=counts.get("batch_isend_irecv", 0),
        alive_after_forward=None if alive is None else alive())
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def _watch_gathered():
    """Record how many gathered ZeRO-3 weights are still alive each time a
    ZeRO-3 forward ends (a pipeline's forward op); returns the reader of
    that list. Patches ``sharding_stage3`` in this process."""
    import weakref

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        sharding_stage3 as z3)

    live, seen = weakref.WeakSet(), []
    gather, scope = z3._gather, z3.forward_scope

    def watched_gather(shard, spec, counter="zero3_gather_bytes"):
        full = gather(shard, spec, counter)
        live.add(full)
        return full

    @contextlib.contextmanager
    def watched_scope():
        with scope():
            yield
        if not z3.gathering():
            seen.append(len(live))

    z3._gather, z3.forward_scope = watched_gather, watched_scope
    return lambda: list(seen)


PIPE_LM = dict(vocab=64, hidden=16, blocks=4)


def pipe_layer_lm(pkg):
    """``(descs, loss_fn)`` of a small LM as a ``PipelineLayer`` list in
    ``pkg`` (``paddle_tpu`` or ``paddle_tpu_torch``): a shared embedding,
    PIPE_LM["blocks"] residual tanh blocks, the embedding again as the
    tied head (``SharedLayerDesc``'s ``forward_func``), mean token cross
    entropy."""
    nn, F = pkg.nn, pkg.nn.functional
    mp = pkg.distributed.fleet.meta_parallel
    v, h = PIPE_LM["vocab"], PIPE_LM["hidden"]

    class Block(nn.Layer):
        def __init__(self, width):
            super().__init__()
            self.fc = nn.Linear(width, width)

        def forward(self, x):
            return x + F.tanh(self.fc(x))

    def head(emb, x):
        return pkg.matmul(x, emb.weight, transpose_y=True)

    def loss_fn(logits, labels):
        return F.cross_entropy(logits.reshape([-1, v]), labels.reshape([-1]))

    descs = ([mp.SharedLayerDesc("emb", nn.Embedding, None, "weight", v, h)]
             + [mp.LayerDesc(Block, h) for _ in range(PIPE_LM["blocks"])]
             + [mp.SharedLayerDesc("emb", nn.Embedding, head, "weight", v,
                                   h)])
    return descs, loss_fn


def pipeline_layer_job(job, state, batch):
    """``PipelineLayer`` -> ``distributed_model`` (``PipelineParallel``;
    with ``job["api"] == "group_sharded_parallel"`` that at level
    ``"p_g_os"``) -> ``train_batch`` at pp 2, then ``eval_batch`` with and
    without the loss."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding_stage3 \
        import is_zero3_slice
    from paddle_tpu_torch.framework.io_state import (gather_full_state,
                                                     load_numpy_state)

    fleet.init(is_collective=True, strategy=_pp_strategy(job))
    descs, loss_fn = pipe_layer_lm(paddle)
    model = mpar.PipelineLayer(descs, loss_fn=loss_fn)
    load_numpy_state(model, state)
    opt = fleet_adamw(model.parameters(), topt, topt.ClipGradByGlobalNorm)
    if job.get("api") == "group_sharded_parallel":
        from paddle_tpu_torch.distributed.sharding import (
            group_sharded_parallel)

        wrapped, opt, _ = group_sharded_parallel(model, opt, "p_g_os")
    else:
        wrapped = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
    x, y = (torch.from_numpy(batch[k]) for k in ("ids", "labels"))
    losses = [float(wrapped.train_batch((x, y), opt)) for _ in range(3)]
    ev = wrapped.eval_batch((x, y))
    logits = wrapped.eval_batch((x, y), compute_loss=False)
    out = dict(losses=losses, eval_loss=float(ev),
               logits=None if logits is None else logits.numpy(),
               wrapper=type(wrapped).__name__,
               kinds=[type(s).__name__ for s in model._segments],
               stage=fleet.get_hybrid_communicate_group().get_stage_id(),
               sliced=sum(is_zero3_slice(p) for p in model.parameters()),
               full={k: v.numpy() for k, v in
                     gather_full_state(model).items()})
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def pp_zero3_slices_job(job, state, batch):
    """At pp x sharding, stage 3, before any step: this rank's
    ``state_dict`` (its stage's stacked entries and the replicated ones,
    each cut to its ZeRO-3 slice) and its (pipe, sharding) coordinate."""
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True, strategy=_pp_strategy(job))
    model = fleet.distributed_model(port_model(job["model"], state,
                                               num_hidden_layers=job["layers"]))
    hcg = fleet.get_hybrid_communicate_group()
    out = dict(state={k: v.detach().numpy()
                      for k, v in model.state_dict().items()},
               coord=(hcg.get_stage_id(), hcg.get_sharding_parallel_rank()))
    fleet.topology.set_hybrid_communicate_group(None)
    return out


MOE_VOCAB = 64


def moe_net(paddle, **moe_kw):
    """The reference's ``_run_moe`` network (``tests/test_loss_parity.py``
    :175-206: an embedding, a capacity ``MoELayer`` of 8 experts, top-2,
    a linear head; the loss is the cross entropy plus the gate's aux loss)
    written against ``paddle``'s public API, built in either package.
    ``moe_kw`` overrides the ``MoELayer`` arguments."""
    nn, F = paddle.nn, paddle.nn.functional
    kw = dict(dict(d_model=32, d_hidden=64, num_experts=8, top_k=2), **moe_kw)
    moe = paddle.incubate.MoELayer(**kw)
    head = nn.Linear(32, MOE_VOCAB)
    emb = nn.Embedding(MOE_VOCAB, 32)

    class Wrap(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb, self.moe, self.head = emb, moe, head

        def forward(self, ids, labels=None):
            logits = self.head(self.moe(self.emb(ids)))
            ce = F.cross_entropy(paddle.reshape(logits, [-1, MOE_VOCAB]),
                                 paddle.reshape(labels, [-1]))
            return ce + self.moe.last_aux_loss

    return Wrap()


def moe_example_net(paddle):
    """``MoENet`` of ``examples/train_moe.py`` :30-41 against ``paddle``'s
    public API, and its loss (cross entropy plus the aux loss)."""
    nn, F = paddle.nn, paddle.nn.functional

    class MoENet(nn.Layer):
        def __init__(self, d_model=32, d_hidden=64, experts=8, classes=4):
            super().__init__()
            self.embed = nn.Linear(16, d_model)
            self.moe = paddle.incubate.MoELayer(
                d_model=d_model, d_hidden=d_hidden, num_experts=experts,
                top_k=2)
            self.head = nn.Linear(d_model, classes)

        def forward(self, x):
            h = F.relu(self.embed(x))
            return self.head(self.moe(h).mean(axis=1))

    def loss_fn(m, x, y):
        return F.cross_entropy(m(x), y) + m.moe.last_aux_loss

    return MoENet(), loss_fn


def _strategy(job):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=job.get("dp", -1),
                            mp_degree=job.get("mp", 1),
                            sharding_degree=job.get("sharding", 1),
                            sep_degree=job.get("sep", 1))
    s.sharding_configs["stage"] = job.get("stage", 1)
    meta_strategy(s, job)
    return s


LARS_LR = 1.0
LARS_CONFIGS = dict(lars_coeff=0.01, lars_weight_decay=5e-4)
LAMB_CONFIGS = dict(lamb_weight_decay=0.01)


def meta_strategy(s, job):
    """Set ``job``'s meta-optimizer (``"lamb"`` / ``"lars"``) and gradient
    wire on strategy ``s`` (either package's)."""
    if job.get("meta") == "lamb":
        s.lamb = True
        s.lamb_configs.update(LAMB_CONFIGS)
    elif job.get("meta") == "lars":
        s.lars = True
        s.lars_configs.update(LARS_CONFIGS)
    if job.get("wire"):
        s.grad_comm = True
        s.grad_comm_configs.update(wire_dtype=job["wire"])
    return s


def fleet_optimizer(job, params, opt_mod, clip_mod):
    """The optimizer a fleet job wraps (both packages): ``Momentum`` for a
    Lars job, else the fleet AdamW; the clip ``ClipGradByNorm`` for
    ``job["clip"] == "norm"``, else the global-norm clip."""
    clip = (clip_mod.ClipGradByNorm if job.get("clip") == "norm"
            else clip_mod.ClipGradByGlobalNorm)
    if job.get("meta") == "lars":
        return opt_mod.Momentum(learning_rate=LARS_LR, momentum=0.9,
                                parameters=params, grad_clip=clip(1.0))
    return fleet_adamw(params, opt_mod, clip,
                       job.get("multi_precision", False))


def sep_tiny_lm(paddle):
    """The reference's sep ``TinyLM`` (``tests/test_loss_parity.py``
    :122-166: embedding, fused QKV, causal attention through
    ``context_parallel_attention``, head, cross entropy) in either
    package."""
    attn = _cp_attention(paddle, "cp_attn_test")

    class TinyLM(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = paddle.nn.Embedding(64, 32)
            self.qkv = paddle.nn.Linear(32, 96)
            self.out = paddle.nn.Linear(32, 64)

        def forward(self, ids, labels=None):
            h = self.emb(ids)
            q, k, v = paddle.split(self.qkv(h), 3, axis=-1)

            def r(t):
                return t.reshape((t.shape[0], t.shape[1], 2, 16))
            a = attn(r(q), r(k), r(v))
            logits = self.out(a.reshape((h.shape[0], h.shape[1], 32)))
            return paddle.nn.functional.cross_entropy(
                logits.reshape((-1, 64)), labels.reshape((-1,)))

    return TinyLM()


LONG_CONTEXT = dict(vocab=128, hidden=64, heads=4)


def long_context_lm(paddle):
    """``LongContextLM`` of ``examples/train_long_context.py`` :48-71 (one
    ring-attention block and an LM head) in either package."""
    vocab, hid, heads = (LONG_CONTEXT[k] for k in ("vocab", "hidden",
                                                   "heads"))
    attn = _cp_attention(paddle, "ring_attn_example")
    nn = paddle.nn

    class LongContextLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(vocab, hid)
            self.qkv = nn.Linear(hid, 3 * hid)
            self.proj = nn.Linear(hid, hid)
            self.norm = nn.LayerNorm(hid)
            self.head = nn.Linear(hid, vocab)

        def forward(self, ids, labels=None):
            h = self.emb(ids)
            q, k, v = paddle.split(self.qkv(h), 3, axis=-1)

            def r(t):
                return t.reshape((t.shape[0], t.shape[1], heads,
                                  hid // heads))
            a = attn(r(q), r(k), r(v))
            h = self.norm(h + self.proj(
                a.reshape((h.shape[0], h.shape[1], hid))))
            return paddle.nn.functional.cross_entropy(
                self.head(h).reshape((-1, vocab)), labels.reshape((-1,)))

    return LongContextLM()


def _cp_attention(paddle, name):
    """Causal ``context_parallel_attention`` of ``paddle``'s package (the
    reference's wrapped as an op, as its callers do)."""
    if paddle.__name__ == "paddle_tpu":
        from paddle_tpu.framework.op import defop
        from paddle_tpu.nn.functional.ring_attention import (
            context_parallel_attention)

        return defop(name=name)(
            lambda q, k, v: context_parallel_attention(q, k, v, causal=True))
    from paddle_tpu_torch.nn.functional.ring_attention import (
        context_parallel_attention)

    return lambda q, k, v: context_parallel_attention(q, k, v, causal=True)


USER_LMS = {"sep_tiny_lm": sep_tiny_lm, "long_context_lm": long_context_lm}


def user_lm_job(job, state, batch):
    """A ``DistTrainStep`` trajectory of the user-written LM
    ``USER_LMS[job["model"]]`` on the full reference ``state``, one step
    per ``(ids, labels)`` of ``batch``. Returns the losses and the gathered
    full state."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.framework.io_state import (gather_full_state,
                                                     load_numpy_state)

    fleet.init(is_collective=True, strategy=_strategy(job))
    model = USER_LMS[job["model"]](paddle)
    load_numpy_state(model, state)
    opt = fleet_adamw(model.parameters(), topt, topt.ClipGradByGlobalNorm)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    step = fleet.DistTrainStep(model, lambda m, i, lab: m(i, labels=lab),
                               opt)
    collective.reset_counts()
    losses = [float(step(torch.from_numpy(i), torch.from_numpy(lab)))
              for i, lab in zip(batch["ids"], batch["labels"])]
    out = dict(losses=losses, counts=dict(collective.counts),
               full={k: v.float().numpy()
                     for k, v in gather_full_state(model).items()})
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def moe_job(job, state, batch):
    """A ``DistTrainStep`` trajectory of :func:`moe_net` (or, with
    ``job["net"] == "example"``, of :func:`moe_example_net`) in eval mode
    (the gate without noise) on the full reference ``state``, one step per
    entry of ``batch["x"]`` (labels ``batch["y"]``, else the ids). Returns
    the losses, the gathered full state, this rank's expert slices, its
    coordinates and the exchange's byte counts."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.framework.io_state import (gather_full_state,
                                                     load_numpy_state)

    fleet.init(is_collective=True, strategy=_strategy(job))
    if job.get("net") == "example":
        model, loss_fn = moe_example_net(paddle)
    else:
        model = moe_net(paddle, drop_tokens=job.get("drop_tokens", True))

        def loss_fn(m, ids, labels):
            return m(ids, labels=labels)
    model.eval()
    load_numpy_state(model, state)
    loaded = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    opt = fleet_optimizer(job, model.parameters(), topt, topt)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    step = fleet.DistTrainStep(model, loss_fn, opt)
    hcg = fleet.get_hybrid_communicate_group()
    grads = {}
    if job.get("grads"):
        # the first step's gradients as the optimizer gets them (after the
        # reduction; the expert slices gathered whole)
        from paddle_tpu_torch.distributed.fleet.layers.mpu import full_of
        from paddle_tpu_torch.incubate.moe import is_expert_slice

        inner = step._opt.step

        def capture():
            if not grads:
                for n, p in model.named_parameters():
                    g = p.grad.detach()
                    if is_expert_slice(p):
                        g = full_of(g, 0, hcg.get_expert_parallel_group())
                    grads[n] = g.numpy().copy()
            inner()

        step._opt.step = capture
    collective.reset_counts()
    xs = batch["x"]
    ys = batch.get("y", xs)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in zip(xs, ys)]
    counts = dict(collective.counts)
    local = {n: p.detach().numpy().copy()
             for n, p in model.named_parameters()}
    full = model.state_dict()
    # a full checkpoint written back leaves every rank's slice as it was
    missing, unexpected = model.set_state_dict(full)
    out = dict(
        losses=losses, loaded=loaded, local=local,
        full={k: v.float().numpy()
              for k, v in gather_full_state(model).items()},
        round_trip=(not missing and not unexpected and all(
            np.array_equal(p.detach().numpy(), local[n])
            for n, p in model.named_parameters())),
        data_rank=hcg.get_data_sharding_parallel_rank(),
        expert_rank=hcg.get_expert_parallel_rank(),
        expert_axis=hcg.get_expert_parallel_axis(),
        owned=sum(opt.owns(i) for i in range(
            len(opt._inner_opt._parameter_list))),
        counts=counts, grads=grads)
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def moe_eager_job(job, state, batch):
    """An eager step of :func:`moe_net` (eval mode, the full reference
    ``state``) after ``fleet.init`` at the job's degrees, outside
    ``DistTrainStep``: rank ``r`` of the data x sharding group runs the
    forward on its own rows ``r * b:(r + 1) * b`` of ``batch["x"][0]``,
    then the backward and ``fused_allreduce_gradients``. Returns the loss,
    the rows, the expert rank and every parameter's gradient (the expert
    leaves this rank's slices)."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util \
        import fused_allreduce_gradients
    from paddle_tpu_torch.framework.io_state import load_numpy_state

    fleet.init(is_collective=True, strategy=_strategy(job))
    hcg = fleet.get_hybrid_communicate_group()
    model = moe_net(paddle)
    model.eval()
    load_numpy_state(model, state)
    ids = batch["x"][0]
    r = hcg.get_data_sharding_parallel_rank()
    b = ids.shape[0] // hcg.get_data_sharding_parallel_world_size()
    mine = torch.from_numpy(ids[r * b:(r + 1) * b])
    loss = model(mine, labels=mine)
    loss.backward()
    fused_allreduce_gradients(list(model.parameters()), hcg)
    out = dict(loss=float(loss), rows=(r * b, (r + 1) * b),
               expert_rank=hcg.get_expert_parallel_rank(),
               grads={n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()})
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def exchange_job(job, state, batch):
    """``global_scatter`` / ``global_gather`` over the expert group of
    ``fleet.init`` at the job's degrees: the dense form on this rank's
    ``batch["dense"][rank]`` (``[E, rows, h]``) and upstream's counted form
    on its rows of ``batch["rows"][rank]`` with ``batch["counts"][rank]``
    (rows for each global expert). Returns both forms' outputs, the
    round trips, the input gradients of ``sum(gather(scatter(x)) * x)``
    and the byte counts."""
    import torch

    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.incubate import global_gather, global_scatter

    fleet.init(is_collective=True, strategy=_strategy(job))
    hcg = fleet.get_hybrid_communicate_group()
    group = hcg.get_expert_parallel_group()
    r, n = group.rank, group.nranks
    out = dict(expert_rank=r, members=list(group.ranks))
    collective.reset_counts()
    x = torch.from_numpy(batch["dense"][r]).requires_grad_()
    y = global_scatter(x)
    back = global_gather(y)
    (g,) = torch.autograd.grad((back * x.detach()).sum(), x)
    out["dense"] = dict(out=y.detach().numpy(), back=back.detach().numpy(),
                        grad=g.numpy())
    out["dense_counts"] = dict(collective.counts)
    counts = batch["counts"]                       # [n, n * E_local]
    el = counts.shape[1] // n
    local = torch.as_tensor(counts[r])
    glob = torch.as_tensor(np.concatenate(
        [counts[j, r * el:(r + 1) * el] for j in range(n)]))
    x = torch.from_numpy(batch["rows"][r]).requires_grad_()
    y = global_scatter(x, local, glob)
    back = global_gather(y, local, glob)
    (g,) = torch.autograd.grad((back * x.detach()).sum(), x)
    out["counted"] = dict(out=y.detach().numpy(),
                          back=back.detach().numpy(), grad=g.numpy())
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def ring_job(job, state, batch):
    """This rank's block of the ring attention over the sep group of
    ``fleet.init(sep_degree=job["sep"])`` (dp filling the world) on the
    global ``batch`` q / k / v / dout ``[B, T, H, D]`` (k / v may carry
    fewer heads): the output and the gradients of q, k, v on the plain
    ring and on the kernels' route (their plain versions here), and the
    Ulysses pair on ``batch["x"]`` ``[b, s, h, d]``: this rank's
    ``sep_reshard_to_heads`` output, the round trip back, and the input
    gradient of ``sum(heads * c)``."""
    import torch

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.utils import (
        sequence_parallel_utils as spu)
    from paddle_tpu_torch.nn.functional import ring_attention as ra

    fleet.init(is_collective=True, strategy=_strategy(job))
    hcg = fleet.get_hybrid_communicate_group()
    group = hcg.get_sep_parallel_group()
    n, r = group.nranks, group.rank

    def block(a, axis=1):
        k = a.shape[axis] // n
        return torch.from_numpy(np.ascontiguousarray(
            np.take(a, range(r * k, (r + 1) * k), axis=axis)))

    out = dict(sep_rank=r)
    q, k, v, do = (block(batch[x]) for x in ("q", "k", "v", "do"))
    for route, fn in (("plain", ra.ring_flash_attention_plain),
                      ("kernels", ra.ring_flash_attention)):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fn(qq, kk, vv, group, causal=job["causal"])
        o.backward(do)
        out[route] = dict(o=o.detach().numpy(), dq=qq.grad.numpy(),
                          dk=kk.grad.numpy(), dv=vv.grad.numpy())
    if "x" in batch:
        x = block(batch["x"]).requires_grad_()
        heads = spu.sep_reshard_to_heads(x, 2)
        back = spu.sep_reshard_to_sequence(heads, 1)
        c = block(batch["c"], axis=2)
        (g,) = torch.autograd.grad((heads * c).sum(), x)
        out.update(heads=heads.detach().numpy(), back=back.detach().numpy(),
                   x_grad=g.numpy())
    fleet.topology.set_hybrid_communicate_group(None)
    return out


# -- batch-coupled reductions under a split batch (ROADMAP.md §C.26) -------
BATCHED_NET = dict(inp=8, hidden=16, classes=8, batch=16)


def batched_net(paddle, bn):
    """``Linear -> BatchNorm1D -> Linear`` (``bn``) or ``Linear -> tanh ->
    Linear``, built in either package (``paddle`` the package's root).
    The linear before the batch norm has no bias: its gradient would be 0
    up to float noise (the norm takes the mean out), which Adam's
    normalised step turns into moves of up to lr either way."""
    nn = paddle.nn
    d = BATCHED_NET

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(d["inp"], d["hidden"],
                                bias_attr=False if bn else None)
            self.bn = nn.BatchNorm1D(d["hidden"]) if bn else None
            self.l2 = nn.Linear(d["hidden"], d["classes"])

        def forward(self, x):
            h = self.l1(x)
            h = self.bn(h) if self.bn is not None else paddle.tanh(h)
            return self.l2(h)

    return Net()


def batched_loss(F, case):
    """The loss of each §C.26 case: an ``ignore_index`` mean, a class
    weight (a ``[C]`` batch argument), a sum, and a plain mean through the
    batch norm."""
    if case == "weight":
        return lambda m, x, y, w: F.cross_entropy(m(x), y, weight=w)
    if case == "sum":
        return lambda m, x, y: F.cross_entropy(m(x), y, reduction="sum")
    return lambda m, x, y: F.cross_entropy(m(x), y)


def batched_inputs():
    """Per case, the global batch: ``x [16, 8]``, labels ``y [16]`` (the
    ignore case drops 7 of the first 8 rows and 1 of the last 8, so every
    data rank keeps another count) and the weight case's ``w [8]``."""
    d = BATCHED_NET
    rng = np.random.default_rng(26)
    x = rng.standard_normal((d["batch"], d["inp"])).astype(np.float32)
    y = rng.integers(0, d["classes"], d["batch"]).astype(np.int64)
    ign = y.copy()
    ign[[0, 1, 2, 3, 4, 5, 6, 12]] = -100
    w = rng.uniform(0.5, 2.0, d["classes"]).astype(np.float32)
    return {"ignore": dict(x=x, y=ign), "weight": dict(x=x, y=y, w=w),
            "sum": dict(x=x, y=y), "bn": dict(x=x, y=y)}


def batched_job(job, state, batch):
    """A ``DistTrainStep`` trajectory of :func:`batched_net` on the global
    batch: the losses, the parameters and every buffer after 3 steps."""
    import torch

    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io_state import load_numpy_state

    fleet.init(is_collective=True, strategy=_strategy(job))
    net = load_numpy_state(batched_net(tpaddle, job["case"] == "bn"), state)
    opt = fleet_adamw(net.parameters(), topt, topt.ClipGradByGlobalNorm)
    net = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(opt)
    step = fleet.DistTrainStep(net, batched_loss(tpaddle.nn.functional,
                                                 job["case"]), opt)
    args = [torch.from_numpy(batch[k]) for k in ("x", "y", "w")
            if k in batch]
    losses = [float(step(*args)) for _ in range(3)]
    out = dict(losses=losses,
               full={n: p.detach().numpy()
                     for n, p in net.named_parameters()},
               buffers={n: b.detach().numpy()
                        for n, b in net.named_buffers()})
    fleet.topology.set_hybrid_communicate_group(None)
    return out


# -- ZeRO-3 (the reference's loss-parity TinyLM and its reshard test) -------
TINY_LM = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=64,
               max_position_embeddings=16, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
TINY_LM_STEPS = 10


def tiny_lm_data():
    """The ``[8, 16]`` id batches of ``tests/test_loss_parity.py::_data``."""
    rng = np.random.default_rng(42)
    return [rng.integers(0, TINY_LM["vocab_size"], (8, 16)).astype(np.int32)
            for _ in range(TINY_LM_STEPS)]


def _strategy_of(degrees, stage):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dict(dict(dp_degree=-1), **degrees))
    s.sharding_configs["stage"] = stage
    return s


def tiny_lm_job(job, state, data):
    """The TinyLM trained by ``DistTrainStep`` (AdamW, lr 1e-3) through
    ``job["phases"]``: ``(degrees, stage, steps)`` each; a later phase
    builds the model anew under its degrees from the full model and
    optimizer state the one before gathered (a resume under other
    parallel degrees; a pipelined decoder's stacked entries under the
    unfolded names). Returns the losses, the full parameters and, of
    the first phase, the bytes of the parameters this rank holds and of
    those ZeRO-3 left whole."""
    import torch

    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding_stage3 \
        import is_zero3_slice
    from paddle_tpu_torch.framework import io_state
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    losses, opt_state, out, done = [], None, {}, 0
    for degrees, stage, steps in job["phases"]:
        fleet.init(is_collective=True, strategy=_strategy_of(degrees, stage))
        model = GPTForCausalLM(GPTConfig(
            sequence_parallel=job.get("sp", False), **TINY_LM),
            device="cpu")
        io_state.load_numpy_state(model, to_stacked(model, state))
        opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters())
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
        if opt_state is not None:
            io_state.load_full_optimizer_state(opt, opt_state)
        step = fleet.DistTrainStep(
            model, lambda m, ids, lbl: m(ids, labels=lbl), opt)
        if not out:
            held = [p for p in model.parameters()]
            out["resident_bytes"] = sum(p.numel() * p.element_size()
                                        for p in held)
            out["whole_bytes"] = sum(p.numel() * p.element_size()
                                     for p in held if not is_zero3_slice(p))
            out["sliced"] = sum(is_zero3_slice(p) for p in held)
        for ids in data[done:done + steps]:
            t = torch.from_numpy(ids)
            losses.append(float(step(t, t)))
        done += steps
        full = io_state.gather_full_state(model)
        state = from_stacked(model, {k: v.numpy() for k, v in full.items()})
        opt_state = io_state.gather_full_optimizer_state(opt)
        fleet.topology.set_hybrid_communicate_group(None)
    out.update(losses=losses, full=state)
    return out


def zero3_eager_job(job, state, batch):
    """ZeRO-3 in an eager loop at sharding = world size, through
    ``group_sharded_parallel(level="p_g_os")`` or ``GroupShardedStage3``
    (``job["api"]``): each rank's rows, backward, then
    ``fused_allreduce_gradients``; the wrapper's full ``state_dict`` and
    ``save_group_sharded_model`` after."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel
    from paddle_tpu_torch.distributed.fleet.utils import hybrid_parallel_util
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    from paddle_tpu_torch.framework.io_state import gather_full_state

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=1, sharding_degree=dist.get_world_size())
    fleet.init(is_collective=True, strategy=s)
    model = port_model(job["model"], state)
    opt = fleet_adamw(model.parameters(), topt, topt.ClipGradByGlobalNorm)
    if job["api"] == "group_sharded_parallel":
        model, opt, _ = group_sharded_parallel(model, opt, "p_g_os")
        wrapper_state = None
    else:
        wrapper = meta_parallel.GroupShardedStage3(model, opt)
        model, opt = wrapper, wrapper._optim
    hcg = fleet.get_hybrid_communicate_group()
    k = batch["ids"].shape[0] // hcg.get_data_sharding_parallel_world_size()
    r = hcg.get_data_sharding_parallel_rank()
    params = list(model.parameters())
    losses = _eager_steps(
        model, opt, batch, slice(r * k, (r + 1) * k),
        lambda: hybrid_parallel_util.fused_allreduce_gradients(params))
    if job["api"] != "group_sharded_parallel":
        wrapper_state = {n: v.numpy()
                         for n, v in model.state_dict().items()}
    out = dict(losses=losses,
               full={n: v.numpy()
                     for n, v in gather_full_state(model).items()},
               wrapper_state=wrapper_state,
               local_shapes={n: tuple(p.shape)
                             for n, p in model.named_parameters()})
    save_group_sharded_model(model, os.path.join(job["save_dir"],
                                                 job["name"]), opt)
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def zero3_slices_job(job, state, batch):
    """This rank's slice of every parameter of the model at ZeRO-3 over
    ``job["sharding"]`` ranks, before any step."""
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True, strategy=_strategy(job))
    model = fleet.distributed_model(port_model(job["model"], state))
    out = {n: p.detach().numpy() for n, p in model.named_parameters()}
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def merge_job(job, state, batch):
    """Gradient merge (``job["k_steps"]``) under ``DistTrainStep``: two
    cycles over the halves of the batch; the losses, whether any
    parameter moved at each call, and the full parameters."""
    import torch

    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io_state import gather_full_state

    s = _strategy(job)
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": job["k_steps"], "avg": True}
    fleet.init(is_collective=True, strategy=s)
    model = port_model(job["model"], state)
    opt = fleet_adamw(model.parameters(), topt, topt.ClipGradByGlobalNorm)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    step = fleet.DistTrainStep(model, lambda m, i, lab: m(i, labels=lab), opt)
    losses, moved = [], []
    half = batch["ids"].shape[0] // 2
    for _ in range(2):
        for rows in (slice(0, half), slice(half, None)):
            before = [p.detach().clone() for p in model.parameters()]
            losses.append(float(step(torch.from_numpy(batch["ids"][rows]),
                                     torch.from_numpy(
                                         batch["labels"][rows]))))
            moved.append(any(not torch.equal(a, p.detach()) for a, p in
                             zip(before, model.parameters())))
    out = dict(losses=losses, moved=moved,
               full={k: v.numpy() for k, v in
                     gather_full_state(model).items()})
    fleet.topology.set_hybrid_communicate_group(None)
    return out


# -- the quantized gradient wire (tests/test_grad_comm.py's _Net) -----------
WIRE_VOCAB = 32


def wire_net(paddle):
    """``tests/test_grad_comm.py::_Net`` in either package."""
    nn = paddle.nn
    F = paddle.nn.functional

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(WIRE_VOCAB, 16)
            self.l1 = nn.Linear(16, 24)
            self.l2 = nn.Linear(24, 16)
            self.norm = nn.LayerNorm(16)
            self.head = nn.Linear(16, WIRE_VOCAB)

        def forward(self, ids):
            h = self.emb(ids)
            h = F.gelu(self.l1(h))
            h = self.norm(self.l2(h))
            return self.head(h)

    return Net()


def wire_loss(F):
    def loss_fn(m, ids, lbl):
        return F.cross_entropy(m(ids).reshape([-1, WIRE_VOCAB]),
                               lbl.reshape([-1]))
    return loss_fn


def wire_ids():
    rng = np.random.RandomState(0)
    return rng.randint(0, WIRE_VOCAB, (16, 4)).astype(np.int32)


def wire_strategy(job, pkg_fleet):
    """The job's degrees and gradient wire in either package's strategy."""
    s = pkg_fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=job.get("dp", 1),
                            mp_degree=job.get("mp", 1),
                            sharding_degree=job.get("sharding", 1))
    s.sharding_configs["stage"] = job.get("stage", 1)
    if job.get("wire"):
        s.grad_comm = True
        s.grad_comm_configs.update(wire_dtype=job["wire"],
                                   error_feedback=job.get("ef", False))
    return s


def wire_job(job, state, batch):
    """``_Net`` trained 3 steps under the job's gradient wire, through
    ``DistTrainStep`` or (``job["eager"]``) an eager loop with
    ``fused_allreduce_gradients``: losses, counts, full parameters, the
    exchange's byte arithmetic and the warnings raised."""
    import warnings

    import torch

    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.fleet.utils import hybrid_parallel_util
    from paddle_tpu_torch.framework.io_state import (gather_full_state,
                                                     load_numpy_state)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fleet.init(is_collective=True, strategy=wire_strategy(job, fleet))
        net = load_numpy_state(wire_net(tpaddle), state)
        opt = topt.AdamW(learning_rate=1e-2, parameters=net.parameters())
        net = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(opt)
        ids = torch.from_numpy(batch)
        loss_fn = wire_loss(tpaddle.nn.functional)
        collective.reset_counts()
        losses = []
        if job.get("eager"):
            hcg = fleet.get_hybrid_communicate_group()
            k = ids.shape[0] // hcg.get_data_sharding_parallel_world_size()
            r = hcg.get_data_sharding_parallel_rank()
            mine = ids[r * k:(r + 1) * k]
            params = [p for p in net.parameters()]
            for _ in range(3):
                loss = loss_fn(net, mine, mine)
                loss.backward()
                hybrid_parallel_util.fused_allreduce_gradients(params)
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
        else:
            step = fleet.DistTrainStep(net, loss_fn, opt)
            losses = [float(step(ids, ids)) for _ in range(3)]
    wire = opt._grad_wire()
    sd = opt.state_dict()
    out = dict(
        losses=losses, counts=dict(collective.counts),
        full={k: v.numpy() for k, v in gather_full_state(net).items()},
        wire=None if wire is None else dict(
            bytes_wire=wire.bytes_wire, bytes_f32=wire.bytes_f32,
            buckets=len(wire.zero_layouts) + len(wire.tail_layouts),
            zero_buckets=len(wire.zero_layouts), n_elems=wire.n_elems),
        residuals={k: tuple(v.shape) for k, v in sd.items()
                   if k.startswith("grad_comm.")},
        warnings=[str(w.message) for w in caught
                  if "grad_comm" in str(w.message)],
        n_params=sum(p.numel() for p in net.parameters()))
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def quantized_collective_job(job, state, batch):
    """``psum_quantized`` (bf16, int8; the value and its gradient) and
    ``all_gather_quantized`` (int8 with segments, bf16) of this rank's
    row of ``batch``."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C

    r = dist.get_rank()
    out = {}
    for wire in ("bf16", "int8"):
        v = torch.from_numpy(batch["psum"][r]).requires_grad_()
        s = C.psum_quantized(v, wire_dtype=wire)
        s.sum().backward()
        out[f"psum_{wire}"] = (s.detach().numpy(), v.grad.numpy())
        g = torch.from_numpy(batch["gather"][r]).requires_grad_()
        a = C.all_gather_quantized(g, wire_dtype=wire, segments=(5, 3),
                                   grad_wire="int8")
        a.sum().backward()
        out[f"gather_{wire}"] = (a.detach().numpy(), g.grad.numpy())
    try:
        C.all_gather_quantized(torch.zeros(8), wire_dtype="int8",
                               segments=(8, 1))
    except ValueError as e:
        out["bad_segments"] = str(e)
    return out


# -- the quantized mp wire (tests/test_mp_comm.py) ---------------------------
MP_WIRE_GPT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, max_position_embeddings=64,
                   hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def mp_wire_inputs():
    """The arrays of ``tests/test_mp_comm.py``'s function cases."""
    r0, r1, r2, r6 = (np.random.RandomState(i) for i in (0, 1, 2, 6))
    logits = r6.randn(4, 12).astype(np.float32)
    logits[1] = 0.0
    logits[1, 2] = logits[1, 9] = 7.5   # a tie across blocks
    return dict(
        row_x=r0.randn(4, 6, 8).astype(np.float32),
        row_w=r0.randn(8, 12).astype(np.float32),
        col_x=r1.randn(4, 6, 8).astype(np.float32),
        col_w=r1.randn(8, 12).astype(np.float32),
        emb_w=r2.randn(8, 6).astype(np.float32),
        emb_ids=r2.randint(0, 8, (3, 4)).astype(np.int64),
        logits=logits)


def mp_wire_fns_job(job, state, inp):
    """Each wire function on this rank's shards of ``mp_wire_inputs`` over
    an mp group of ``job["mp"]`` ranks (the world split into such groups):
    values and gradients, for the bf16 and int8 wires."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import mp_comm
    from paddle_tpu_torch.distributed.fleet.layers.mpu import shard_of

    g = job["mp"]
    rank, world = dist.get_rank(), dist.get_world_size()
    groups = [dist.new_group(list(range(i, i + g)))
              for i in range(0, world, g)]
    group = groups[rank // g]
    j = rank % g
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    for wire in ("bf16", "int8"):
        x = shard_of(t["row_x"], 2, j, g).clone().requires_grad_()
        w = shard_of(t["row_w"], 0, j, g).clone().requires_grad_()
        y = mp_comm.row_parallel_matmul(x, w, wire, group)
        torch.sin(y).sum().backward()
        out[f"row_{wire}"] = (y.detach().numpy(), x.grad.numpy(),
                              w.grad.numpy())
        x = t["col_x"].clone().requires_grad_()
        w = shard_of(t["col_w"], 1, j, g).clone().requires_grad_()
        y = mp_comm.column_parallel_linear(x, w, wire, group)
        torch.sin(y).sum().backward()
        out[f"col_{wire}"] = (y.detach().numpy(), x.grad.numpy(),
                              w.grad.numpy())
        w = shard_of(t["emb_w"], 0, j, g).clone().requires_grad_()
        e = mp_comm.vocab_parallel_embedding(w, t["emb_ids"], j * w.shape[0],
                                             wire, group)
        (e ** 2).sum().backward()
        out[f"emb_{wire}"] = (e.detach().numpy(), w.grad.numpy())
        z = torch.from_numpy(np.full((5, 7), j + 1.0, np.float32)
                             ).requires_grad_()
        mp_comm._WireSum.apply(z, wire, group).sum().backward()
        out[f"sum_grad_{wire}"] = z.grad.numpy()
        wl, exact = mp_comm.quantized_logit_gather(
            shard_of(t["logits"], 1, j, g), wire, group)
        out[f"logits_{wire}"] = (wl.numpy(), exact.numpy())
    out["logits_f32"] = mp_comm.quantized_logit_gather(
        shard_of(t["logits"], 1, j, g), "f32", group)
    return out


def mp_wire_gpt_job(job, state, ids):
    """The reference test's dp 2 x mp 2 GPT, 3 AdamW steps (lr 3e-4) with
    ``job["mode"]`` in ``PADDLE_TPU_MP_COMM``: losses and the mp wire's
    counted bytes."""
    import torch

    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.framework.io_state import load_numpy_state
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    os.environ["PADDLE_TPU_MP_COMM"] = job["mode"]
    try:
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=2, mp_degree=2)
        fleet.init(is_collective=True, strategy=s)
        m = load_numpy_state(GPTForCausalLM(GPTConfig(**MP_WIRE_GPT),
                                            device="cpu"), state)
        opt = topt.AdamW(learning_rate=3e-4, parameters=m.parameters())
        m = fleet.distributed_model(m)
        opt = fleet.distributed_optimizer(opt)
        step = fleet.DistTrainStep(m, lambda mm, i, lbl: mm(i, labels=lbl),
                                   opt)
        t = torch.from_numpy(ids)
        collective.reset_counts()
        losses = [float(step(t, t)) for _ in range(3)]
        out = dict(losses=losses, counts=dict(collective.counts))
    finally:
        del os.environ["PADDLE_TPU_MP_COMM"]
        fleet.topology.set_hybrid_communicate_group(None)
    return out


def wire_lamb_job(job, state, batch):
    """``_Net`` under fleet's Lamb swap and the job's gradient wire, 3
    ``DistTrainStep`` s: losses and full parameters."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io_state import (gather_full_state,
                                                     load_numpy_state)

    s = meta_strategy(wire_strategy(job, fleet), job)
    fleet.init(is_collective=True, strategy=s)
    model = wire_net(paddle)
    load_numpy_state(model, state)
    opt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=list(
        model.parameters()), weight_decay=0.1)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    step = fleet.DistTrainStep(model, wire_loss(paddle.nn.functional), opt)
    ids = torch.from_numpy(batch.astype(np.int64))
    losses = [float(step(ids, ids)) for _ in range(3)]
    out = dict(losses=losses, inner=type(opt._inner_opt).__name__,
               full={k: v.float().numpy()
                     for k, v in gather_full_state(model).items()})
    fleet.topology.set_hybrid_communicate_group(None)
    return out


def zero3_hooks_job(job, state, batch):
    """The tiny GPT at ZeRO-3 (``job``'s degrees) for ``steps`` steps of
    ``DistTrainStep``, its loss run inside a user's
    ``autograd.saved_tensors_hooks`` (``job["hooks"]``) or not: the
    losses, how many tensors the user's hooks packed and unpacked, the
    gathered weights alive at the end of each forward (``_watch_gathered``,
    which patches this process: run this job last) and the backward's
    re-gathers."""
    import torch

    from paddle_tpu_torch import autograd
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import collective, fleet

    fleet.init(is_collective=True, strategy=_strategy(job))
    model = port_model(job["model"], state)
    opt = fleet_adamw(model.parameters(), topt, topt.ClipGradByGlobalNorm)
    alive = _watch_gathered() if job.get("watch") else None
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    counts = dict(pack=0, unpack=0)

    def pack(t):
        counts["pack"] += 1
        return t

    def unpack(t):
        counts["unpack"] += 1
        return t

    def loss_fn(m, i, lab):
        if not job.get("hooks"):
            return m(i, labels=lab)
        with autograd.saved_tensors_hooks(pack, unpack):
            return m(i, labels=lab)

    step = fleet.DistTrainStep(model, loss_fn, opt)
    args = [torch.from_numpy(batch[k]) for k in ("ids", "labels")]
    collective.reset_counts()
    losses = [float(step(*args)) for _ in range(job.get("steps", 2))]
    out = dict(losses=losses, counts=counts,
               alive=alive() if alive else None,
               regather=collective.counts["zero3_regather"])
    fleet.topology.set_hybrid_communicate_group(None)
    return out


# -- auto-parallel: placements, parallelize, to_distributed, Engine ----------
AP_GPT_PLAN = {"gpt.decoder.*.attn.qkv_proj": "col",
               "gpt.decoder.*.attn.out_proj": "row",
               "gpt.decoder.*.mlp.fc_in": "col",
               "gpt.decoder.*.mlp.fc_out": "row"}
AP_LR = 0.1


def ap_mlp(paddle):
    """The MLP of ``tests/test_parallelize.py`` (either package)."""
    nn = paddle.nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.up = nn.Linear(16, 32)
            self.act = nn.ReLU()
            self.down = nn.Linear(32, 16)

        def forward(self, x):
            return self.down(self.act(self.up(x)))

    return MLP()


def ap_embed_net(paddle):
    """An embedding under a linear head (either package): the plans'
    Embedding cases."""
    nn = paddle.nn
    return nn.Sequential(nn.Embedding(32, 16), nn.Linear(16, 8))


AP_NETS = {"mlp": ap_mlp, "embed": ap_embed_net}


def ap_engine_net(paddle):
    """The net of ``tests/test_auto_parallel_engine.py`` (either
    package)."""
    nn = paddle.nn
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 1))


def ap_plan(dist, spec):
    """``{pattern: plan or [plans]}`` of ``dist``'s plan classes from
    ``{pattern: "col" | "col_gather" | "row" | "sp_begin" | "sp_end" or a
    list}``."""
    make = {"col": dist.ColWiseParallel, "row": dist.RowWiseParallel,
            "col_gather": lambda: dist.ColWiseParallel(gather_output=True),
            "sp_begin": dist.SequenceParallelBegin,
            "sp_end": dist.SequenceParallelEnd}
    return {k: [make[x]() for x in (v if isinstance(v, list) else [v])]
            for k, v in spec.items()}


def _port_net(make, state):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework.io_state import set_state_dict

    m = make(paddle)
    set_state_dict(m, state)
    return m


def _mesh_2x2(dist, names):
    return dist.ProcessMesh(np.arange(4).reshape(2, 2), dim_names=list(names))


def _reset_topology():
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn.functional import loss

    fleet.topology.set_hybrid_communicate_group(None)
    loss._split_group = None


def _raised(fn):
    """The name of the exception ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # the test asserts the type
        return type(e).__name__
    return None


def ap_placements_job(job, state, batch):
    """``shard_tensor`` / ``reshard`` / ``dtensor_from_fn`` on a 2 x 2 mesh
    (the global values, the local blocks), the reference rules (an
    indivisible dim, ``Partial``), the refusals, ``sharding_constraint``,
    ``shard_dataloader`` of a dict batch and the global mesh of
    ``fleet.init``."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    mesh = dist.ProcessMesh(shape=[2, 2], dim_names=["x", "y"])
    x = batch["x"]
    t = dist.shard_tensor(x, mesh, [dist.Shard(0), dist.Replicate()])
    t2 = dist.reshard(t, mesh, [dist.Replicate(), dist.Shard(1)])
    t3 = dist.reshard(t2, mesh, [dist.Shard(1), dist.Shard(0)])
    odd = dist.shard_tensor(batch["odd"], mesh,
                            [dist.Shard(0), dist.Replicate()])
    part = dist.shard_tensor(x, mesh, [dist.Partial(), dist.Replicate()])
    back = dist.reshard(part, mesh, [dist.Shard(0), dist.Replicate()])
    fn = dist.dtensor_from_fn(np.ones, mesh, [dist.Shard(0),
                                              dist.Replicate()],
                              (4, 2), np.float32)
    con = dist.sharding_constraint(t, (None, "y"), mesh)
    plain = torch.ones(3)
    w = paddle.nn.Linear(4, 4).weight
    loader = dist.shard_dataloader([{"a": x, "b": x}], mesh, "x",
                                   input_keys=["a"])
    (item,) = list(loader)
    visited = []
    lay = paddle.nn.Linear(4, 3)
    dist.shard_layer(lay, mesh, lambda n, sub, m: visited.append(n))
    rows = lay(dist.shard_tensor(x, mesh, [dist.Shard(0), dist.Replicate()]))

    def split_weight(name, sub, m):
        if isinstance(sub, paddle.nn.Linear):
            sub.weight = dist.shard_tensor(sub.weight, m, [dist.Shard(0),
                                                           dist.Replicate()])

    out = dict(
        shard_layer=(visited, tuple(rows.shape), type(rows).__name__,
                     _raised(lambda: dist.shard_layer(
                         paddle.nn.Linear(4, 4), mesh, split_weight))),
        t=t.numpy(), t_local=t.to_local().numpy().copy(),
        t2=t2.numpy(), t2_local=t2.to_local().numpy().copy(),
        t3=t3.numpy(), t3_local=t3.to_local().numpy().copy(),
        odd=odd.numpy(), odd_local=tuple(odd.to_local().shape),
        odd_placements=repr(list(odd.placements)),
        partial=part.numpy(), partial_back=back.numpy(),
        partial_local=part.to_local().numpy().copy(),
        fn=fn.numpy(), con=con.numpy(),
        con_placements=repr(list(con.placements)),
        plain_same=dist.sharding_constraint(plain, ("y",)) is plain,
        eq=[t.placements[0] == dist.Shard(0),
            t.placements[1] == dist.Replicate(),
            dist.Shard(0) == dist.Shard(1), repr(dist.Shard(1)),
            repr(dist.Partial())],
        loader=(tuple(item["a"].to_local().shape),
                tuple(item["b"].to_local().shape)),
        to_partial=_raised(lambda: dist.reshard(
            t, mesh, [dist.Partial(), dist.Replicate()])),
        param_shard=_raised(lambda: dist.shard_tensor(
            w, mesh, [dist.Shard(0), dist.Replicate()])),
        param_replicate=tuple(dist.shard_tensor(
            w, mesh, [dist.Replicate(), dist.Replicate()]).shape))
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=2, mp_degree=2)
    fleet.init(is_collective=True, strategy=s)
    gm = dist.get_mesh()
    out["fleet_mesh"] = (list(gm.dim_names), list(gm.shape))
    dp = gm.dim_names.index("dp")
    pl = [dist.Replicate()] * gm.ndim
    pl[dp] = dist.Shard(0)
    xs = dist.shard_tensor(x, gm, pl)
    out["fleet_shard"] = (xs.numpy(), tuple(xs.to_local().shape),
                          dist.reshard(xs, gm, [dist.Replicate()] * gm.ndim
                                       ).numpy())
    _reset_topology()
    return out


def ap_mlp_job(job, state, batch):
    """The MLP (or ``AP_NETS[job["net"]]``) through ``parallelize`` on a
    2 x 2 mesh (``job["axes"]``) with ``job["plan"]`` and / or
    ``job["level"]`` (sharding level), then a plain ``TrainStep`` (SGD,
    ``job["steps"]`` steps): the losses, the full parameters and each
    split parameter's ``split_axis``."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.fleet.layers.mpu import is_mp_shard
    from paddle_tpu_torch.framework.io_state import gather_full_state
    from paddle_tpu_torch.jit import TrainStep

    m = _port_net(AP_NETS[job.get("net", "mlp")], state)
    opt = paddle.optimizer.SGD(learning_rate=AP_LR,
                               parameters=m.parameters())
    config = {}
    if job.get("plan"):
        config["mp_config"] = {"parallelize_plan": ap_plan(dist,
                                                           job["plan"])}
    if job.get("level"):
        config["dp_config"] = {"sharding_level": job["level"]}
    m, opt = dist.parallelize(m, opt, _mesh_2x2(dist, job["axes"]), config)
    step = TrainStep(m, lambda mm, x, y: paddle.mean((mm(x) - y) ** 2), opt)
    x, y = torch.from_numpy(batch["x"]), torch.from_numpy(batch["y"])
    losses = [float(step(x, y)) for _ in range(job["steps"])]
    out = dict(losses=losses,
               full={k: v.numpy() for k, v in gather_full_state(m).items()},
               split={n: p.split_axis for n, p in m.named_parameters()
                      if is_mp_shard(p)},
               local={n: tuple(p.shape) for n, p in m.named_parameters()})
    _reset_topology()
    return out


def ap_gpt_job(job, state, batch):
    """The tiny GPT through ``parallelize`` at dp 2 x mp 2 (ColWise
    ``qkv_proj`` / ``fc_in``, RowWise ``out_proj`` / ``fc_out``), AdamW
    with the global-norm clip under a plain ``TrainStep``: losses, full
    parameters, each split parameter's ``split_axis``, the local head
    count; then the refusals (a plan that cuts a head, an unmatched
    pattern, ``pp_config``, a mesh without the axis a config needs)."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed.fleet.layers.mpu import is_mp_shard
    from paddle_tpu_torch.framework.io_state import gather_full_state
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    mesh = _mesh_2x2(dist, ("dp", "mp"))
    model = port_model("gpt", state)
    opt = fleet_adamw(model.parameters(), topt, topt.ClipGradByGlobalNorm)
    model, opt = dist.parallelize(model, opt, mesh, {"mp_config": {
        "parallelize_plan": ap_plan(dist, AP_GPT_PLAN)}})
    step = TrainStep(model, lambda m, i, lab: m(i, labels=lab), opt)
    args = [torch.from_numpy(batch[k]) for k in ("ids", "labels")]
    losses = [float(step(*args)) for _ in range(job.get("steps", 3))]
    out = dict(
        losses=losses,
        full={k: v.numpy() for k, v in gather_full_state(model).items()},
        split={n: p.split_axis for n, p in model.named_parameters()
               if is_mp_shard(p)},
        heads=model.gpt.decoder[0].attn.num_heads)
    plan = {"mp_config": {"parallelize_plan": ap_plan(dist, AP_GPT_PLAN)}}

    def fresh(config, mesh=mesh, **kw):
        # built with no topology in force: whole, as the reference's
        _reset_topology()
        if kw:
            m = GPTForCausalLM(GPTConfig(**tiny_gpt_kwargs(
                vocab_size=64, **kw)), device="cpu")
        else:
            m = port_model("gpt", state)
        return lambda: dist.parallelize(m, None, mesh, config)

    out["errors"] = dict(
        cut_head=_raised(fresh(plan, hidden_size=24,
                               num_attention_heads=3)),
        no_match=_raised(fresh({"mp_config": {"parallelize_plan": {
            "nope": dist.ColWiseParallel()}}})),
        pp=_raised(fresh({"pp_config": {"split_spec": "x"}})),
        no_mp=_raised(fresh(plan, _mesh_2x2(dist, ("dp", "sharding")))),
        no_sharding=_raised(fresh({"dp_config": {"sharding_level": 2}})),
        split_output=_raised(lambda: _split_output_model(dist, mesh)))
    _reset_topology()
    return out


def _split_output_model(dist, mesh):
    """A model ending in a ColWise layer that keeps its output split."""
    import torch

    import paddle_tpu_torch as paddle

    _reset_topology()
    m = paddle.nn.Sequential(paddle.nn.Linear(4, 8))
    dist.parallelize(m, None, mesh, {"mp_config": {"parallelize_plan": {
        "0": dist.ColWiseParallel()}}})
    return m(torch.ones(2, 4))


def ap_to_dist_job(job, state, batch):
    """The MLP through ``to_distributed`` at dp = the world with a loader of
    ``job["steps"]`` global batches: each rank's losses, its rows, its
    parameters after the steps; and a control whose optimizer skips the
    data-axis mean (the inner optimizer, as a plain ``DataParallel``
    under ``TrainStep`` would be)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.jit import TrainStep

    def run(control):
        m = _port_net(ap_mlp, state)
        opt = paddle.optimizer.SGD(learning_rate=AP_LR,
                                   parameters=m.parameters())
        data = [(batch["x"][i], batch["y"][i]) for i in range(job["steps"])]
        m, opt, dl = dist.to_distributed(m, opt, data)
        step = TrainStep(m, lambda mm, x, y: paddle.mean((mm(x) - y) ** 2),
                         opt._inner_opt if control else opt)
        losses, rows = [], None
        for xb, yb in dl:
            rows = tuple(xb.to_local().shape)
            losses.append(float(step(xb, yb)))
        params = {n: p.detach().numpy().copy()
                  for n, p in m.named_parameters()}
        _reset_topology()
        return losses, rows, params

    losses, rows, params = run(False)
    return dict(losses=losses, rows=rows, params=params,
                control=run(True)[2])


def ap_engine_job(job, state, batch):
    """``Engine`` fit / evaluate / predict / save / load at dp 4
    (``fleet.init``), Adam: the history, the evaluation, the predictions,
    the parameters, and those another model loads from the files."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import auto_parallel as auto
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs["dp_degree"] = 4
    fleet.init(is_collective=True, strategy=s)
    model = _port_net(ap_engine_net, state)
    opt = paddle.optimizer.Adam(learning_rate=3e-2,
                                parameters=model.parameters())
    engine = auto.Engine(model, loss=paddle.nn.MSELoss(), optimizer=opt)
    X, Y = batch["x"], batch["y"]
    hist = engine.fit((X, Y), epochs=job["epochs"], batch_size=32, verbose=0)
    ev = engine.evaluate((X, Y), batch_size=32)
    preds = engine.predict((X,), batch_size=32)
    engine.save(job["path"])
    other = _port_net(ap_engine_net, state)
    opt2 = paddle.optimizer.Adam(learning_rate=3e-2,
                                 parameters=other.parameters())
    auto.Engine(other, loss=paddle.nn.MSELoss(), optimizer=opt2).load(
        job["path"])
    out = dict(hist=hist["loss"], eval=ev["loss"],
               preds=[p.detach().numpy() for p in preds],
               params={n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()},
               loaded={n: p.detach().numpy().copy()
                       for n, p in other.named_parameters()},
               moments=sum(st is not None for st in opt2._accumulators))
    _reset_topology()
    return out


# -- reshard: the executor on local blocks ----------------------------------
RESHARD_SPECS = [(), ("dp",), (None, "dp"), ("mp",), (None, "mp"),
                 ("dp", "mp"), ("mp", "dp"), (("dp", "mp"),),
                 (("mp", "dp"),), (None, ("dp", "mp"))]
RESHARD_SHAPE = (8, 16)


def reshard_job(job, state, batch):
    """Every pair of ``RESHARD_SPECS`` on a dp 2 x mp 2 mesh through
    ``reshard_array`` on this rank's block (f32 and bf16): whether the new
    block is the target's, the moved bytes counted against the plan's;
    DTensors through ``reshard_array`` / ``reshard_state``; a move to a
    1-D mesh over the same ranks."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import reshard as rs

    mesh = _mesh_2x2(dist, ("dp", "mp"))
    full = torch.arange(int(np.prod(RESHARD_SHAPE)),
                        dtype=torch.float32).reshape(RESHARD_SHAPE)
    pairs = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = full.to(dtype)
        for i, src in enumerate(RESHARD_SPECS):
            for j, dst in enumerate(RESHARD_SPECS):
                collective.reset_counts()
                new, plan = rs.reshard_array(
                    rs.local_block(x, mesh, src), mesh, dst, src_spec=src)
                pairs[(str(dtype), i, j)] = (
                    bool(torch.equal(new, rs.local_block(x, mesh, dst))),
                    collective.counts["reshard_moved_bytes"],
                    plan.moved_bytes,
                    collective.counts["reshard_steps"], len(plan.steps))
    t = dist.shard_tensor(full, mesh, [dist.Shard(0), dist.Shard(1)])
    new, plan = rs.reshard_array(t, mesh, (None, ("dp", "mp")))
    src = {"w": t, "b": dist.shard_tensor(full[0], mesh, [
        dist.Replicate(), dist.Shard(0)])}
    dst = {"w": dist.shard_tensor(full, mesh, [dist.Replicate(),
                                               dist.Replicate()]),
           "b": dist.shard_tensor(full[0], mesh, [dist.Shard(0),
                                                  dist.Replicate()])}
    collective.reset_counts()
    moved = rs.reshard_state(src, dst)
    line = dist.ProcessMesh(np.arange(4), dim_names=["dp"])
    cross, cplan = rs.reshard_array(t, line, ("dp",))
    out = dict(
        pairs=pairs,
        dtensor=(new.numpy(), repr(list(new.placements)),
                 tuple(new.to_local().shape)),
        state={k: (v.numpy(), repr(list(v.placements)))
               for k, v in moved.items()},
        state_kept=src["w"].numpy(),
        cross=(cross.numpy(), tuple(cross.to_local().shape),
               cplan.transfer),
        missing=_raised(lambda: rs.reshard_state({}, dst)),
        mismatch=_raised(lambda: rs.reshard_state(
            {"w": src["b"], "b": src["b"]}, dst)))
    _reset_topology()
    return out


# -- distributed checkpoints: save under one layout, resume under another --
CKPT_LM = dict(TINY_LM, num_attention_heads=4)  # mp 4 keeps heads whole
CKPT_SWITCH = 5


def _ckpt_build(degrees, stage, state, named=False):
    """The checkpoint test's GPT (``CKPT_LM``) carrying the full ``state``,
    AdamW (lr 1e-3) and its step: ``DistTrainStep`` under ``degrees`` /
    ``stage`` (``fleet.init``), or a plain ``TrainStep`` with no topology
    (``degrees`` None)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import io_state
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    _reset_topology()
    if degrees is not None:
        fleet.init(is_collective=True, strategy=_strategy_of(degrees, stage))
    model = GPTForCausalLM(GPTConfig(**CKPT_LM), device="cpu")
    io_state.load_numpy_state(model, to_stacked(model, state))
    if named:
        for i, p in enumerate(model.parameters()):
            p.name = f"named_{i}"
    opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters())

    def loss_fn(m, ids, lbl):
        return m(ids, labels=lbl)

    if degrees is None:
        return model, opt, TrainStep(model, loss_fn, opt)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    return model, opt, fleet.DistTrainStep(model, loss_fn, opt)


def _ckpt_steps(step, data, lo, hi):
    import torch

    return [float(step(torch.from_numpy(ids), torch.from_numpy(ids)))
            for ids in data[lo:hi]]


def ckpt_job(job, state, data):
    """For each source layout of ``job["sources"]``: ``CKPT_SWITCH`` steps,
    ``save_state_dict(canonical_state_dict(model, opt))`` (the bytes this
    rank wrote, the checkpoint verified), then for each target layout a
    model built anew that ``restore_canonical`` s it and runs the remaining
    steps (a target of None: rank 0 alone, no topology). Returns the
    losses by ``source->target``."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.env import get_rank

    out = {}
    for name, (degrees, stage, targets) in job["sources"].items():
        _, opt, step = _ckpt_build(degrees, stage, state)
        model = step._model
        first = _ckpt_steps(step, data, 0, CKPT_SWITCH)
        path = os.path.join(job["dir"], name)
        ckpt.save_state_dict(ckpt.canonical_state_dict(model, opt), path)
        out[name] = dict(
            losses=first, bytes=ckpt.saved_bytes(path, get_rank()),
            verified=ckpt.verify_checkpoint(path, deep=True))
        for tname, (tdeg, tstage) in targets.items():
            if tdeg is None and get_rank() != 0:
                continue
            _, opt, step = _ckpt_build(tdeg, tstage, state)
            ckpt.restore_canonical(path, step._model, opt)
            out[f"{name}->{tname}"] = first + _ckpt_steps(
                step, data, CKPT_SWITCH, len(data))
    _reset_topology()
    return out


def ckpt_named_pp_job(job, state, data):
    """The checkpoint test's GPT at pp 2 x dp 2 with named parameters, 2
    ``DistTrainStep`` s: this rank's ``canonical_state_dict`` (keys and
    values) and the keys of ``gather_full_optimizer_state``."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.framework import io_state

    _, opt, step = _ckpt_build({"pp_degree": 2, "dp_degree": 2}, 1, state,
                               named=True)
    _ckpt_steps(step, data, 0, 2)
    canon = ckpt.canonical_state_dict(step._model, opt)
    out = dict(canonical={k: (v.numpy() if hasattr(v, "numpy") else v)
                          for k, v in canon.items()},
               full_opt=sorted(io_state.gather_full_optimizer_state(opt)))
    _reset_topology()
    return out


JOB_KINDS = {"train": fleet_job, "batched": batched_job, "merge": merge_job,
             "mp_wire_fns": mp_wire_fns_job, "mp_wire_gpt": mp_wire_gpt_job,
             "wire": wire_job, "quantized": quantized_collective_job,
             "tiny_lm": tiny_lm_job, "zero3_eager": zero3_eager_job,
             "zero3_slices": zero3_slices_job, "data_parallel": data_parallel_job,
             "pp_zero3_slices": pp_zero3_slices_job,
             "group_sharded": group_sharded_job, "api": api_job,
             "pipeline": pipeline_job, "pipeline_layer": pipeline_layer_job,
             "moe": moe_job, "moe_eager": moe_eager_job, "ring": ring_job,
             "user_lm": user_lm_job, "exchange": exchange_job,
             "wire_lamb": wire_lamb_job, "zero3_hooks": zero3_hooks_job,
             "ap_placements": ap_placements_job, "ap_mlp": ap_mlp_job,
             "ap_gpt": ap_gpt_job, "ap_to_dist": ap_to_dist_job,
             "ap_engine": ap_engine_job, "reshard": reshard_job,
             "ckpt": ckpt_job, "ckpt_named_pp": ckpt_named_pp_job}


def fleet_jobs(jobs, state_of, batch_of):
    """Run ``jobs`` in order on this rank (``state_of`` / ``batch_of`` map
    a job's model / batch key to the full state / batch; ``kind`` picks
    the runner, default a ``DistTrainStep`` trajectory)."""
    return {j["name"]: JOB_KINDS[j.get("kind", "train")](
                j, state_of.get(j.get("model")),
                batch_of.get(j.get("batch", j.get("model"))))
            for j in jobs}


COLLECTIVE_DTYPES = ("float32", "bfloat16", "int64")


def collective_inputs(world, dtype):
    """Rank r's input ``[world * 2, 3]`` of small integers (exact in every
    dtype and under any summation order), as numpy f32 / int64."""
    rng = np.random.default_rng(17)
    x = rng.integers(-3, 4, (world, world * 2, 3))
    x[x == 0] = 1                                  # PROD stays non-zero
    return x.astype(np.int64 if dtype == "int64" else np.float32)


def collective_job():
    """Every collective of ``paddle_tpu_torch.distributed`` at this world
    size, per dtype: ``{(dtype, case): numpy result}`` on this rank."""
    import torch

    from paddle_tpu_torch import distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}

    def np_(t):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()

    for dt in COLLECTIVE_DTYPES:
        tdt = getattr(torch, dt)
        xs = torch.from_numpy(collective_inputs(world, dt)).to(tdt)
        x = xs[rank].clone()
        for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
            t = x.clone()
            dist.all_reduce(t, getattr(dist.ReduceOp, op))
            out[dt, f"all_reduce_{op}"] = np_(t)
        t = x.clone()
        dist.reduce(t, dst=1)
        if rank == 1:
            out[dt, "reduce"] = np_(t)
        lst = []
        dist.all_gather(lst, x)
        out[dt, "all_gather"] = np.stack([np_(v) for v in lst])
        t = torch.empty((x.shape[0], x.shape[1] * world), dtype=tdt)
        dist.all_gather(t, x, axis=1)
        out[dt, "all_gather_axis1"] = np_(t)
        t = x.clone()
        dist.broadcast(t, src=2)
        out[dt, "broadcast"] = np_(t)
        t = torch.empty((x.shape[0] // world,) + x.shape[1:], dtype=tdt)
        dist.reduce_scatter(t, x)
        out[dt, "reduce_scatter"] = np_(t)
        out[dt, "reduce_scatter_functional"] = np_(dist.reduce_scatter(x))
        t = torch.empty_like(x[:2])
        dist.reduce_scatter(t, list(x.chunk(world)))
        out[dt, "reduce_scatter_list"] = np_(t)
        t = torch.empty_like(x[0])
        dist.scatter(t, list(x)[:world] if rank == 0 else None, src=0)
        out[dt, "scatter"] = np_(t)
        lst = []
        dist.alltoall(lst, list(x.chunk(world)))
        out[dt, "alltoall"] = np.concatenate([np_(v) for v in lst])
        t = torch.empty_like(x)
        dist.alltoall_single(t, x)
        out[dt, "alltoall_single"] = np_(t)
        lst = []
        dist.gather(x, lst, dst=3)
        if rank == 3:
            out[dt, "gather"] = np.stack([np_(v) for v in lst])
        t = torch.empty_like(x)
        if rank % 2 == 0:
            dist.send(x, dst=rank + 1)
        else:
            dist.recv(t, src=rank - 1)
            out[dt, "send_recv"] = np_(t)
        fwd, bwd = torch.empty_like(x), torch.empty_like(x)
        tasks = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, (rank + 1) % world),
            dist.P2POp(dist.isend, x * 10, (rank - 1) % world),
            dist.P2POp(dist.irecv, fwd, (rank - 1) % world),
            dist.P2POp(dist.irecv, bwd, (rank + 1) % world)])
        for task in tasks:
            task.wait()
        out[dt, "ring_fwd"], out[dt, "ring_bwd"] = np_(fwd), np_(bwd)
        # every rank holding the same value: the reference's eager
        # (single-controller) reading of a collective
        same = xs[0].clone()
        t = same.clone()
        dist.all_reduce(t)
        out[dt, "eager_all_reduce"] = np_(t)
        lst = []
        dist.all_gather(lst, same)
        out[dt, "eager_all_gather"] = [np_(v) for v in lst]
        t = same.clone()
        dist.broadcast(t, src=0)
        out[dt, "eager_broadcast"] = np_(t)
        out[dt, "eager_reduce_scatter"] = np_(dist.reduce_scatter(same))
        t = x.clone()
        task = dist.all_reduce(t, sync_op=False)
        task.wait()
        out[dt, "async_all_reduce"] = np_(t)
        t = x.clone()
        dist.stream.all_reduce(t)
        out[dt, "stream_all_reduce"] = np_(t)
    objs = []
    dist.all_gather_object(objs, {"rank": rank})
    out["all_gather_object"] = objs
    objs = [rank, f"r{rank}"]
    dist.broadcast_object_list(objs, src=1)
    out["broadcast_object_list"] = objs
    got = []
    dist.scatter_object_list(got, [f"part{i}" for i in range(world)]
                             if rank == 2 else None, src=2)
    out["scatter_object_list"] = got
    dist.barrier()
    out["backend"] = dist.get_backend()
    out["world"] = (dist.get_world_size(), dist.get_rank(),
                    dist.ParallelEnv().world_size, dist.ParallelEnv().rank)
    sub = dist.new_group([1, 3])
    t = torch.ones(2)
    dist.all_reduce(t, group=sub)
    out["subgroup"] = (sub.rank, t.numpy())
    out["counts"] = dict(dist.collective.counts)
    return out


def mpu_inputs():
    """Full weights and inputs of the mp-layer tests (numpy, seeded)."""
    rng = np.random.default_rng(31)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    logits = f(3, 5, 10) * 3
    labels = rng.integers(0, 10, (3, 5))
    labels[0, :2] = -100
    labels[2, 4] = -100
    return dict(col_w=f(8, 16), col_b=f(16), row_w=f(16, 8), row_b=f(8),
                emb_w=f(32, 8), x=f(4, 8), ids=rng.integers(0, 32, (4, 6)),
                logits=logits, labels=labels, seq=f(2, 8, 4),
                seq_grad=f(2, 8, 4))


def mpu_job(inp, gpt_state):
    """The mp layers at this world size (all of it mp): outputs and the
    gathered full gradients, the SP ops, the full <-> shard round trip."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.layers import mpu
    from paddle_tpu_torch.distributed.fleet.utils import (
        sequence_parallel_utils as spu)
    from paddle_tpu_torch.framework.io_state import gather_full_state

    world = dist.get_world_size()
    s = fleet.DistributedStrategy()
    s.hybrid_configs["mp_degree"] = world
    fleet.init(is_collective=True, strategy=s)
    group = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
    out = {}

    def load(layer, **full):
        for name, v in full.items():
            p = getattr(layer, name)
            axis = p.split_axis if mpu.is_mp_shard(p) else None
            with torch.no_grad():
                p.copy_(v if axis is None else mpu.shard_of(
                    v, axis, group.rank, world))
        return layer

    def grads(layer):
        return {n: (mpu.full_of(p.grad, p.split_axis, group)
                    if mpu.is_mp_shard(p) else p.grad).numpy()
                for n, p in layer.named_parameters()}

    for gather_output, input_is_parallel in ((False, True), (True, False)):
        col = load(mpu.ColumnParallelLinear(
            8, 16, gather_output=gather_output, device="cpu"),
            weight=t["col_w"], bias=t["col_b"])
        row = load(mpu.RowParallelLinear(
            16, 8, input_is_parallel=input_is_parallel, device="cpu"),
            weight=t["row_w"], bias=t["row_b"])
        x = t["x"].clone().requires_grad_(True)
        y = row(col(x))
        (y * y).sum().backward()
        key = f"linear_{gather_output}"
        out[key] = dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                        col=grads(col), row=grads(row))
    emb = load(mpu.VocabParallelEmbedding(32, 8, device="cpu"),
               weight=t["emb_w"])
    e = emb(t["ids"])
    (e * e).sum().backward()
    out["embedding"] = dict(y=e.detach().numpy(), grads=grads(emb))
    shard = mpu.shard_of(t["logits"], 2, group.rank, world).clone()
    shard.requires_grad_(True)
    ce = mpu.ParallelCrossEntropy(ignore_index=-100)
    loss = ce(shard, t["labels"])
    (loss * torch.arange(1.0, 16.0).reshape(3, 5)).sum().backward()
    out["ce"] = dict(loss=loss.detach().numpy(),
                     dlogits=mpu.full_of(shard.grad, 2, group).numpy())
    # sequence-parallel ops on [b, t, h] along t, forward and backward
    for name, op in (("scatter", spu.ScatterOp), ("gather", spu.GatherOp),
                     ("all_gather", spu.AllGatherOp),
                     ("reduce_scatter", spu.ReduceScatterOp)):
        src = t["seq"]
        if name in ("gather", "all_gather"):
            src = mpu.shard_of(src, 1, group.rank, world)
        src = src.clone().requires_grad_(True)
        y = op.apply(src)
        g = t["seq_grad"]
        if name in ("scatter", "reduce_scatter"):
            g = mpu.shard_of(g, 1, group.rank, world)
        y.backward(g.contiguous())
        out[f"sp_{name}"] = dict(y=y.detach().numpy(), dx=src.grad.numpy())
    # paddle.distributed.split: a column-split linear and an embedding
    torch.manual_seed(0)
    out["split_linear"] = dist.split(t["x"], (8, 16), "linear", axis=1,
                                     gather_out=True).detach().numpy()
    out["split_embedding"] = dist.split(t["ids"], (32, 8),
                                        "embedding").detach().numpy()
    # full -> shards -> full on the tiny GPT
    model = port_model("gpt", gpt_state)
    out["shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out["round_trip"] = {k: v.numpy()
                         for k, v in gather_full_state(model).items()}
    # RNG streams: "global_seed" alike on every rank, "local_seed" not
    mpu.model_parallel_random_seed(5)
    tracker = mpu.get_rng_state_tracker()
    draws = {}
    for name in ("global_seed", "local_seed"):
        with tracker.rng_state(name):
            draws[name] = torch.rand(4).numpy()
    out["rng"] = draws
    fleet.topology.set_hybrid_communicate_group(None)
    return out


# -- the parameter server's split table (tests/test_torch_rpc_ps.py) ---------
def ps_table_job(weight, ids, w_out, lr, padding_idx):
    """One rank of a ``ShardedEmbeddingTable`` split over the ``dp`` axis
    of a global ProcessMesh of the world: this rank's rows of ``weight``,
    the lookup of ``ids`` (the same on every rank), the loss
    ``sum(out * w_out)``, its backward and one SGD step. Returns the
    output, this rank's gradient rows and updated rows, and the table's
    placement report."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.optimizer import SGD

    world = dist.get_world_size()
    dist.set_global_mesh(dist.ProcessMesh(list(range(world)),
                                          dim_names=["dp"]))
    try:
        table = ps.ShardedEmbeddingTable(weight.shape[0], weight.shape[1],
                                         padding_idx=padding_idx,
                                         device="cpu")
        lo = table.vocab_start
        with torch.no_grad():
            table.weight.copy_(torch.from_numpy(
                weight[lo:lo + table.weight.shape[0]]))
        opt = SGD(learning_rate=lr, parameters=table.parameters())
        out = table(torch.from_numpy(ids))
        (out * torch.from_numpy(w_out)).sum().backward()
        grad = table.weight.grad.clone()
        opt.step()
        return dict(out=out.detach().numpy(), grad=grad.numpy(),
                    rows=table.weight.detach().numpy(), lo=lo,
                    info=table.shard_info())
    finally:
        dist.set_global_mesh(None)


def same_planner_constants(monkeypatch):
    """Give both packages' auto-parallel planners the same cached cost
    constants (the reference's fit of its ``MULTICHIP_SCALING.json``), so
    ``apply_auto_plan`` / ``plan_mpmd_stages`` without explicit constants
    compare: by default each package loads its own calibration (the
    port's is measured on the card). That fit zeroes ``sec_per_flop``,
    where each MPMD planner falls back to its own package's analytic flop
    rate; both get the reference's 2e-10 instead."""
    import dataclasses

    from paddle_tpu.distributed.auto_parallel import planner as ref

    from paddle_tpu_torch.distributed.auto_parallel import planner as port

    rc = ref.load_calibration(path=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "MULTICHIP_SCALING.json"))
    if not rc.sec_per_flop:
        rc = dataclasses.replace(rc, sec_per_flop=2.0e-10)
    pc = port.CostConstants(
        fixed_s=rc.fixed_s, sec_per_flop=rc.sec_per_flop,
        sec_per_byte=rc.sec_per_byte, sec_per_collective=rc.sec_per_collective,
        sec_per_dp_over_byte=rc.sec_per_dp_over_byte, source=rc.source,
        max_rel_error=rc.max_rel_error)
    monkeypatch.setattr(ref, "_CALIBRATION", rc)
    monkeypatch.setattr(port, "_CALIBRATION", pc)
    return pc, rc


# -- the decode engine at mp > 1 --------------------------------------------
ENGINE_MP_CFG = dict(num_slots=2, max_length=64, page_size=16,
                     prefix_cache=True, speculate_k=2, spec_adaptive=False)


def engine_mp_workload(vocab):
    """tests/test_serving_mp_shard.py's workload: three prompts sharing a
    32-token prefix (two full pages), the middle one sampled."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, vocab, size=32, dtype=np.int64)
    out = []
    for i, tail in enumerate((9, 17, 5)):
        prompt = np.concatenate(
            [prefix, rng.integers(1, vocab, size=tail, dtype=np.int64)])
        out.append((prompt, dict(max_new_tokens=10, do_sample=(i % 2 == 1),
                                 temperature=0.8, top_k=8, seed=100 + i)))
    return out


def engine_drain(eng, reqs):
    from paddle_tpu_torch.inference.engine import SamplingParams

    rids = [eng.submit(p, SamplingParams(**kw)) for p, kw in reqs]
    eng.run()
    return [eng.result(r) for r in rids]


def _engine_model(case, state, split=False):
    """The port's model of ``case`` on the CPU with ``state``: whole, or
    built at mp 2 after ``fleet.init`` (``split``)."""
    from paddle_tpu_torch.distributed import fleet

    if split:
        s = fleet.DistributedStrategy()
        s.hybrid_configs["mp_degree"] = 2
        fleet.init(is_collective=True, strategy=s)
    kw = case.get("model_kw", {})
    if case["kind"] == "gpt":
        m = torch_tiny_gpt(state, **kw)
    else:
        m = torch_tiny_llama(state, **kw)
    m.eval()
    return m


def engine_mp_job(cases, states, ids):
    """Each case at mp 2 on this rank: the whole model served through
    ``EngineConfig(mesh=...)`` and the same weights built at mp 2 (its own
    group), the streams, the pool's heads, the logit-wire bytes per step;
    then ``generate`` at mp 2 (the model's cached route and the engine
    route)."""
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from paddle_tpu_torch.text import generation

    mesh = ProcessMesh(np.arange(2).reshape(1, 2), dim_names=["dp", "mp"])
    out = {}
    for case in cases:
        state = states[case["model"]]
        reqs = engine_mp_workload(case["vocab"])
        res = {}
        # a model built at mp 2 needs a vocab that 2 divides
        for split in (False, True) if case["vocab"] % 2 == 0 else (False,):
            m = _engine_model(case, state, split)
            cfg = EngineConfig(**ENGINE_MP_CFG, kv_dtype=case.get("kv", "f32"),
                               logit_wire=case.get("wire"),
                               mesh=None if split else mesh)
            eng = DecodeEngine(m, cfg, device="cpu")
            C.counts["logit_wire_bytes"] = 0
            streams = engine_drain(eng, reqs)
            st = eng.stats()
            res["split" if split else "mesh"] = dict(
                streams=streams, pool=tuple(eng._kc.shape),
                scales=None if eng._ksc is None else tuple(eng._ksc.shape),
                wire=eng._logit_wire, verify=eng._logit_verify,
                wire_bytes=C.counts["logit_wire_bytes"],
                steps=st["decode_steps"], verify_steps=st["verify_steps"],
                prefills=st["prefill_calls"],
                prefix_hit_tokens=st["prefix_hit_tokens"])
            if case.get("generate"):
                t = torch.as_tensor(ids[case["vocab"]])
                if split:
                    res["generate_split"] = m.generate(t, max_new_tokens=8)
                    res["loop_split"] = generation.generate(
                        m, t, max_new_tokens=8, use_engine=False)
                else:
                    inference.enable_decode_engine(
                        m, device="cpu", num_slots=2, max_length=64,
                        mesh=mesh)
                    res["generate_engine"] = generation.generate(
                        m, t, max_new_tokens=8)
                    inference.disable_decode_engine(m)
            _reset_topology()
        out[case["name"]] = res
    return out


# -- masks, biases and dropout under the sequence split ---------------------
def _seq_block(a, axis, n, r):
    k = a.shape[axis] // n
    return np.ascontiguousarray(np.take(a, range(r * k, (r + 1) * k),
                                        axis=axis))


def _local_mask(case, n, r):
    """This rank's part of a global mask: a key layout cut along its key
    dim, a row layout along its query dim."""
    import torch

    m = case["mask"]
    axis = m.ndim - 1 if case["layout"] in ("pad", "keys") else m.ndim - 2
    return torch.from_numpy(_seq_block(m, axis, n, r))


def _tiny_ernie_mlm(state):
    return torch_tiny_encoder(state, "ernie", "ErnieForMaskedLM")


def ernie_mlm_loss(model, ids, types, mask, labels):
    return model(ids, types, attention_mask=mask, labels=labels)


def sep_mask_job(cases, batch, drop, ernie):
    """At sep 2 (``fleet.init``, the world of 2): each mask ``case`` on
    this rank's block of ``batch`` q / k / v / do through the plain ring
    and the kernels' route (their plain versions here): the output, the
    q / k / v gradients and the ring's ``batch_isend_irecv`` count;
    dropout through the plain ring (its seed drawn after
    ``torch.manual_seed(drop["seed"])``) and through
    ``scaled_dot_product_attention`` under the split with the flash route
    asked for; then the tiny ERNIE masked LM with its padding mask through
    ``DistTrainStep`` + AdamW on both routes, the per-step losses."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional import attention
    from paddle_tpu_torch.nn.functional import ring_attention as ra

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=1, sep_degree=2)
    fleet.init(is_collective=True, strategy=s)
    group = fleet.get_hybrid_communicate_group().get_sep_parallel_group()
    n, r = group.nranks, group.rank
    q, k, v, do = (torch.from_numpy(_seq_block(batch[x], 1, n, r))
                   for x in ("q", "k", "v", "do"))
    out = dict(sep_rank=r)
    for case in cases:
        mask = _local_mask(case, n, r)
        res = {}
        for route, fn in (("plain", ra.ring_flash_attention_plain),
                          ("kernels", ra.ring_flash_attention)):
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            C.counts["batch_isend_irecv"] = 0
            o = fn(qq, kk, vv, group, causal=case["causal"], mask=mask)
            o.backward(do)
            res[route] = dict(o=o.detach().numpy(), dq=qq.grad.numpy(),
                              dk=kk.grad.numpy(), dv=vv.grad.numpy(),
                              p2p=C.counts["batch_isend_irecv"])
        out[case["name"]] = res
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    torch.manual_seed(drop["seed"])
    o = ra.ring_flash_attention_plain(qq, kk, vv, group, causal=True,
                                      dropout_p=drop["p"])
    o.backward(do)
    res = dict(o=o.detach().numpy(), dq=qq.grad.numpy(), dk=kk.grad.numpy(),
               dv=vv.grad.numpy())
    torch.manual_seed(drop["seed"])
    attention._FLASH_ON_CPU = True
    try:
        with ra.sequence_split(group):
            res["sdpa"] = F.scaled_dot_product_attention(
                q, k, v, dropout_p=drop["p"], is_causal=True,
                training=True).numpy()
    finally:
        attention._FLASH_ON_CPU = False
    out["dropout"] = res
    ids, types, mask, labels = (torch.from_numpy(x) for x in ernie["batch"])
    for route in ("plain", "kernels"):
        attention._FLASH_ON_CPU = route == "kernels"
        try:
            model = _tiny_ernie_mlm(ernie["state"])
            opt = paddle.optimizer.AdamW(learning_rate=ernie["lr"],
                                         parameters=model.parameters(),
                                         weight_decay=0.01)
            step = fleet.DistTrainStep(model, ernie_mlm_loss, opt)
            C.counts["batch_isend_irecv"] = 0
            out[f"ernie_{route}"] = dict(
                losses=[float(step(ids, types, mask, labels))
                        for _ in range(ernie["steps"])],
                p2p=C.counts["batch_isend_irecv"])
        finally:
            attention._FLASH_ON_CPU = False
    fleet.topology.set_hybrid_communicate_group(None)
    return out


# -- the distributed paddle.Model, comm_traffic, save_persistables ----------
HAPI_VOCAB = 32


def hapi_net(pkg):
    """tests/test_grad_comm.py's ``_Net`` built in ``pkg``."""
    nn, F = pkg.nn, pkg.nn.functional

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(HAPI_VOCAB, 16)
            self.l1 = nn.Linear(16, 24)
            self.l2 = nn.Linear(24, 16)
            self.norm = nn.LayerNorm(16)
            self.head = nn.Linear(16, HAPI_VOCAB)

        def forward(self, ids):
            h = self.emb(ids)
            h = F.gelu(self.l1(h))
            return self.head(self.norm(self.l2(h)))

    return Net()


def hapi_rows(pkg, ids, labels):
    """A dataset of ``(ids[i], labels[i])`` in ``pkg``'s ``io``."""

    class Rows(pkg.io.Dataset):
        def __getitem__(self, i):
            return ids[i], labels[i]

        def __len__(self):
            return len(ids)

    return Rows()


def _hapi_model(paddle, state, lr):
    from paddle_tpu_torch.framework.io_state import load_numpy_state

    net = hapi_net(paddle)
    load_numpy_state(net, state)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.AdamW(learning_rate=lr,
                                         parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss())
    return net, model


def hapi_dist_job(state, data, lr, out_dir):
    """At dp 2 (``fleet.init``): ``Model.fit`` over the rows (the global
    batch on each rank), the per-step losses; ``comm_traffic`` on one
    batch under the f32 and the bf16 gradient wire (a fresh model each);
    ``save_persistables`` and a restore into another model; its refusals;
    then at pp 2 a ``PipelineLayer`` network's ``prepare``."""
    import os

    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import checkpoint, fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpar
    from paddle_tpu_torch.hapi.callbacks import Callback

    s = fleet.DistributedStrategy()
    s.hybrid_configs["dp_degree"] = 2
    fleet.init(is_collective=True, strategy=s)
    ids, labels = (torch.from_numpy(data[k]) for k in ("ids", "labels"))

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    net, model = _hapi_model(paddle, state, lr)
    rec = Losses()
    model.fit(hapi_rows(paddle, ids, labels), batch_size=data["batch"],
              epochs=1, shuffle=False, verbose=0, callbacks=[rec])
    out = dict(losses=rec.losses, step=type(model._train_step).__name__,
               n_params=sum(p.numel() for p in net.parameters()),
               sizes=[p.numel() * 4 for p in net.parameters()])
    batch = (ids[:data["batch"]], labels[:data["batch"]])
    for wire in ("f32", "bf16"):
        os.environ["PADDLE_TPU_GRAD_COMM"] = wire
        try:
            _, m = _hapi_model(paddle, state, lr)
            out[f"traffic_{wire}"] = m.comm_traffic(*batch)
        finally:
            del os.environ["PADDLE_TPU_GRAD_COMM"]
    path = os.path.join(out_dir, "persist")
    out["saved"] = fleet.save_persistables(dirname=path, model=net)
    other = hapi_net(paddle)
    checkpoint.load_state_dict(os.path.join(path, "persistables"),
                               dict(other.named_parameters()))
    out["restored"] = all(torch.equal(a, b) for a, b in
                          zip(net.parameters(), other.parameters()))
    out["refusals"] = {
        "no_dirname": _raised(lambda: fleet.save_persistables(model=net)),
        "program": _raised(lambda: fleet.save_persistables(dirname=path)),
        "empty": _raised(lambda: fleet.save_persistables(
            dirname=path, model=paddle.nn.ReLU()))}
    _reset_topology()
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=1, pp_degree=2)
    fleet.init(is_collective=True, strategy=s)
    descs, loss_fn = pipe_layer_lm(paddle)
    pipe = mpar.PipelineLayer(descs, loss_fn=loss_fn)
    try:
        paddle.Model(pipe).prepare(
            paddle.optimizer.AdamW(learning_rate=lr,
                                   parameters=pipe.parameters()),
            loss_fn)
        out["pipeline"] = None
    except NotImplementedError as e:
        out["pipeline"] = str(e)
    _reset_topology()
    return out


# -- the vision zoo -----------------------------------------------------------
#: f32 logits and gradients of the zoo against the reference: XLA's and
#: oneDNN's convolutions sum in other orders (test_torch_resnet.py's RTOL)
ZOO_RTOL = 1e-4
ZOO_CLASSES = 10
#: the calibrated batch norms' variance floor (ZooPair._calibrate): an
#: activation std of 0.1, a gain of at most 10
CALIBRATION_FLOOR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU convolutions in a zoo file
    (import it there): the suite runs 6 test processes at once."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def zoo_close(got, want, rtol=ZOO_RTOL, what=""):
    """``got`` within ``rtol`` of the largest magnitude of ``want``."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} x {scale:.3e}"


@contextlib.contextmanager
def numpy_draws(seed):
    """Within: ``jax.random.normal`` / ``uniform`` drawn from numpy's
    generator seeded with ``seed``. The reference's initializers call them
    once a parameter, and each new shape costs an XLA compile (~0.4 s on
    an 8-core x86 CPU: 20-60 s a zoo model's build); the weights only need
    to be seeded and shared with the port, which loads them."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    saved = jax.random.normal, jax.random.uniform

    # numpy arrays, so the initializers' scaling runs in numpy too
    def normal(key, shape=(), dtype=jnp.float32):
        return rng.standard_normal(shape).astype(np.dtype(dtype))

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return rng.uniform(minval, maxval, shape).astype(np.dtype(dtype))

    jax.random.normal, jax.random.uniform = normal, uniform
    try:
        yield
    finally:
        jax.random.normal, jax.random.uniform = saved


def _no_dropout(model, cls):
    for m in model.sublayers(include_self=True):
        if isinstance(m, cls):
            m.p = 0.0


class ZooPair:
    """A reference model (``ref_ctor()``, built after ``paddle.seed``) and
    the port's (``port_ctor()``, on the CPU) carrying its weights, with a
    seeded input of ``shape``.

    - :meth:`eval_outputs`: both in eval mode (the reference's forward
      jitted whole);
    - :meth:`train_forward`: both in training mode with every dropout at
      0 (the two packages' dropout streams differ): the outputs
      (GoogLeNet's aux heads too) and the batch norms' running statistics
      after;
    - :meth:`backward`: both in eval mode (the batch norms' statistics
      frozen, as a fine-tuning run freezes them, at this batch's: see
      :meth:`_calibrate`), a seeded cotangent on the output: the input's
      and every parameter's gradient. With batch
      statistics a ReLU input within rounding of 0 flips a whole
      channel's gradient (``test_torch_resnet.py``'s docstring): MobileNet
      V1's training-mode gradients part by 1e-4-6e-3 at batch 2-4
      (measured)."""

    def __init__(self, ref_ctor, port_ctor, shape, seed=0):
        import paddle_tpu as paddle
        from paddle_tpu_torch.framework import load_numpy_state

        paddle.seed(seed)
        with numpy_draws(seed):
            self.ref = ref_ctor()
        self.state = numpy_state(self.ref)
        self.port = load_numpy_state(port_ctor(), self.state)
        self.x = np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32)

    @staticmethod
    def _tuple(out):
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def eval_outputs(self):
        import jax.numpy as jnp
        import torch
        from paddle_tpu.framework.core import Tensor
        from paddle_tpu.framework.op import raw

        self.ref.eval()
        self.port.eval()
        want = np.asarray(self._jit_ref(lambda a: raw(self.ref(Tensor(a))))(
            jnp.asarray(self.x)))
        with torch.no_grad():
            got = self.port(torch.from_numpy(self.x)).numpy()
        return got, want

    def _jit_ref(self, fn):
        """``fn`` jitted over the reference model, its parameter and buffer
        values swapped for traced ones inside and restored after (the
        reference's own ``TrainStep`` does the same): its eager per-op
        compiles of a zoo model's forward took 20-120 s on an 8-core x86
        CPU."""
        import jax

        import paddle_tpu as paddle

        tensors = [t for _, t in self.ref.named_parameters()] + \
            [t for _, t in self.ref.named_buffers()]

        # the values are arguments, not constants folded into the program
        def run(values, *args):
            saved = [t._value for t in tensors]
            for t, v in zip(tensors, values):
                t._value = v
            try:
                with paddle.no_grad():
                    return fn(*args)
            finally:
                for t, v in zip(tensors, saved):
                    t._value = v

        jitted = jax.jit(run)
        return lambda *args: jitted([t._value for t in tensors], *args)

    def _ref_train_forward(self, momentum=None):
        """The reference in training mode (dropout 0) on the input, jitted:
        its outputs and its buffers' new values by name; ``momentum`` set
        on every batch norm for the call."""
        import jax.numpy as jnp
        from paddle_tpu import nn as rnn
        from paddle_tpu.framework.core import Tensor
        from paddle_tpu.framework.op import raw

        self.ref.set_state_dict(self.state)
        self.ref.train()
        _no_dropout(self.ref, rnn.Dropout)
        names = [n for n, _ in self.ref.named_buffers()]
        bufs = [t for _, t in self.ref.named_buffers()]
        bns = [m for m in self.ref.sublayers(include_self=True)
               if hasattr(m, "_momentum") and hasattr(m, "_variance")]
        momenta = [m._momentum for m in bns]
        if momentum is not None:
            for m in bns:
                m._momentum = momentum
        try:
            outs, new = self._jit_ref(lambda a: (
                [raw(o) for o in self._tuple(self.ref(Tensor(a)))],
                [t._value for t in bufs]))(jnp.asarray(self.x))
        finally:
            for m, mom in zip(bns, momenta):
                m._momentum = mom
        return ([np.asarray(o) for o in outs],
                {n: np.asarray(v) for n, v in zip(names, new)})

    def train_forward(self):
        import torch
        from paddle_tpu_torch import nn as tnn
        from paddle_tpu_torch.framework import load_numpy_state

        routs, rbufs = self._ref_train_forward()
        load_numpy_state(self.port, self.state)
        self.port.train()
        _no_dropout(self.port, tnn.Dropout)
        with torch.no_grad():
            pouts = self._tuple(self.port(torch.from_numpy(self.x)))
        pstate = self.port.state_dict()
        stats = [k for k in self.state if k.endswith(("_mean", "_variance"))]
        return dict(
            outputs=[(p.numpy(), r) for p, r in zip(pouts, routs)],
            stats={k: (pstate[k].numpy(), rbufs[k]) for k in stats})

    def _calibrate(self):
        """The batch norms' running statistics set, on both sides, to the
        reference's batch statistics of this input (a training-mode
        forward at momentum 0, dropout 0; each variance floored at
        CALIBRATION_FLOOR): frozen statistics that keep the activations at
        scale (the initial ones, 0 and 1, let a MobileNet's logits shrink
        to ~1e-20 and its gradients to noise) and a near-constant channel's
        gain at most 10 (unfloored, a variance of 2.4e-5 scaled the
        rounding behind it 200-fold a layer: MobileNet V1's and
        ShuffleNetV2's input gradients parted by 7e-3 and 0.16,
        measured)."""
        from paddle_tpu_torch.framework import load_numpy_state

        _, rbufs = self._ref_train_forward(momentum=0.0)
        for k, v in rbufs.items():
            if k.endswith("_variance"):
                # a channel of near-constant values would scale the
                # rounding behind it by up to 1 / sqrt(eps) at each layer
                rbufs[k] = np.maximum(v, CALIBRATION_FLOOR)
        state = dict(self.state, **rbufs)
        self.ref.set_state_dict(state)
        load_numpy_state(self.port, state)

    def backward(self):
        import jax
        import jax.numpy as jnp
        import torch
        from paddle_tpu.framework.core import Tensor
        from paddle_tpu.framework.op import raw

        self._calibrate()
        self.ref.eval()
        self.port.eval()
        params = [p for _, p in self.ref.named_parameters()]
        px = torch.tensor(self.x, requires_grad=True)
        po = self.port(px)
        w = np.random.default_rng(1).standard_normal(
            tuple(po.shape)).astype(np.float32)

        def loss(values, a):
            for p, v in zip(params, values):
                p._value = v
            return jnp.sum(raw(self.ref(Tensor(a))) * w)

        grads, dx = self._jit_ref(jax.grad(loss, argnums=(0, 1)))(
            [p._value for p in params], jnp.asarray(self.x))
        (po * torch.from_numpy(w)).sum().backward()
        names = [n for n, _ in self.ref.named_parameters()]
        rgrads = dict(zip(names, grads))
        return dict(dx=(px.grad.numpy(), np.asarray(dx)),
                    grads={n: (p.grad.numpy(), np.asarray(rgrads[n]))
                           for n, p in self.port.named_parameters()})


def check_zoo_names(pair):
    """The port's state holds the reference's names, and its parameters
    come in the reference's order (the optimizer's state order)."""
    assert set(pair.port.state_dict()) == set(pair.state)
    assert [n for n, _ in pair.port.named_parameters()] == \
        [n for n, _ in pair.ref.named_parameters()]


def check_zoo_stats(stats, rtol=ZOO_RTOL):
    """The running statistics after a training-mode forward: each
    ``_variance`` within ``rtol`` of its largest value; each ``_mean``
    (0.1 of a batch mean, which cancels to ~0: its own magnitude is no
    scale) within ``rtol`` of the square root of its layer's largest
    running variance, the activations' scale."""
    for k, (got, want) in stats.items():
        if k.endswith("_mean"):
            var = stats[k[:-len("_mean")] + "_variance"][1]
            err = float(np.abs(got - want).max())
            assert err <= rtol * float(np.sqrt(np.max(var))), (k, err)
        else:
            zoo_close(got, want, rtol, k)


def check_zoo_train(pair, rtol=ZOO_RTOL):
    """:meth:`ZooPair.train_forward`'s outputs and running statistics and
    :meth:`ZooPair.backward`'s gradients, each within ``rtol`` (an
    attention's key bias, whose gradient is 0, within ``rtol`` of the
    largest gradient)."""
    res = pair.train_forward()
    for i, (got, want) in enumerate(res["outputs"]):
        zoo_close(got, want, rtol, f"training-mode output {i}")
    check_zoo_stats(res["stats"], rtol)
    res = pair.backward()
    zoo_close(*res["dx"], rtol, "input gradient")
    top = max(float(np.abs(w).max()) for _, w in res["grads"].values())
    for n, (got, want) in res["grads"].items():
        if n.endswith("k_proj.bias"):
            # a key bias shifts every logit of a query row alike: its
            # gradient is 0, float noise on both sides
            assert float(np.abs(got).max()) <= rtol * top, n
            continue
        zoo_close(got, want, rtol, f"{n} gradient")


def zoo_block(module, name, *args, **kw):
    """``(reference ctor, port ctor)`` of the building block ``name`` of
    the zoo module ``module`` (``"densenet"``, ...) with ``args``; the
    port's on the CPU."""
    import importlib

    ref = importlib.import_module(f"paddle_tpu.vision.models.{module}")
    port = importlib.import_module(f"paddle_tpu_torch.vision.models.{module}")
    return (lambda: getattr(ref, name)(*args, **kw),
            lambda: getattr(port, name)(*args, device="cpu", **kw))


def port_zoo_shapes(builders, shape, classes=ZOO_CLASSES, **kw):
    """Each named builder of the port's zoo built on the CPU; its eval
    output's shape on a zero input of ``shape``."""
    import torch
    from paddle_tpu_torch.vision import models as tm

    out = {}
    for name in builders:
        m = getattr(tm, name)(num_classes=classes, device="cpu", **kw)
        m.eval()
        with torch.no_grad():
            out[name] = tuple(m(torch.zeros(shape)).shape)
    return out
