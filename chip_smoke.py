#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final line):

1. environment: card name and power limit (nvidia-smi), torch / CUDA
   versions, compute capability 9.0 required, TF32 off;
2. build the hand-written kernels from the sources in the checkout;
3. kernel vs plain version: paged attention over f32 / bf16 / int8 pools,
   T in {1, 5, 256 (S=1)}, G in {1, 4}, D in {64, 128}, and two tail
   prefills (S=1: T=1024 from position 0, T=200 after a 256-token cached
   prefix), each call checked to have run the regime its shape picks
   (``tile`` or ``split``); then its time at the serving path's shapes
   (decode, verify, prefill) in turns with one PyTorch library call
   (scaled_dot_product_attention over pre-gathered K/V, its backend
   named), beside the plain version and the card's two bounds;
4. serving at full width: GPT-3 1.3B (24 layers, random weights from a
   seed) through ``DecodeEngine`` — 8 greedy requests, paged bf16 KV,
   prefix sharing, prompt-lookup speculation — with the kernel's launch
   count checked against the layers x programs run (prefills all in the
   tile regime, decode and verify steps all in the split regime), and the
   token streams checked against the same run on the plain attention;
5. kernel vs plain through the engine at depth 2, f32 and int8 KV, in
   lockstep: per-step logits compared, greedy streams equal;
6. flash attention, kernels K1 (forward), K2a (dQ) and K2b (dK/dV) vs
   their plain versions: causal on / off, Tq = Tk, Tq < Tk and Tq > Tk
   (rows with no visible key), a single query row, three keys,
   G in {1, 2, 4}, D in {64, 128}, bias / bool-mask / broadcast variants,
   strided q/k/v views, f32 and bf16;
   then their times at the training shapes (B=2, T=2048, H=16, D=128,
   causal; f32 and bf16) beside the plain versions, one PyTorch library
   call (scaled_dot_product_attention forward, its autograd backward) and
   the card's bound; K1 timed in turns with SDPA's forward, the pair
   K2a + K2b in turns with SDPA's backward;
7. training at full width: GPT-3 1.3B (24 layers, random weights from a
   seed) through ``TrainStep`` + ``AdamW`` (Brown et al. 2020 settings)
   for 4 steps on one 2 x 2048-token batch, the flash kernels' launch
   counts checked against 24 layers x 4 steps, the first loss checked
   against a no-grad forward on the plain attention;
8. a kernel trainer and a plain-attention trainer in lockstep at depth 2
   for 3 steps: per-step losses and final parameters compared;
9. grouped matmul, kernels K4a (forward, and dlhs on a transposed rhs
   view) and K4b (drhs) vs their plain versions: the reference tests'
   group layouts (aligned, ragged, empty groups, trailing empties, a
   padding tail, a group over several tiles), N = 192, odd K and N, the
   Mixtral 8x7B top-2 routing (8192 rows, 4096 -> 14336, 8 experts,
   Dirichlet sizes) and 128 groups over 4096 rows, f32 and bf16;
10. the five grouped matmuls of one MoE training step at the Mixtral
   widths, in f32 and in bf16, each beside its plain version, one dense
   ``torch.matmul`` of the same FLOPs, a grouped library call
   (``torch._grouped_mm`` where it takes the dtype, else a per-expert
   ``torch.mm`` loop, labelled) and the card's bound;
11. MoE training at full width: Mixtral 8x7B's MoE block (dim 4096,
   hidden 14336, 8 experts, top-2; random weights from a seed), dropless,
   under a ``Linear(4096, 1)`` head with MSE + the aux loss, through
   ``TrainStep`` + ``AdamW`` (phase 7's settings at lr 1e-5) for 4 steps
   on one 2 x 2048-token batch:
   the loss falls, K4a launches 3 and K4b 2 per step, the first loss
   equals a no-grad forward on the plain grouped matmul;
12. a kernel trainer and a plain trainer in lockstep at reduced width
   (dim 1024, hidden 3584): step-1 loss and gradients, then per-step
   losses and the share of token slots routed alike;
13. serving Llama-3-8B at full width and depth (32 layers, 32 query heads
   over 8 kv heads, random weights from a seed) as phase 4 serves GPT:
   K3 folds the 4 query heads of each kv head into its rows, so verify
   steps (20 folded rows) run the tile regime; each regime's launches
   are checked against ``_k3_regime``; the greedy streams are compared
   with the plain attention's on f32 caches (``phase_serving`` says why);
14. phase 5 on Llama-3-8B at depth 2;
15. K1, K2a + K2b (B=2, T=2048, H=32, Hkv=8, D=128, causal; f32 and bf16,
   timed in turns with SDPA over GQA inputs) and K3 (decode, verify,
   prefill over a bf16 pool at Hkv=8, G=4) at the Llama shapes;
16. training Llama-3-8B's widths at depth 4 as phase 7 trains GPT (AdamW
   with Touvron et al. 2023 settings): the loss falls, 4 x 4 launches of
   each flash kernel, the first loss equals the plain attention's;
17. phase 8 on Llama-3-8B's widths at depth 2;
18. mixed precision: GPT-3 1.3B at full width and depth under
   ``auto_cast(level="O1")``, phase 7's AdamW with a warmup + cosine
   learning rate from ``optimizer/lr.py``, 4 steps: the loss falls, K1 /
   K2a / K2b launch in bf16 24 x 4 times each, the first loss is within
   ``AMP_LOSS_RTOL`` of phase 7's f32 loss on the same weights and batch;
19. the same at O2 after ``amp.decorate``: every parameter stays bf16,
   every moment and every master copy f32;
20. O1 with ``use_recompute=True`` (granularity "full"): the step-1 loss
   and every gradient bit-equal to the run without, K1 launched twice a
   layer a step (its forward runs again in the backward) and K2a / K2b
   once, and the training step's peak memory below phase 18's;
21. Llama-3-8B's widths at depth 4 under O1 as phase 16 (GQA K1 / K2 in
   bf16, 4 x 4 launches each, the first loss within ``AMP_LOSS_RTOL`` of
   phase 16's);
22. a kernel trainer and a plain-attention trainer under O1 at depth 2
   (GPT-3 1.3B), step-1 gradients and 3 steps' losses compared;
23. ERNIE-3.0-base (12 layers, hidden 768, vocab 40000, dropouts 0.1;
   random weights from a seed) fine-tuned as a sentence-pair classifier
   through ``paddle.Model``: ``fit`` over an ``io.DataLoader`` (batch 32,
   max_seq_length 128, real lengths 16-128, shuffled, 2 worker processes)
   with AdamW under a warmup + linear decay schedule for 32 steps, then
   ``evaluate`` and ``predict`` over 8 batches: the loss falls (mean of the
   last 4 steps below the first 4), fit launches no flash kernel
   (attention dropout 0.1 takes the dense route, as in the reference),
   evaluate launches K1 12 x 8 times, each non-causal with the [32, 1, 1,
   128] padding bias, accuracy in [0, 1], and evaluate's logits match the
   plain attention's on the same weights;
24. ERNIE at depth 2 with dropouts 0, a kernel model and a plain-attention
   model in lockstep through ``Model.train_batch`` for 3 steps: the losses
   agree, K1 / K2a / K2b run 2 x 3 times each, non-causal, with the
   padding bias and no dS;
25. BERT-base masked-LM pretraining (Devlin et al. 2019 widths, attention
   dropout 0, hidden dropout 0.1) at 8 x 512 (real lengths 128-512, 15 %
   of the real tokens labelled) through ``TrainStep`` + AdamW for 4 steps
   in f32 and 4 under ``auto_cast`` O1: the loss falls, 12 x 4 launches of
   each kernel with the padding bias (bf16 under O1), the first O1 loss
   within ``AMP_LOSS_RTOL`` of the f32 one;
26. K1, K2a + K2b at the encoders' shapes (ERNIE B=32 T=128, BERT B=8
   T=512; H=12, D=64, non-causal, padding bias; f32 and bf16), each
   checked against its plain version and timed beside it, SDPA under the
   same additive mask and the bound;
27. ResNet-50 (He et al. 2016, Table 1: 1000 classes; 224 x 224, batch
   256, random weights from the seed) trained in f32 through
   ``TrainStep`` + ``Momentum(0.1, 0.9, weight decay 1e-4)`` (the repo's
   benchmark recipe, its rate ramped linearly from 0.01 over the 12
   steps) on one fixed batch: step ms (steps 3
   on), images/s against the f32 bound, peak memory, the device's idle
   share (kernel time over two profiled steps against the step); the loss
   falls, every BN buffer is finite and has moved;
28. the same under ``auto_cast`` O1 and after ``decorate(level="O2")``
   with ``multi_precision``: a spy on ``torch.nn.functional.conv2d`` /
   ``batch_norm`` sees 53 convs in bf16 and 53 batch norms in f32 a step,
   the first O1 loss is within ``AMP_LOSS_RTOL`` of phase 27's, the
   losses fall; images/s against the bf16 bound;
29. ResNet-50 through ``paddle.Model``: ``fit`` 8 steps over ``FakeData``
   (256 x 256 images) through ``RandomResizedCrop(224)``,
   ``RandomHorizontalFlip``, ``ToTensor``, ``Normalize`` and a
   ``DataLoader`` of worker processes, with ``Momentum`` under a
   ``PiecewiseDecay`` and top-1 / top-5 ``Accuracy``; the rate batches
   arrive at beside phase 27's step rate; ``evaluate`` and ``predict``
   over 4 batches through ``Resize(256)``, ``CenterCrop(224)``;
   ``summary`` counts 25,557,032 parameters; ``save`` then ``load`` into a
   fresh model gives the same eval logits and BN buffers;
30. card against CPU from the same weights: ResNet-50 (10 classes, 64 x
   64, batch 8) eval and train logits, the BN buffers, one Momentum
   step's parameters; a sweep of ``conv2d`` / ``conv2d_transpose`` /
   ``max_pool2d`` / ``avg_pool2d`` through the explicit-padding routes,
   forward and gradient;
31. (A) generation on GPT-3 1.3B at full width and depth (24 layers, f32,
   random weights from the seed), 4 prompts of 128 tokens, 64 new tokens,
   through three routes: ``model.generate`` (KV-cached: K1 launches 24
   times, at the prefill; the decode steps attend through
   ``F.decode_attention``), ``text.generation.generate(use_engine=False)``
   (the pow2-bucket loop of full forwards: 24 x 64 K1 launches) and
   ``generate`` after ``inference.enable_decode_engine`` (f32 KV: K3's
   launches per regime as phase 4 checks them, no K1); the three greedy
   streams equal, and a sampled run (top-k 50, top-p 0.9, T 0.8, fixed
   seed) equal on the cached and loop routes; tokens/s per route;
32. (B) the same on Llama-3-8B at full width and depth (32 layers, 32 / 8
   heads; f32 KV on the engine route, as phase 13 gives the reason for),
   2 prompts of 64 tokens, 32 new: the cached prefill runs K1 on GQA
   inputs;
33. (C) ``generate_padded`` and ``beam_search`` (4 beams) at depth 2 on
   both models: K1 launches 2 layers x forwards, each stream equal to the
   same call's on the plain attention;
34. (D) the body of ``examples/train_vision_hapi.py`` on the port on the
   default device (the card): fit, evaluate, predict, summary, finite
   logits, every parameter on the card; ``paddle.to_tensor`` on the card,
   and on the CPU after ``set_device("cpu")`` (restored after);
35. the tensor API on the card: every case of the CPU sweep
   (``tests/tensor_api_cases.py``) run on CUDA inputs and on CPU copies,
   dtypes equal, integers and bools exact, floats within the sweep's
   tolerance; creation without a device lands on the card; each random
   function's draw repeats after ``paddle.seed``;
36. a causal LM written as a ``paddle.nn.Layer`` subclass over the public
   API (``create_parameter`` for the position table, ``LayerList``,
   ``Embedding`` / ``Linear`` / ``LayerNorm``, ``paddle.split`` of a
   fused QKV, ``reshape``, ``transpose``, ``concat``, ``gather``,
   ``F.scaled_dot_product_attention(is_causal=True)`` in Paddle's
   ``[B, T, H, D]`` layout, ``F.gelu``, ``F.cross_entropy``) at GPT-3
   1.3B's widths and depth (hidden 2048, 16 heads, FFN 8192, vocab 50304,
   24 pre-LN layers, tied head), trained through ``TrainStep`` + ``AdamW``
   for 4 steps on 2 x 2048 tokens in f32: K1, K2a and K2b each launched
   24 x 4 times, causal, every loss finite; step ms, tokens/s, peak
   memory, the device's idle share;
37. the same class at depth 2 through ``paddle.Model`` (``fit`` and
   ``evaluate``, 4 batches each), ``save`` then ``set_state_dict`` into a
   fresh model (bit-equal, ``([], [])``), forward pre / post hooks (once
   a call, none after ``remove()``), and the card against the CPU on the
   same weights and a 1 x 256 batch: the loss and every parameter's
   gradient within phase 30's rule;
38. hybrid-parallel training through ``paddle.distributed`` at NCCL world
   size 1: ``init_parallel_env`` on a ``file://`` store (NCCL, the default
   device being the card), ``fleet.init`` -> ``distributed_model`` ->
   ``distributed_optimizer`` -> ``DistTrainStep``, GPT-3 1.3B at full
   width and depth for 4 steps on phase 7's batch and AdamW: K1 / K2a /
   K2b 24 x 4 launches each, the gradient all-reduces counted, step ms
   beside phase 7's; then a depth-2 ``DistTrainStep`` and ``TrainStep``
   from the same weights for 3 steps: losses and parameters bit-equal;
39. two processes on the one card over gloo (``backend="gloo"`` given):
   GPT-3 1.3B's widths at depth 2 in three configurations, mp 2 with
   sequence parallelism, dp 2 and sharding 2 (ZeRO-1), 3 AdamW steps on
   the global 2 x 2048 batch each, against a single-process ``TrainStep``
   on the same full weights (losses within ``TRAIN_LOSS_RTOL``, gathered
   parameters within phase 8's rule, the mp ranks' replicated parameters
   bit-equal); each rank's K1 / K2a / K2b launches at H = 8 (mp) or 16;
40. ``fold_layers=True``: GPT-3 1.3B (24 layers) folded through
   ``TrainStep`` for 3 steps on phase 7's weights and batch, its losses
   against phase 7's (bit-equal, else within ``TRAIN_LOSS_RTOL``), its
   parameters against an unfolded ``TrainStep``'s by phase 8's rule, K1 /
   K2a / K2b 24 x 3 launches, step ms beside phase 7's;
41. pipeline parallelism at pp 2, two processes on the one card over gloo
   (point to point staged through pinned host buffers): GPT-3 1.3B at 12
   layers under 1F1B with 4 micro-batches of 1 x 1024, then gpipe,
   zero-bubble and interleaved 1F1B (V = 2) at depth 4, 3 steps each
   through ``fleet.init`` -> ``distributed_model`` ->
   ``distributed_optimizer`` -> ``DistTrainStep`` against a
   single-process ``TrainStep`` on the same weights and batch (losses
   within ``TRAIN_LOSS_RTOL``, gathered parameters by phase 8's rule, the
   replicated parameters bit-equal on both ranks); each rank's K1 / K2a /
   K2b launches (72 at 12 layers), the staged bytes equal to the chunk
   boundaries' activations and cotangents, the replicated gradients summed
   once a step, ``schedule_info``'s bubble fractions beside the step ms;
42. the sep axis, two processes on the one card over gloo: (a) the ring
   at GPT-3 1.3B's attention shape (B 2, T 2048, H 16, D 128, causal) at
   sep 2, f32 and bf16, on the kernels (K1 per visible block, K2a / K2b
   with the merged lse) against the plain ring on the same blocks in f32,
   forward and the three gradients, and the gathered output against K1
   on the whole sequence; (b) GPT-3 1.3B at 24 layers at sep 2 through
   ``DistTrainStep`` for 3 steps on phase 7's weights and batch, its
   losses against phase 7's within ``TRAIN_LOSS_RTOL``, each rank's K1 /
   K2a / K2b launches (24 x 3 x its ring blocks: 1 on rank 0, 2 on rank
   1), its staged bytes equal to the K/V arithmetic, step ms and peak;
43. expert parallelism: Mixtral 8x7B's MoE block on the capacity path
   at EP 2 (over sharding, 4 experts a rank) on the same two processes,
   3 steps through ``DistTrainStep`` against a single-process
   ``TrainStep`` on the same weights and batch: losses within
   ``TRAIN_LOSS_RTOL``, each rank's expert slice by phase 8's rule, the
   ``global_scatter`` / ``global_gather`` bytes equal to the ``[E, C,
   h]`` arithmetic, step ms and peak;
44. ZeRO-3 (``sharding_configs["stage"] = 3``): GPT-3 1.3B at 24 layers
   at sharding 2 on two gloo processes for 3 steps against phase 7's
   losses and a single-process ``TrainStep``'s parameters, each rank's
   K1 / K2a / K2b launches, the bytes its forward gathers and its
   backward reduce-scatters against the arithmetic, the parameter bytes
   it holds;
45. the quantized gradient wire (bf16, int8 + error feedback) at dp 2 and
   the int8 mp wire at mp 2 at depth 2 against the exact exchange, the
   wire bytes against the arithmetic; gradient merge over 4 micro-batches
   against ``TrainStep`` on the whole batch;
46. ZeRO-3 and the sep axis inside the pipeline: GPT-3 6.7B's widths
   (hidden 4096, 32 heads, ffn 16384, vocab 50304) at depth 2 on four
   gloo processes sharing the card, a 4 x 2048 batch in 2 micro-batches
   a rank under 1F1B, after a single-process ``TrainStep`` baseline: (a)
   pp 2 x
   sharding 2 at stage 3 in f32, 3 steps, losses and gathered parameters
   against the baseline, the ZeRO-3 bytes gathered, gathered again and
   reduce-scattered and the staged bytes against the arithmetic; (b) the
   same at the reference's knobs (bf16 parameters, block recompute), 2
   steps, the loss finite and falling; (c) pp 2 x sep 2 in f32, 2 steps,
   losses against the baseline, each sep rank's ring launches, the staged
   bytes equal to the boundaries and the ring's rotations; (c) again on
   the ring's plain version (the probe of ROADMAP §C, "Suspects"), its
   distance to the baseline beside the kernels'; each rank's step ms and
   peak;
47. the training features of ROADMAP §A.3 through fleet: (a) BERT-base
   MLM (phase 25's model, batch and AdamW) made Lamb by
   ``strategy.lamb``, 4 ``DistTrainStep`` s at NCCL world size 1: the
   loss falls, K1 / K2a / K2b 12 x 4 with the padding bias, the first
   update against the port's CPU Lamb on the card's parameters and
   gradients, the state keys Lamb's; (b) ResNet-50 (256 x 224, f32) made
   Lars by ``strategy.lars``, 3 steps, the first update against the CPU
   Lars; (c) GPT-3 1.3B's widths at depth 2, mp 2 under Lamb on two
   gloo processes sharing the card, against a single-process Lamb run:
   phase 39's gates and each trust ratio's sums of squares equal to the
   whole parameter's; (d) ``flash_attn_unpadded`` on five packed causal
   sequences (2048 + 1024 + 512 + 384 + 128) and 64 padding tokens at
   H=16, D=128, f32 and bf16: one K1 / K2a / K2b launch each, against
   the plain versions, the tail's rows 0, timed beside the sequences
   padded to 5 x 2048, SDPA with the bool mask and the bounds of the
   square and of the needed work; each with its step ms, peak and
   launches;
48. the auto-parallel API and restore-anywhere checkpoints, after a
   single-process ``TrainStep`` baseline of the same depth: (a) GPT-3
   1.3B's widths at depth 4 built whole and ``parallelize`` d at mp 2
   (ColWise ``qkv_proj`` / ``fc_in``, RowWise ``out_proj`` / ``fc_out``)
   on two gloo processes sharing the card, 4 steps of a plain
   ``TrainStep`` (phase 7's AdamW and clip) at 2 x 2048: losses within
   ``TRAIN_LOSS_RTOL`` of the baseline, K1 / K2a / K2b 4 x 4 a rank at
   H = 8, step ms, the parameter bytes a rank holds against the
   arithmetic; (b) ``save_state_dict(canonical_state_dict(...))`` after
   step 2, restored into one process unsplit for steps 3-4: losses within
   ``TRAIN_LOSS_RTOL`` of the uninterrupted run, ``verify_checkpoint(deep=
   True)``, the bytes each rank wrote against the arithmetic, save and
   restore seconds, the restore's growth against the largest leaf and
   one full copy; (c) ``reshard_array`` of the [50304, 2048] f32
   embedding Shard(0) -> Shard(1) -> Replicate -> Shard(0) on the two
   ranks: values equal, ``reshard_moved_bytes`` the plan's, each rank's
   peak growth within 5 % of the plan's ``peak_bytes``;
49. the serving tier (``paddle_tpu_torch.serving``) over the paged-KV
   engine: GPT-3 1.3B at full width and depth from the worker CLI's
   arguments, bf16 KV, ``engine_config()``'s geometry at 4 slots a
   worker, ``make_prompts``' 8 requests, every other one sampled (T 0.7,
   top-k 8): (a) two unified ``EngineWorker`` s and a ``Router`` on the
   streaming dataplane in this process: both get work, the prefix pair
   lands on one, K3's launches by regime equal ``k3_expected`` over both
   engines, every stream equal to one ``DecodeEngine`` fed the same
   requests and the router's params (or parting at a near-tie, top-2
   decision margin below 1e-3); tokens/s beside the single engine's;
   (b) a prefill and a decode worker (threads), the 300-600-token prompts
   disaggregated: on the ``raw`` KV wire the streams equal (a)'s, on the
   ``int8`` wire the payload bytes equal the arithmetic (about half of
   raw), the first token exact and >= 75 % of the tokens equal; export,
   encode, wire, decode and import seconds, bytes a prompt token; (c) two
   ``python -m paddle_tpu_torch.serving.worker --device cuda`` processes,
   the one that acks the first done SIGKILLed: every request done once
   (``dispatched`` = requests + ``failover_resubmits``), streams equal
   (a)'s, both workers' status lines on the card with nonzero K3 launches
   and this process's float32 matmul settings;
50. the MPMD pipeline (``distributed.mpmd``) at GPT-3 1.3B's widths: 4
   decoder blocks of an ``SpmdPipeline`` under a final LayerNorm and an
   untied ``Linear(2048, 50304)`` head with cross entropy, hidden states
   [8, 1024, 2048] from the seed, 2 stages, M = 4, 3 AdamW steps from the
   same weights: the unpipelined fold, 1F1B over a local boundary, 1F1B
   over a TCP boundary on the ``raw`` wire, gpipe, widths (2, 1) on a
   device list repeating the card, and 1F1B's stage shards of step 1
   restored into fresh state for steps 2-3: losses within 1e-5 of the
   fold's, TCP and the restore bit-equal to the local run,
   ``resize_stage(1, 2)`` leaving stage 0's builds, K1 / K2a / K2b launches
   equal to the stages' count (``bwd`` recomputes: K1 twice a layer on
   stage 0); parameters' max |d| against the fold, step ms, boundary bytes;
51. ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
   --max_restarts 1 --heartbeat_interval 1`` running this script's
   ``--elastic-worker`` (GPT-3 1.3B's widths at depth 2, dp 2 over gloo on
   the card, AdamW, ``ElasticManager(save_interval=2)``, 3 steps) twice:
   clean, and with rank 1 SIGKILLed at step 2 (``chaos.step_fence``): the
   launcher relaunches both ranks, they resume at step 2, and the final
   losses and parameters equal the clean run's bit for bit; the watchdog
   beat on every rank and declared no stall; saves, resumes and the
   relaunch timed;
52. a ``ShardedEmbeddingTable`` of 1,048,576 x 128 f32, whole on the card,
   then split over two gloo ranks sharing it: 8 x 4096 ids, forward,
   backward, one SGD step; the output and updated rows bit-equal;
54. the rest of §A.7, part 1, on two gloo ranks sharing the card after
   single-process baselines: (a) GPT-3 1.3B's widths at depth 4 and
   Llama-3-8B's at depth 2, built whole, served through
   ``EngineConfig(mesh=...)`` at mp 2 (each rank's pool at ``Hkv / 2``
   heads, K3 over them): make_prompts' 8 greedy requests with prefix
   sharing and speculation equal to the mp-1 engine's (or parting at a
   near-tie) and on both ranks, K3's launches a rank by regime equal to
   ``k3_expected``, the f32 and int8 logit wires' bytes equal to
   ``logit_wire_bytes``, tokens/s beside mp 1; (b) the masked ring at sep
   2 (B 2, T 2048, H 16, D 128) under a key padding mask and a causal
   [B, 1, T, T] bias: K1 / K2a / K2b against the plain ring and both
   against a float64 oracle within 1e-4; BERT-base with its padding mask
   for 3 steps through ``DistTrainStep`` at sep 2 against ``TrainStep``;
   (c) ERNIE-3.0's widths at depth 4 through ``paddle.Model`` at dp 2
   against one process, ``comm_traffic``'s gradient bytes against the
   parameters' and its bf16-wire quantized fraction;
56. a ``decorate``d O2 bf16 model, MoE under O2 and online weights: (a)
   K3 on a bf16 query against its plain version at GPT-3 1.3B's and
   Llama-3-8B's serving shapes, each pool dtype, and timed beside the
   f32 query; (b) phase 4's GPT-3 1.3B decorated, served with bf16 and
   int8 KV and speculation (K3 launches by regime, every K3 call held
   against the plain version on the engine's inputs, streams against the
   plain engine with each parting's margin, the logit gap at identical
   contexts, tokens/s and pool bytes beside phase 4's), and Llama-3-8B
   decorated at depth 2; (c) phase 11's Mixtral block decorated O2 for 3
   steps, K4a / K4b in bf16 on the model path, losses against the plain
   grouped matmul; (d) an ``OnlineCoordinator`` flip of two decoder
   layers of the decorated 1.3B to an in-process engine and a worker
   process while requests decode: in-flight streams on epoch 0, new ones
   on epoch 1, the bytes streamed; (e) ``amp.debugging``'s operator
   stats over one O2 step and its checker on an injected ``inf``;
57. the front tier, the replay, the profiler and the host runtime: (a)
   GPT-3 1.3B (phase 49's worker model and engine config) behind a
   ``FrontierRouter(seed=9)`` over one leaf of two workers, then two
   leaves of one: each request on its tenant's first rendezvous leaf,
   streams equal across the tiers (near-ties as phase 49), K3 launches
   by regime, a capped tenant's request shed at the front and charged to
   its ledger row, tokens/s beside 49a's; (b) ``serving.replay``'s stub
   tier on the card's host: 20,000 requests of the ``mixed`` stream with
   an abuser under quotas, twice with one digest, every request
   resolved, the stores reaped, two shard processes serving exactly
   their rendezvous shares, ``dispatch_rps``; (c) ``paddle.profiler``
   over 8 steps of phase 4's engine: K3's kernels on the device timeline
   as many as the wrapper counted, the ``RecordEvent`` spans in the
   device and host traces, the device's idle share of the window; (d)
   the native host runtime loaded, ``stack_samples`` against ``np.stack``
   on phase 23's batch, ERNIE's ``fit`` for 2 steps with telemetry (one
   ``train_step`` event and one ``VisualDL`` row a batch and key);
   ``--phase57`` runs it alone (after phase 2);
58. the deployment path, on random weights from the seed: (a) phase 23's
   ERNIE-3.0-base classifier through ``jit.save`` (``None`` dims for the
   ids, token types and mask) and ``inference.create_predictor`` on the
   card, one artifact at B=32 T=128 and B=8 T=64: logits within rel 1e-5
   of the eager model, 12 K1 launches a run, the same artifact under
   ``Config.disable_gpu()`` on a B=2 T=32 batch within 1e-4 of the card
   (on the CPU's dense route and on K1's plain version), the export /
   save / load seconds, the bytes, the predictor's and eager's ms a batch
   at B=32 T=128; (b) GPT-3 1.3B's widths at depth 2 saved once and run
   through ``jit.load``'s ``TranslatedLayer`` at (2, 512) and (1, 1024):
   logits within rel 1e-5 of eager, K1 twice a call, the files removed;
   (c) ``jit.to_static`` on that GPT: outputs equal to eager,
   ``program_cache_size`` 2 after the two signatures, one training step's
   loss and gradients as the eager step's; ``--phase58`` runs it alone
   (after phase 2);
59. an ``amp`` JSON line (phases 18-21), an ``encoders`` JSON line (phases
   23-26), a ``vision`` JSON line (phases 27-30), a ``generation`` JSON
   line (phases 31-34), a ``layer`` JSON line (phases 35-37), a
   ``distributed`` JSON line (phases 38-39), a ``pipeline`` JSON line
   (phases 40-41), a ``sep_ep`` JSON line (phases 42-43), a
   ``zero3_wires`` JSON line (phases 44-45), a ``pp_compose`` JSON line
   (phase 46), an ``a3`` JSON line (phase 47), an ``auto_parallel`` JSON
   line (phase 48), a ``serving`` JSON line (phase 49), an
   ``mpmd_elastic_ps`` JSON line (phases 50-52), an ``mp_sep_hapi`` JSON
   line (phase 54), a ``phase55``, a ``phase56``, a ``phase57`` and a
   ``phase58`` JSON line, a ``kernels`` JSON line
   (the GPT, encoder and MoE shapes, the K1 / K2 rows with their launches
   in phases 38-48, 50-51 and 54 (``launches_mpmd``, ``launches_elastic``,
   ``launches_mp_sep_hapi``), the K3 rows with phase 49's as
   ``launches_serving`` and 54a's as ``launches_mp_serving``, 56a's
   bf16-query times and 56b's launches, 57a's and 57c's as
   ``launches_phase57``, the 1.3B K1 / K2 rows with phase 58's as
   ``launches_phase58``, the K4 rows with 56c's bf16
   launches as ``launches_o2_bf16``; no TPU
   kernel lies on the vision path, the capacity MoE path or phase 52's
   table), then the result line.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

DEVICE = "cuda"
SEED = 1234
NEW_TOKENS = 32
KERNEL_ATOL = 1e-4    # f32 accumulation on identical stored inputs
# per-step logits (|logit| ~5) at depth 2, kernel vs plain engine: with
# f32 KV only the attention's summation order differs; with int8 KV the
# layer-2 K/V are quantized from layer-1 outputs that differ by ulps, so
# an element can land one int8 level (scale / 127) apart
ENGINE_LOGIT_ATOL = {"f32": 1e-4, "int8": 1e-3}
PROMPT_LENGTHS = (17, 40, 90, 150, 300, 350, 480, 600)
SHARED_PREFIX = 256
# published peaks (NVIDIA data sheets, dense): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, TF32 and bf16 tensor-core FLOP/s
CARD_PEAKS = {
    "SXM": dict(bw=3.35e12, f32=67e12, tf32=495e12, bf16=989e12),
    "PCIe": dict(bw=2.0e12, f32=51e12, tf32=378e12, bf16=756e12),
    "NVL": dict(bw=3.9e12, f32=60e12, tf32=417.5e12, bf16=835e12),
}
# TF32 products per f32-accurate product on the tensor cores: both
# operands f32 (hi.hi + hi.lo + lo.hi), or one exact in TF32 (a bf16 or
# int8 value: hi.b + lo.b)
TF32_PASSES = {"f32": 3, "f32x": 2}
# flash kernels vs plain, as max|err| / max|ref|. f32: both accumulate in
# f32 in different orders. bf16 o and dq are stored in bf16 (one ulp =
# 2^-8 relative), and the kernel rounds P to bf16 against the running row
# max where the plain version uses the final one: two ulps. lse, dS and
# the f32 per-query-head dK / dV keep the f32 tolerance in both dtypes.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
# GPT-3 (Brown et al. 2020): Table 2.1 lr for 1.3B, Appendix B AdamW
ADAMW = dict(learning_rate=2e-4, beta1=0.9, beta2=0.95, epsilon=1e-8,
             weight_decay=0.1)
# first full-width loss, kernel vs plain attention: f32 through 24 layers,
# only the attention's summation order differs; the loss (~ln 50304) is a
# mean over 4096 tokens
TRAIN_LOSS_RTOL = 2e-5
LOCKSTEP_STEPS = 3
# lockstep parameters: Adam moves an element by about lr * sign(g), so an
# element whose gradient is float noise on both sides (the key bias: its
# exact gradient is 0) can drift by up to 2 * lr per step; all elements
# must stay within that, and all but 1 % within LOCKSTEP_PARAM_ATOL
# (0.2 % of the 3-step move 3 * lr)
LOCKSTEP_PARAM_ATOL = 1e-6
# Mixtral 8x7B's MoE block (Jiang et al. 2024, arXiv:2401.04088, Table 1):
# dim, hidden_dim, experts, top-k. The expert is the repo's MoELayer FFN
# (GELU, with biases), not Mixtral's SwiGLU.
MOE_DIM, MOE_HIDDEN, MOE_EXPERTS, MOE_TOP_K = 4096, 14336, 8, 2
MOE_LOCKSTEP_DIMS = (1024, 3584)
# the MoE runs take phase 7's AdamW and clip with a smaller step: the
# reference's XavierNormal gives the stacked expert weights [8, 4096,
# 14336] conv-layout fans and a std of 1.8e-4, below one Adam step at lr
# 2e-4, and at that lr the loss fell once and then diverged on the card
# (1.05, 0.93, 8.38, 13.53); 1e-5 moves each weight ~5 % of its std a step
MOE_ADAMW = dict(ADAMW, learning_rate=1e-5)
# grouped matmul kernel vs plain, as max|err| / max|ref|: f32 sums of up
# to 14336 products in another order than cuBLAS (TF32 off); a bf16
# output is stored in bf16 (one ulp = 2^-8 relative); drhs leaves in f32
# in both dtypes and keeps the f32 tolerance
GMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# first MoE loss, kernel vs plain grouped matmul: only the expert
# products' summation order differs, and the MoE output is ~1e-4 of the
# ~1.0 MSE, so the loss agrees far inside f32 rounding of its value
MOE_LOSS_RTOL = 1e-6
# lockstep step-1 gradients, max|err| / max|grad| per parameter: f32 sums
# of up to 4096 products in other orders (the gate's gradient flows
# through the expert outputs)
MOE_GRAD_RTOL = 1e-4
# Llama-3-8B: the published config.json of meta-llama/Meta-Llama-3-8B
# (Dubey et al. 2024, arXiv:2407.21783, Table 3: the same layers, widths,
# heads and RoPE theta). G = 32 / 8 = 4 query heads per kv head.
LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=8, max_position_embeddings=8192,
                 rms_norm_eps=1e-5, rope_theta=500000.0,
                 tie_word_embeddings=False)
# training keeps every width and cuts the depth: f32 weights, gradients
# and two Adam moments take 16 B a parameter, 128 GB at 32 layers; 4
# layers and the untied embeddings / head hold 1.92 B parameters (30.8 GB)
LLAMA_TRAIN_LAYERS = 4
# Touvron et al. 2023 (arXiv:2307.09288, section 2.2): AdamW beta1 0.9,
# beta2 0.95, eps 1e-5, weight decay 0.1, clip 1.0; lr 3e-4 (Dubey et al.
# 2024's peak for 8B), held constant
LLAMA_ADAMW = dict(learning_rate=3e-4, beta1=0.9, beta2=0.95, epsilon=1e-5,
                   weight_decay=0.1)
# AMP (phases 18-22). bf16 keeps 8 significant bits: unit roundoff 2^-8.
BF16_U = 2.0 ** -8
# first bf16 (O1) loss against the f32 run's on the same weights and batch:
# the reference's CE runs in bf16 (parallel_cross_entropy is on neither
# list), so four roundings happen at the loss's own scale, each within
# 2^-8 of it: the logits, the log-sum-exp, the log-probabilities and the
# mean; the body's bf16 roundings move single logits, which the mean over
# 4096 tokens averages
AMP_LOSS_RTOL = 4 * BF16_U
# GPT-3's schedule (Brown et al. 2020, Appendix B): linear warmup, then
# cosine decay to 10 % of the peak; here over a few steps: warmup 2 steps
# from 10 %, the cosine over 1000
WARMUP_STEPS, COSINE_STEPS = 2, 1000
# depth-2 lockstep under O1, kernel vs plain attention: the loss is stored
# in bf16 (one ulp is 2^-7 of it at most), and the kernels' outputs differ
# from the plain versions' by up to two bf16 ulps (FLASH_TOL), far below
# one ulp of the mean over 4096 tokens: the loss may differ in its last bit
AMP_LOCKSTEP_LOSS_RTOL = 2 * BF16_U
# step-1 gradients, max|err| / max|grad| per parameter: two ulps (4 u)
# from the kernels' bf16 outputs, and one ulp (2 u) for each bf16 rounding
# between them and a weight gradient at depth 2 (the dX product of the
# layer above, the dW product, its cast): 10 u, rounded up to 16 u
AMP_GRAD_RTOL = 16 * BF16_U


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def card_peaks(name: str):
    """The published peaks of the card named (``form`` = its form factor)."""
    for form in ("PCIe", "NVL"):
        if form in name:
            return dict(CARD_PEAKS[form], form=form)
    return dict(CARD_PEAKS["SXM"], form="SXM")


def bounds(nbytes, flops, kind, peaks):
    """The least time for a call that moves ``nbytes`` and does ``flops``
    (2 per multiply-add) of ``kind``: ``"f32"`` (f32 x f32), ``"f32x"``
    (f32 x a value exact in TF32) or ``"bf16"``. Two bounds: on f32 FMAs
    (67 TFLOP/s; bf16 at its tensor-core peak), and on tensor cores (the
    f32-accurate products as TF32_PASSES TF32 products at 495 TFLOP/s,
    bf16 at 989), each the larger of the bytes' and the operations' time.
    ``bound_ms`` is the tensor-core bound, the least time of the two: a
    kernel's share of it cannot pass 100 %."""
    t_bytes = nbytes / peaks["bw"] * 1e3
    if kind == "bf16":
        t_fma = t_tc = flops / peaks["bf16"] * 1e3
    else:
        t_fma = flops / peaks["f32"] * 1e3
        t_tc = flops * TF32_PASSES[kind] / peaks["tf32"] * 1e3
    return dict(bound_ms=max(t_bytes, t_tc),
                bound_by="bytes" if t_bytes >= t_tc else "operations",
                bound_fma_ms=max(t_bytes, t_fma),
                bound_fma_by="bytes" if t_bytes >= t_fma else "operations")


def bound_text(row, ms):
    """The two bounds of a row and the kernel's share of the least."""
    return (f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, tensor "
            f"cores), {row['bound_fma_ms']:.4f} ms ({row['bound_fma_by']}, "
            f"f32 FMA), {100 * row['bound_ms'] / ms:.1f} % of bound")


def cuda_ms(fn, iters=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters=20, reps=5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's cost of issuing them (a Python
    wrapper's checks and allocations) drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / (iters * reps)


# -- phase 3 helpers ---------------------------------------------------------


def make_case(rng, *, s, t, hkv, group, d, kv, ctx=None, p=16, mp=64,
              layers=1):
    """Random paged case on the card: ragged contexts (or the given ones),
    unused table entries on the trash page 0, ``layers`` independent pool
    copies (to time with a cold L2)."""
    dev = DEVICE
    h = hkv * group
    n = 1 + s * mp
    if ctx is None:
        ctx = rng.integers(t, mp * p + 1, size=s)
    ctx = np.asarray(ctx)
    table = np.zeros((s, mp), np.int32)
    perm = rng.permutation(np.arange(1, n))
    nxt = 0
    for i in range(s):
        used = -(-int(ctx[i]) // p)
        table[i, :used] = perm[nxt:nxt + used]
        nxt += used
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q = torch.randn((s, t, h, d), generator=g, device=dev)
    shape = (layers, n, hkv, p, d)
    if kv == "int8":
        kp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        ks = 0.005 + 0.025 * torch.rand(shape[:-1], generator=g, device=dev)
        vs = 0.005 + 0.025 * torch.rand(shape[:-1], generator=g, device=dev)
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        kp = torch.randn(shape, generator=g, device=dev).to(dt)
        vp = torch.randn(shape, generator=g, device=dev).to(dt)
        ks = vs = None
    return dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs,
                table=torch.as_tensor(table, device=dev),
                start=torch.as_tensor((ctx - t).astype(np.int32),
                                      device=dev), ctx=ctx, p=p)


def case_args(c, layer=0):
    pick = lambda x: None if x is None else x[layer]  # noqa: E731
    return ((c["q"], c["kp"][layer], c["vp"][layer], c["table"],
             c["start"]), dict(k_scales=pick(c["ks"]), v_scales=pick(c["vs"])))


def gathered_for_library(c):
    """Dense K/V per query head [S, H, K, D] in the query's dtype and a
    bool mask [S, 1, T, K] for scaled_dot_product_attention (the
    yardstick)."""
    q, kp, vp, ks, vs, table, start = (c["q"], c["kp"][0], c["vp"][0],
                                       c["ks"], c["vs"], c["table"],
                                       c["start"])
    s, t, h, d = q.shape
    hkv, p = kp.shape[1], kp.shape[2]
    kf, vf = kp.float(), vp.float()
    if ks is not None:
        kf, vf = kf * ks[0][..., None], vf * vs[0][..., None]
    k_len = int(c["ctx"].max())

    def gather(pool):
        g = pool[table.long()].transpose(1, 2).reshape(
            s, hkv, -1, d)[:, :, :k_len]
        return g.repeat_interleave(h // hkv, dim=1).to(q.dtype).contiguous()

    qpos = start.long()[:, None] + torch.arange(t, device=DEVICE)[None]
    mask = (torch.arange(k_len, device=DEVICE)[None, None]
            <= qpos[:, :, None])[:, None]
    return (q.transpose(1, 2).contiguous(), gather(kf), gather(vf), mask)


def bound(c, peaks):
    """:func:`bounds` of this call: each input byte the call needs read
    once (the live keys of each slot, not whole page slots), the output
    written once; QK and PV f32-accurate, with one operand exact in TF32
    unless the pool is f32."""
    q, kp = c["q"], c["kp"]
    s, t, h, d = q.shape
    hkv, p = kp.shape[2], c["p"]
    group = h // hkv
    start = c["start"].cpu().numpy().astype(np.int64)
    keys = start + t  # keys visible to the slot's last row
    per_key = 2 * hkv * d * kp.element_size()
    if c["ks"] is not None:
        per_key += 2 * hkv * 4
    nbytes = (int(keys.sum()) * per_key + 2 * q.numel() * q.element_size()
              + int((-(-keys // p)).sum()) * 4 + s * 4)
    # row t of slot i sees start + t + 1 keys; QK and PV: 2 FLOPs each
    seen = (start[:, None] + np.arange(t)[None] + 1).sum()
    flops = 4 * int(seen) * group * hkv * d
    kind = "f32" if kp.dtype == torch.float32 else "f32x"
    return bounds(nbytes, flops, kind, peaks)


K3_COUNTERS = ("launches", "launches_tile", "launches_split",
               "launches_decode", "launches_verify")


def k3_counts(pa):
    return tuple(getattr(pa, n) for n in K3_COUNTERS)


def checked_call(pa, args, kw, expect, tag):
    """paged_attention(*args, **kw), raising unless exactly one launch of
    the ``expect`` regime (and, in the split regime, of the decode or the
    verify count by T) was counted."""
    before = k3_counts(pa)
    got = pa.paged_attention(*args, **kw)
    moved = tuple(a - b for a, b in zip(k3_counts(pa), before))
    t = args[0].shape[1]
    want = ((1, 1, 0, 0, 0) if expect == "tile" else
            (1, 0, 1, int(t == 1), int(t > 1)))
    if moved != want:
        raise AssertionError(f"{tag}: launches {K3_COUNTERS} moved by "
                             f"{moved}, expected {want}")
    return got


def phase_kernel_sweep(pa, atol=KERNEL_ATOL):
    """Every case against the plain version; raises past ``atol``.
    Returns the worst max|err| of each regime."""
    rng = np.random.default_rng(SEED)
    worst = {"tile": 0.0, "split": 0.0}
    log("# phase 3: kernel vs plain (P=16, MP=64, Hkv=4, atol "
        f"{atol})")
    cases = [dict(s=s, t=t, group=group, d=d)
             for s, t in ((8, 1), (8, 5), (1, 256))
             for group in (1, 4) for d in (64, 128)]
    # tail prefills: a whole 1024-token bucket from position 0, and 200
    # tokens (not a multiple of the 64-row tile) after a 256-token prefix
    cases += [dict(s=1, t=1024, group=1, d=128, ctx=[1024]),
              dict(s=1, t=200, group=1, d=128, ctx=[456])]
    for kv in ("f32", "bf16", "int8"):
        for case in cases:
            c = make_case(rng, hkv=4, kv=kv, **case)
            args, kw = case_args(c)
            expect = pa._k3_regime(case["t"], case["group"])
            tag = (f"kv={kv:4s} S={case['s']} T={case['t']:4d} "
                   f"start={int(c['start'].min().item()):4d} "
                   f"G={case['group']} D={case['d']:3d} {expect:5s}")
            got = checked_call(pa, args, kw, expect, tag)
            ref = pa.paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            worst[expect] = max(worst[expect], err)
            log(f"{tag} max_abs_err={err:.3e}")
            if not err <= atol:
                raise AssertionError(
                    f"kernel disagrees with plain: {err} > {atol}")
    return worst


def k3_bf16_tol(ref):
    """K3 with a bf16 query against its plain version: both accumulate in
    f32 (KERNEL_ATOL apart, as phase 3) and round the output to bf16 once,
    so two results may sit one bf16 spacing apart: 2^-7 of the value."""
    return KERNEL_ATOL + 2.0 ** -7 * ref.float().abs().max().item()


def time_main_shapes(pa, peaks, contexts, hkv=16, group=1,
                     q_dtype=torch.float32):
    """The kernel at a serving path's shapes (GPT-3 1.3B: H=Hkv=16;
    Llama-3-8B: Hkv=8, G=4; D=128, bf16 pool, P=16, MP=64): decode (S=8,
    T=1), verify (S=8, T=5) and the 600-token prompt's tail prefill (S=1,
    T=1024 bucket), each in the regime ``_k3_regime`` picks (verify: split
    at G=1, tile at G=4). Four pool copies are cycled so each
    launch finds a cold L2. The kernel and the library call are timed in
    turns (kernel, library, plain, library, kernel) and averaged, each as
    device time (:func:`graph_ms`: ``ms``, ``library_ms``, ``plain_ms``)
    and as a host loop of calls (:func:`cuda_ms`: ``loop_ms``,
    ``library_loop_ms``, ``plain_loop_ms``; what the engine, which runs
    without graphs, pays). ``q_dtype`` bf16 times the kernel on a bf16
    query (phase 56a), held to :func:`k3_bf16_tol`; SDPA then runs in
    bf16."""
    from torch.nn.attention import sdpa_kernel

    rng = np.random.default_rng(SEED + 1)
    shapes = {
        "decode": dict(s=8, t=1, ctx=contexts),
        "verify": dict(s=8, t=5, ctx=np.asarray(contexts) + 4),
        "prefill": dict(s=1, t=1024, ctx=[1024]),
    }
    rows = {}
    for name, sh in shapes.items():
        c = make_case(rng, hkv=hkv, group=group, d=128, kv="bf16",
                      layers=4, **sh)
        c["q"] = c["q"].to(q_dtype)
        calls = [case_args(c, layer) for layer in range(4)]
        state = {"i": 0}

        def run(fn):
            def go():
                args, kw = calls[state["i"] % 4]
                state["i"] += 1
                return fn(*args, **kw)
            return go

        expect = pa._k3_regime(sh["t"], group)
        got = checked_call(pa, *calls[0], expect, name)
        ref = pa.paged_attention_plain(*calls[0][0], **calls[0][1])
        err = (got.float() - ref.float()).abs().max().item()
        tol = KERNEL_ATOL if q_dtype == torch.float32 else k3_bf16_tol(ref)
        if got.dtype != q_dtype or not err <= tol:
            raise AssertionError(f"{name}: kernel disagrees, {err} "
                                 f"({got.dtype})")
        qh, kh, vh, mask = gathered_for_library(c)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        be = sdpa_backend(qh, kh, vh, attn_mask=mask)
        with sdpa_kernel([be]):
            def lib():
                return sdpa(qh, kh, vh, attn_mask=mask)
            kern = run(pa.paged_attention)
            plain = run(pa.paged_attention_plain)
            turns = [graph_ms(kern), graph_ms(lib)]
            loops = [cuda_ms(kern), cuda_ms(lib)]
            plain_ms, plain_loop_ms = graph_ms(plain), cuda_ms(plain)
            loops += [cuda_ms(lib), cuda_ms(kern)]
            turns += [graph_ms(lib), graph_ms(kern)]
        ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, regime=expect,
                          loop_ms=(loops[0] + loops[3]) / 2,
                          library_loop_ms=(loops[1] + loops[2]) / 2,
                          plain_loop_ms=plain_loop_ms, **bound(c, peaks))
        log(f"{name:8s} S={sh['s']} T={sh['t']:4d} Hkv={hkv} G={group} "
            f"q {str(q_dtype)[6:]} [{expect}]: kernel "
            f"{ms:.4f} ms ({turns[0]:.4f}, {turns[3]:.4f}), sdpa "
            f"[{be.name}] {library_ms:.4f} ms ({turns[1]:.4f}, "
            f"{turns[2]:.4f}), plain {plain_ms:.4f} ms; host loop: kernel "
            f"{rows[name]['loop_ms']:.4f} ms, sdpa "
            f"{rows[name]['library_loop_ms']:.4f} ms, plain "
            f"{plain_loop_ms:.4f} ms; {bound_text(rows[name], ms)}, "
            f"max_abs_err {err:.3e}")
    return rows


# -- phases 4 and 5 ----------------------------------------------------------


def make_prompts(vocab):
    """8 prompts of 17..600 tokens, periodic (period 8) so prompt-lookup
    drafts exist; prompts 4 and 5 share a 256-token prefix."""
    rng = np.random.default_rng(SEED)

    def periodic(n):
        return np.resize(rng.integers(1, vocab, 8), n)

    prompts = [periodic(n) for n in PROMPT_LENGTHS]
    shared = periodic(SHARED_PREFIX)
    for i in (4, 5):
        prompts[i] = np.concatenate(
            [shared, periodic(PROMPT_LENGTHS[i] - SHARED_PREFIX)])
    return prompts


def engine_config(**kw):
    return dict(num_slots=8, max_length=1024, page_size=16,
                speculate_k=4, spec_adaptive=False, prefix_cache=True,
                seed=SEED, device=DEVICE, **kw)


def build_model(layers, **kw):
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt3_1p3b(num_hidden_layers=layers,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0, **kw)
    return GPTForCausalLM(cfg, device=DEVICE, seed=SEED)


def build_llama(layers):
    from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM)

    cfg = LlamaConfig(**dict(LLAMA3_8B, num_hidden_layers=layers))
    return LlamaForCausalLM(cfg, device=DEVICE, seed=SEED)


def serve(engine, prompts):
    rids = [engine.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    engine.run()
    return [engine.result(r) for r in rids]


def k3_expected(pa, layers, st, eng, group):
    """K3 launches the run should count, (tile, split, decode, verify):
    layers x programs, each program in the regime ``_k3_regime`` picks
    for its rows (prefill buckets, decode T = 1, verify T = k + 1), and
    of the split ones the decode (T = 1) and verify (T > 1) counts."""
    want = dict(tile=0, split=0, decode=0, verify=0)
    progs = ((min(eng.buckets), st["prefill_calls"]),
             (1, st["decode_steps"] - st["verify_steps"]),
             (eng.config.speculate_k + 1, st["verify_steps"]))
    for t, n in progs:
        regime = pa._k3_regime(t, group)
        want[regime] += layers * n
        if regime == "split":
            want["decode" if t == 1 else "verify"] += layers * n
    return tuple(want[k] for k in ("tile", "split", "decode", "verify"))


def report_divergence(fa, model, prompts, outs, ref,
                      names=("kernel engine", "plain engine")):
    """Where two runs' streams (``names``: by default the kernel and plain
    engines) first part: the request, the token, and the top-2 logits
    (and their margin) of a full forward over the common context, once
    with K1 and once on the plain attention."""
    for i, (a, b) in enumerate(zip(outs, ref)):
        if np.array_equal(a, b):
            continue
        j = int(np.flatnonzero(np.asarray(a) != np.asarray(b))[0])
        ctx = torch.as_tensor(np.asarray(a[:j])[None], device=DEVICE)
        tops = []
        for plain in (False, True):
            with (plain_attention(fa) if plain else contextlib.nullcontext()
                  ), torch.no_grad():
                v, ix = torch.topk(model(ctx)[0, -1].float(), 2)
            tops.append(f"{'plain' if plain else 'K1'} top-2 ids "
                        f"{ix.tolist()} logits {v.tolist()} margin "
                        f"{(v[0] - v[1]).item():.3e}")
        log(f"request {i}: first divergent token {j - len(prompts[i])} "
            f"(position {j}): {names[0]} {a[j]}, {names[1]} {b[j]}; "
            f"full forward over the common context: " + "; ".join(tops))
        return


def phase_serving(pa, fa, smi, build, label, phase, gate_kv="bf16"):
    """Serve ``make_prompts`` through ``DecodeEngine`` on the model
    ``build()`` makes: bf16 KV, prefix sharing, speculation; gates on the
    tokens, the prefix hit, a verify step, K3's launches per regime, the
    device of parameters and pools and finite logits. Then greedy streams
    equal to the plain-attention engine's, both with ``gate_kv`` KV: the
    timed run itself for bf16 (GPT-3 1.3B). Llama-3-8B compares f32
    caches: at 32 layers the bf16 cache's rounding turns the kernel's
    ~2e-6 per-step logit differences from the plain attention (f32 KV)
    into ~2e-4 (``scripts/engine_kv_drift.py``), above the smallest top-2
    margins of its random 128256-way logits, so equal bf16 streams would
    test the cache's rounding, not the kernel."""
    from paddle_tpu_torch.inference.engine import DecodeEngine

    t0 = time.perf_counter()
    model = build()
    torch.cuda.synchronize()
    log(f"# phase {phase}: {label} built on the card in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    eng = DecodeEngine(model, kv_dtype="bf16", **engine_config())
    t0 = time.perf_counter()
    eng.warmup()
    log(f"engine warmup (every program once, trash page only) "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    prompts = make_prompts(model.config.vocab_size)

    for n in K3_COUNTERS:
        setattr(pa, n, 0)
    t0 = time.perf_counter()
    outs = serve(eng, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tile, split, decode, verify = k3_counts(pa)

    st = eng.stats()
    ad = eng.adapter
    layers, group = ad.num_layers, ad.num_heads // ad.num_kv_heads
    programs = st["prefill_calls"] + st["decode_steps"]
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + NEW_TOKENS:
            raise AssertionError("a request did not emit 32 new tokens")
        if not ((o >= 0) & (o < model.config.vocab_size)).all():
            raise AssertionError("token id out of the vocabulary")
    if st["prefix_hit_tokens"] <= 0:
        raise AssertionError("no prefix hit")
    if st["verify_steps"] <= 0:
        raise AssertionError("no speculative verify step ran")
    if launches != layers * programs:
        raise AssertionError(
            f"kernel launches {launches} != {layers} layers x {programs} "
            "programs")
    want = k3_expected(pa, layers, st, eng, group)
    if (tile, split, decode, verify) != want:
        raise AssertionError(
            f"launches (tile, split, decode, verify) = "
            f"{(tile, split, decode, verify)}, expected {want} from "
            f"_k3_regime at G={group}: {layers} x ({st['prefill_calls']} "
            f"prefills, {st['decode_steps']} steps of which "
            f"{st['verify_steps']} verify)")
    tensors = [*model.parameters(), *model.buffers(), eng._kc, eng._vc]
    if not all(x.device.type == DEVICE for x in tensors):
        raise AssertionError("a parameter or pool is off the card")
    _, last = eng.last_step
    if not torch.isfinite(last).all():
        raise AssertionError("non-finite logits")
    tokens = st["total_tokens"]
    log(f"served {len(prompts)} requests: {tokens} tokens in {wall:.3f} s "
        f"= {tokens / wall:.1f} tok/s; prefill {st['prefill_calls']} calls "
        f"mean {1e3 * st['prefill_seconds'] / st['prefill_calls']:.2f} ms; "
        f"decode steps {st['decode_steps']} (verify {st['verify_steps']}) "
        f"mean {1e3 * st['step_seconds'] / st['decode_steps']:.2f} ms; "
        f"prefix_hit_tokens {st['prefix_hit_tokens']}; spec accepted "
        f"{st['spec_accepted']}/{st['spec_proposed']}; kernel launches "
        f"{launches} = {layers} x {programs} (G={group}: tile {tile}, "
        f"split {split}: decode {decode}, verify {verify})  [{smi}]")

    if gate_kv != "bf16":
        outs = serve(DecodeEngine(model, kv_dtype=gate_kv, **engine_config()),
                     prompts)
    plain = DecodeEngine(model, kv_dtype=gate_kv, attn_kernel="plain",
                         **engine_config())
    ref = serve(plain, prompts)
    same = sum(np.array_equal(a, b) for a, b in zip(outs, ref))
    log(f"full-width greedy streams ({gate_kv} KV) equal to the "
        f"plain-attention run: {same}/{len(prompts)}")
    if same != len(prompts):
        report_divergence(fa, model, prompts, outs, ref)
        raise AssertionError("full-width streams differ from plain")
    contexts = [len(p) + NEW_TOKENS // 2 for p in prompts]
    pool_bytes = 2 * eng._kc.numel() * eng._kc.element_size()
    del eng, plain, model
    torch.cuda.empty_cache()
    return dict(contexts=contexts, tokens_per_s=tokens / wall,
                streams=[np.asarray(o).tolist() for o in outs],
                pool_bytes=pool_bytes,
                decode_ms=1e3 * st["step_seconds"] / st["decode_steps"],
                prefill_ms=1e3 * st["prefill_seconds"] / st["prefill_calls"],
                launches=dict(tile=tile, split=split, decode=decode,
                              verify=verify))


def lockstep(kernel_eng, plain_eng, prompts, gaps=None):
    """Step both engines together on the same requests. Admission runs
    first on both: each tail prefill's last-token logits are compared,
    and the kernel engine's prefill tokens are forced to the plain
    engine's before the step's decode feeds them back (and writes their
    K/V), so every compared step runs on identical contexts. Each step's
    logits of the active slots are compared; the kernel engine's tokens
    are then overwritten with the plain engine's (teacher forcing along
    the plain run), counting every disagreement. Verify rows past a
    request's token budget are not compared: their positions lie beyond
    the request's pages, so their K/V land on the shared trash page (as
    in the reference) and they are never emitted. ``gaps``, a list,
    receives each step's (largest logit difference, largest |logit| of
    the plain engine), its prefills included."""
    prefills = ([], [])
    for eng, seen in zip((kernel_eng, plain_eng), prefills):
        def record(*a, _body=eng._prefill_body, _seen=seen, **kw):
            logits, exact = _body(*a, **kw)
            _seen.append(logits)
            return logits, exact

        eng._prefill_body = record
    ra = [kernel_eng._requests[kernel_eng.submit(p, max_new_tokens=NEW_TOKENS)]
          for p in prompts]
    rb = [plain_eng._requests[plain_eng.submit(p, max_new_tokens=NEW_TOKENS)]
          for p in prompts]
    worst, mismatches, steps = 0.0, 0, 0

    def force():
        nonlocal mismatches
        for a, b in zip(ra, rb):
            if a.tokens != b.tokens:
                mismatches += 1
                if len(a.tokens) != len(b.tokens):
                    raise AssertionError("token counts diverged")
                a.tokens[:] = b.tokens

    while True:
        plain_eng._admit()
        kernel_eng._admit()
        if len(prefills[0]) != len(prefills[1]):
            raise AssertionError("engines admitted different requests")
        step_worst = step_scale = 0.0
        for la, lb in zip(*prefills):
            step_worst = max(step_worst, (la - lb).abs().max().item())
            step_scale = max(step_scale, lb.abs().max().item())
        for seen in prefills:
            seen.clear()
        force()
        before = {r.slot: len(r.tokens) for r in rb if r.status == "running"}
        if not plain_eng.step():
            break
        kernel_eng.step()
        steps += 1
        sa, la = kernel_eng.last_step
        sb, lb = plain_eng.last_step
        if sa != sb or la.shape != lb.shape:
            raise AssertionError("engines took different steps")
        for slot in sb:
            rows = NEW_TOKENS - before[slot]
            d, ref = (la[slot] - lb[slot]).abs(), lb[slot].abs()
            if d.dim() > 1:
                d, ref = d[:rows], ref[:rows]
            step_worst = max(step_worst, d.max().item())
            step_scale = max(step_scale, ref.max().item())
        worst = max(worst, step_worst)
        if gaps is not None:
            gaps.append((step_worst, step_scale))
        force()
    if kernel_eng.step():
        raise AssertionError("kernel engine outlived the plain one")
    return worst, mismatches, steps


def phase_engine_parity(build, label, phase):
    """The kernel and plain engines in :func:`lockstep` on the model
    ``build()`` makes, f32 and int8 KV."""
    from paddle_tpu_torch.inference.engine import DecodeEngine

    model = build()
    prompts = make_prompts(model.config.vocab_size)
    for kv in ("f32", "int8"):
        a = DecodeEngine(model, kv_dtype=kv, **engine_config())
        b = DecodeEngine(model, kv_dtype=kv, attn_kernel="plain",
                         **engine_config())
        worst, mismatches, steps = lockstep(a, b, prompts)
        log(f"# phase {phase}: {label}, kv {kv}: {steps} steps, max "
            f"|logit kernel - plain| {worst:.3e} (atol "
            f"{ENGINE_LOGIT_ATOL[kv]}), token mismatches {mismatches}")
        if not worst <= ENGINE_LOGIT_ATOL[kv]:
            raise AssertionError(f"logits differ by {worst}")
        if mismatches:
            raise AssertionError("greedy streams differ")
        del a, b
    del model
    torch.cuda.empty_cache()


# -- phase 6: flash attention kernels ----------------------------------------

FLASH_REPLACES = {
    "fwd": "paddle_tpu/ops/pallas/flash_attention.py:136",
    "dq": "paddle_tpu/ops/pallas/flash_attention.py:332",
    "dkv": "paddle_tpu/ops/pallas/flash_attention.py:379",
}

# (causal, Tq, Tk, H, Hkv, D, dtype, bias code, mask code, strided): bias /
# mask dims B, H, Q(Tq), K(Tk) or 1; mask "pad" is the encoders' additive
# padding mask, [B, 1, 1, Tk] of 0 on each row's kept keys and -1e9 past
# them, taking no gradient
FLASH_CASES = (
    (True, 300, 300, 4, 4, 128, torch.float32, None, None, False),
    (True, 200, 333, 4, 2, 64, torch.float32, "B11K", None, False),
    (True, 333, 200, 8, 2, 128, torch.float32, None, None, False),
    (False, 256, 256, 2, 2, 64, torch.float32, "1HQK", None, False),
    (False, 130, 270, 4, 1, 128, torch.float32, "1111", None, False),
    (False, 192, 192, 2, 2, 128, torch.float32, None, "B1QK", False),
    (True, 384, 384, 4, 4, 128, torch.float32, None, None, True),
    (True, 300, 300, 4, 2, 128, torch.bfloat16, None, None, False),
    (False, 200, 333, 2, 2, 64, torch.bfloat16, "B11K", None, False),
    (True, 256, 256, 4, 4, 64, torch.bfloat16, None, None, True),
    (True, 1, 77, 4, 2, 64, torch.float32, "1H1K", None, False),
    (False, 17, 3, 2, 2, 128, torch.float32, None, None, False),
    (True, 65, 65, 16, 16, 128, torch.bfloat16, "11QK", None, False),
    (False, 128, 128, 12, 12, 64, torch.float32, None, "pad", True),
    (False, 200, 200, 12, 12, 64, torch.bfloat16, None, "pad", True),
)


def _dims(code, b, h, tq, tk):
    return tuple({"B": b, "H": h, "Q": tq, "K": tk, "1": 1}[c] for c in code)


def flash_inputs(gen, b, tq, tk, h, hkv, d, dtype, strided):
    """q, k, v, dO on the card; strided: q/k/v as the model slices them out
    of one fused [B, T, H, 3, D] projection."""
    dev = DEVICE
    if strided:
        qkv = torch.randn((b, tq, h, 3, d), generator=gen, device=dev)
        q, k, v = (qkv.to(dtype)[:, :, :, i] for i in range(3))
    else:
        q = torch.randn((b, tq, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, tk, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, tk, hkv, d), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, tq, h, d), generator=gen, device=dev).to(dtype)
    return q, k, v, do


def _rel(got, ref):
    """(max|err|, max|err| / max|ref|) in f32."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def compare_flash(fa, q, k, v, do, bias, causal, bias_grad, worst, tag):
    """Each kernel vs its plain version on the same inputs; the backward
    halves get the kernel forward's o and lse. Updates worst[kernel] with
    the largest max|err| and raises past the tolerance."""
    tol = FLASH_TOL[q.dtype]
    kw = dict(causal=causal)
    o, lse = fa.flash_attention_forward_cuda(q, k, v, bias, **kw)
    o_p, lse_p = fa.flash_attention_forward_plain(q, k, v, bias, **kw)
    delta = fa._delta(o, do).contiguous()
    dq, ds = fa.flash_attention_bwd_dq_cuda(q, k, v, bias, do, lse, delta,
                                            want_ds=bias_grad, **kw)
    dq_p, ds_p = fa.flash_attention_bwd_dq_plain(q, k, v, bias, do, lse,
                                                 delta, want_ds=bias_grad,
                                                 **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, bias, do, lse, delta,
                                             **kw)
    dk_p, dv_p = fa.flash_attention_bwd_dkv_plain(q, k, v, bias, do, lse,
                                                  delta, **kw)
    torch.cuda.synchronize()
    live = lse_p > fa.NEG_INF * 0.5
    if not torch.equal(lse[~live], lse_p[~live]):
        raise AssertionError(f"{tag}: rows with no visible key differ")
    if not torch.equal(o.float()[~live.transpose(1, 2)],
                       torch.zeros_like(o.float()[~live.transpose(1, 2)])):
        raise AssertionError(f"{tag}: a row with no visible key is not 0")
    pairs = [("fwd", "o", o, o_p, tol), ("fwd", "lse", lse[live],
                                          lse_p[live], 1e-4),
             ("dq", "dq", dq, dq_p, tol), ("dkv", "dk", dk, dk_p, 1e-4),
             ("dkv", "dv", dv, dv_p, 1e-4)]
    if bias_grad:
        pairs.append(("dq", "ds", ds, ds_p, 1e-4))
    line = []
    for kern, name, got, ref, t in pairs:
        if not ref.abs().max().item() > 0:
            raise AssertionError(f"{tag}: {name} is all zero")
        err, rel = _rel(got, ref)
        worst[kern] = max(worst.get(kern, 0.0), err)
        line.append(f"{name} {rel:.1e}")
        if not rel <= t:
            raise AssertionError(f"{tag}: {name} differs from plain: "
                                 f"{rel} > {t} (max|err| {err})")
    log(f"{tag}: rel err " + ", ".join(line))


def padding_bias(gen, b, tk):
    """The encoders' additive mask ``[b, 1, 1, tk]`` f32: row 0 keeps every
    key, the others a length drawn from ``gen``; -1e9 past the length."""
    lengths = torch.randint(1, tk + 1, (b,), generator=gen, device=DEVICE)
    lengths[0] = tk
    kept = torch.arange(tk, device=DEVICE)[None, :] < lengths[:, None]
    return torch.where(kept, 0.0, -1e9)[:, None, None, :]


def flash_case(fa, gen, case):
    """The inputs of one FLASH_CASES entry (batch 2) on the card: q, k, v,
    dO, the bias (or bool mask as a NEG_INF bias, or None), causal, whether
    the bias takes a gradient, and a tag."""
    causal, tq, tk, h, hkv, d, dt, bcode, mcode, strided = case
    b = 2
    q, k, v, do = flash_inputs(gen, b, tq, tk, h, hkv, d, dt, strided)
    bias = None
    if bcode is not None:
        bias = torch.randn(_dims(bcode, b, h, tq, tk), generator=gen,
                           device=DEVICE)
    if mcode == "pad":
        bias = padding_bias(gen, b, tk)
    elif mcode is not None:
        keep = torch.rand(_dims(mcode, b, h, tq, tk), generator=gen,
                          device=DEVICE) > 0.3
        keep[0, 0, 7] = False  # a row that sees no key
        bias = torch.where(keep, 0.0, fa.NEG_INF)
    tag = (f"{'causal' if causal else 'full  '} Tq={tq:3d} Tk={tk:3d} "
           f"H={h} G={h // hkv} D={d:3d} {str(dt)[6:]:8s} "
           f"bias={bcode or mcode or '-'}{' strided' if strided else ''}")
    return q, k, v, do, bias, causal, bcode is not None, tag


def phase_flash_sweep(fa):
    """Returns the worst max|err| per kernel over the f32 cases."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    worst, worst_bf16 = {}, {}
    log("# phase 6a: flash kernels vs plain (tolerance max|err|/max|ref|: "
        f"f32 1e-4, bf16 o/dq {FLASH_TOL[torch.bfloat16]:.2e})")
    for case in FLASH_CASES:
        q, k, v, do, bias, causal, bias_grad, tag = flash_case(fa, gen, case)
        compare_flash(fa, q, k, v, do, bias, causal, bias_grad,
                      worst if q.dtype == torch.float32 else worst_bf16, tag)
    log(f"worst max|err| f32 {worst}, bf16 {worst_bf16}")
    return worst


def flash_bound(kind, q, k, causal, peaks, bias=None, needed_pairs=None):
    """:func:`bounds`: each input read once, each output written once; QK,
    dP, P.V, dQ, dK, dV as 2 * D FLOPs per visible (query, key) pair, of
    the inputs' type. A bias (f32, as the kernels read it) adds its bytes;
    a padding bias ``[B|1, 1, 1, Tk]`` hides its -1e9 keys, and the pairs
    counted are the kept ones, the work these inputs need."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qi = np.arange(tq)
    pairs = (int(np.clip(qi + tk - tq + 1, 0, tk).sum()) if causal
             else tq * tk) * b
    if bias is not None and not causal and bias.shape[1:3] == (1, 1):
        kept = int((bias[:, 0, 0, :] > -1e8).sum()) * (b // bias.shape[0])
        pairs = tq * kept
    if needed_pairs is not None:  # the pairs a call needs, given
        pairs = needed_pairs
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2 * d * products * pairs * h
    elt = q.element_size()
    qb, kvb, rows = b * tq * h * d * elt, b * tk * hkv * d * elt, b * h * tq * 4
    nbytes = {"fwd": 2 * qb + 2 * kvb + rows,
              "dq": 3 * qb + 2 * kvb + 2 * rows,
              "dkv": 2 * qb + 2 * kvb + 2 * rows + 2 * b * tk * h * d * 4}[kind]
    if bias is not None:
        nbytes += bias.numel() * 4
    return bounds(nbytes, flops,
                  "f32" if q.dtype == torch.float32 else "bf16", peaks)


def sdpa_backend(qh, kh, vh, **kw):
    """The first SDPA backend, in PyTorch's order of preference, that runs
    these inputs (and keywords: ``is_causal`` or ``attn_mask``): pinned,
    so the yardstick names what it timed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            # a refused backend warns why before it raises
            with warnings.catch_warnings(), sdpa_kernel([be]):
                warnings.simplefilter("ignore")
                sdpa(qh, kh, vh, **kw)
            return be
        except RuntimeError:
            continue
    raise AssertionError("no SDPA backend runs these inputs")


def sdpa_yardsticks(q, k, v):
    """SDPA's operands for q, k, v ``[B, T, H|Hkv, D]``: a list of (label,
    qh, kh, vh, keywords), each q / k / v ``[B, H, T, D]`` leaves that
    take a gradient. The first is the library's call on these inputs: k /
    v at Hkv heads with ``enable_gqa`` where this torch takes it, else
    repeated to every query head. Under GQA with ``enable_gqa``, a second
    repeats k / v to every query head (a copy outside the timed call, so
    that the backends without GQA run)."""
    group = q.shape[2] // k.shape[2]

    def leaves(kv_repeat):
        qh, kh, vh = (x.detach().transpose(1, 2) for x in (q, k, v))
        if kv_repeat > 1:
            kh, vh = (x.repeat_interleave(kv_repeat, 1) for x in (kh, vh))
        return tuple(x.requires_grad_() for x in (qh, kh, vh))

    if group == 1:
        return [(f"H={q.shape[2]}", *leaves(1), {})]
    repeated = ("GQA, K/V repeat_interleave'd", *leaves(group), {})
    qh, kh, vh = leaves(1)
    try:
        torch.nn.functional.scaled_dot_product_attention(
            qh[:, :, :1], kh[:, :, :1], vh[:, :, :1], enable_gqa=True)
    except TypeError:
        return [repeated]
    return [("GQA, enable_gqa", qh, kh, vh, {"enable_gqa": True}),
            repeated]


def time_in_turns(kern_fwd, kern_pair, yard, do, call_kw=None):
    """K1 in turns with SDPA's forward (K1, SDPA, SDPA, K1) and the pair
    K2a + K2b in turns with SDPA's backward, on one yardstick of
    :func:`sdpa_yardsticks`: (label with the backend, forward turns,
    backward turns). ``call_kw`` is SDPA's masking (default causal)."""
    from torch.nn.attention import sdpa_kernel

    label, qh, kh, vh, kw = yard
    kw = dict(kw, **(call_kw or {"is_causal": True}))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    be = sdpa_backend(qh, kh, vh, **kw)
    with sdpa_kernel([be]):
        def lib():
            return sdpa(qh, kh, vh, **kw)
        turns = [cuda_ms(kern_fwd), cuda_ms(lib), cuda_ms(lib),
                 cuda_ms(kern_fwd)]
        out = sdpa(qh, kh, vh, **kw)
        doh = do.transpose(1, 2)

        def lib_bwd():
            return torch.autograd.grad(out, (qh, kh, vh), doh,
                                       retain_graph=True)
        bturns = [cuda_ms(kern_pair), cuda_ms(lib_bwd), cuda_ms(lib_bwd),
                  cuda_ms(kern_pair)]
    return f"{be.name}, {label}", turns, bturns


def phase_flash_timing(fa, peaks, h=16, hkv=16, strided=True):
    """K1, K2a, K2b at a training path's shapes (GPT-3 1.3B: H=Hkv=16, q/k/v
    strided out of one fused projection as in the model; Llama-3-8B: H=32,
    Hkv=8, separate projections). K1 is timed in turns with SDPA's forward
    and the pair K2a + K2b in turns with SDPA's backward (dq + dk + dv),
    each averaged, on each of :func:`sdpa_yardsticks` (the first gives
    ``library_ms``; under GQA the repeated-K/V call gives
    ``library_repeat_ms``); K2a and K2b also alone."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    b, t, d = TRAIN_BATCH, TRAIN_SEQ, 128
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = flash_inputs(gen, b, t, t, h, hkv, d, dt, strided)
        worst = {}
        compare_flash(fa, q, k, v, do, None, True, False, worst,
                      f"training shape H={h} Hkv={hkv} {str(dt)[6:]}")
        o, lse = fa.flash_attention_forward_cuda(q, k, v, causal=True)
        delta = fa._delta(o, do).contiguous()
        kw = dict(causal=True)
        calls = {
            "fwd": (lambda: fa.flash_attention_forward_cuda(q, k, v, **kw),
                    lambda: fa.flash_attention_forward_plain(q, k, v, **kw)),
            "dq": (lambda: fa.flash_attention_bwd_dq_cuda(
                       q, k, v, None, do, lse, delta, **kw),
                   lambda: fa.flash_attention_bwd_dq_plain(
                       q, k, v, None, do, lse, delta, **kw)),
            "dkv": (lambda: fa.flash_attention_bwd_dkv_cuda(
                        q, k, v, None, do, lse, delta, **kw),
                    lambda: fa.flash_attention_bwd_dkv_plain(
                        q, k, v, None, do, lse, delta, **kw)),
        }

        def pair():
            calls["dq"][0]()
            calls["dkv"][0]()

        yards = [time_in_turns(calls["fwd"][0], pair, y, do)
                 for y in sdpa_yardsticks(q, k, v)]
        lib_label, turns, bturns = yards[0]
        lib_fwd = (turns[1] + turns[2]) / 2
        lib_bwd = (bturns[1] + bturns[2]) / 2
        pair_ms = (bturns[0] + bturns[3]) / 2
        for kind, (kern, plain) in calls.items():
            ms = ((turns[0] + turns[3]) / 2 if kind == "fwd"
                  else cuda_ms(kern))
            plain_ms = cuda_ms(plain, iters=5, warm=1)
            lib = lib_fwd if kind == "fwd" else lib_bwd
            rows[(kind, dt)] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=lib, max_abs_err=worst[kind],
                                    **flash_bound(kind, q, k, True, peaks))
            if kind != "fwd":
                rows[(kind, dt)]["pair_ms"] = pair_ms
            log(f"{kind:3s} {str(dt)[6:]:8s} B={b} T={t} H={h} Hkv={hkv} "
                f"D={d} causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                f" sdpa "
                f"{'forward' if kind == 'fwd' else 'backward (dq+dk+dv)'} "
                f"[{lib_label}] {lib:.4f} ms"
                + (f" (turns K1 {turns[0]:.4f}, sdpa {turns[1]:.4f}, "
                   f"{turns[2]:.4f}, K1 {turns[3]:.4f})" if kind == "fwd"
                   else "")
                + f", {bound_text(rows[(kind, dt)], ms)}")
        pb = {k_: rows[("dq", dt)][k_] + rows[("dkv", dt)][k_]
              for k_ in ("bound_ms", "bound_fma_ms")}
        log(f"pair {str(dt)[6:]:8s} K2a + K2b {pair_ms:.4f} ms vs sdpa "
            f"backward [{lib_label}] {lib_bwd:.4f} ms = "
            f"{pair_ms / lib_bwd:.3f}x (turns pair {bturns[0]:.4f}, sdpa "
            f"{bturns[1]:.4f}, {bturns[2]:.4f}, pair {bturns[3]:.4f}); "
            f"bound {pb['bound_ms']:.4f} ms (tensor cores), "
            f"{pb['bound_fma_ms']:.4f} ms (f32 FMA), "
            f"{100 * pb['bound_ms'] / pair_ms:.1f} % of bound")
        for label, ft, bt in yards[1:]:
            rep_fwd, rep_bwd = (ft[1] + ft[2]) / 2, (bt[1] + bt[2]) / 2
            rows[("fwd", dt)]["library_repeat_ms"] = rep_fwd
            for kind in ("dq", "dkv"):
                rows[(kind, dt)]["library_repeat_ms"] = rep_bwd
            log(f"sdpa [{label}] {str(dt)[6:]}: forward {rep_fwd:.4f} ms "
                f"(turns K1 {ft[0]:.4f}, sdpa {ft[1]:.4f}, {ft[2]:.4f}, K1 "
                f"{ft[3]:.4f}), backward {rep_bwd:.4f} ms (turns pair "
                f"{bt[0]:.4f}, sdpa {bt[1]:.4f}, {bt[2]:.4f}, pair "
                f"{bt[3]:.4f})")
        del q, k, v, do, o, lse, delta, yards
        torch.cuda.empty_cache()
    return rows


# -- phases 7 and 8: training -------------------------------------------------


@contextlib.contextmanager
def plain_attention(fa):
    """The flash route with the kernels' plain versions standing in for the
    kernels: the reference run of phases 7 and 8."""
    names = ("forward", "bwd_dq", "bwd_dkv")
    saved = {n: getattr(fa, f"flash_attention_{n}_cuda") for n in names}
    try:
        for n in names:
            setattr(fa, f"flash_attention_{n}_cuda",
                    getattr(fa, f"flash_attention_{n}_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(fa, f"flash_attention_{n}_cuda", fn)


def train_batch(vocab):
    """Next-token batch [B, T] of ids and labels, made with numpy."""
    rng = np.random.default_rng(SEED + 4)
    tok = rng.integers(0, vocab, (TRAIN_BATCH, TRAIN_SEQ + 1))
    tok = torch.as_tensor(tok, device=DEVICE)
    return tok[:, :-1].contiguous(), tok[:, 1:].contiguous()


def trainer(model, adamw=ADAMW, meta=None):
    """``TrainStep`` + AdamW + clip on ``model``; with ``meta`` ("lamb" /
    "lars") the optimizer fleet's meta-optimizer swaps it for."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **adamw)
    if meta is not None:
        from paddle_tpu_torch.distributed import fleet

        opt = fleet._apply_meta_optimizers(opt, meta_strategy(meta))
    return TrainStep(model, lambda m, ids, lab: m(ids, labels=lab), opt), opt


def phase_training(fa, smi, build, adamw, label, phase):
    """TRAIN_STEPS steps of ``TrainStep`` + ``AdamW`` on the model
    ``build()`` makes: the loss falls, each flash kernel launches once a
    layer a step, the first loss equals a no-grad forward on the plain
    attention."""
    t0 = time.perf_counter()
    model = build()
    step, opt = trainer(model, adamw)
    ids, labels = train_batch(model.config.vocab_size)
    with plain_attention(fa), torch.no_grad():
        plain_loss = float(model(ids, labels=labels))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"# phase {phase}: {label} ({n_params / 1e9:.3f} B parameters) "
        f"built and a no-grad plain-attention loss taken in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    torch.cuda.reset_peak_memory_stats()
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                "dkv": fa.launches_dkv}
    peak = torch.cuda.max_memory_allocated()
    layers = model.config.num_hidden_layers
    tokens = ids.numel()
    for i, (l, ms) in enumerate(zip(losses, step_ms)):
        log(f"step {i}: loss {l:.6f}, {ms:.1f} ms, "
            f"{tokens / ms * 1e3:.1f} tokens/s")
    log(f"steps 1-{TRAIN_STEPS - 1} mean {np.mean(step_ms[1:]):.1f} ms = "
        f"{tokens / np.mean(step_ms[1:]) * 1e3:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches} = {layers} layers x "
        f"{TRAIN_STEPS} steps  [{smi}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if any(n != layers * TRAIN_STEPS for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != {layers} x "
                             f"{TRAIN_STEPS}")
    states = [t for st in opt._accumulators for t in st.values()]
    if not all(x.device.type == DEVICE
               for x in [*model.parameters(), *states]):
        raise AssertionError("a parameter or optimizer state is off the card")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    log(f"first loss kernel {losses[0]:.7f} vs plain attention "
        f"{plain_loss:.7f}: rel {rel:.2e} (rtol {TRAIN_LOSS_RTOL})")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("first loss differs from the plain attention")
    del step, opt, model
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms, losses=losses,
                peak_bytes=peak, tokens=tokens)


def phase_train_lockstep(fa, build, adamw, label, phase):
    """A kernel trainer and a plain-attention trainer from the same
    weights, LOCKSTEP_STEPS steps each: per-step losses and final
    parameters compared."""
    a = build()
    b = build()
    b.load_state_dict(a.state_dict())
    step_a, _ = trainer(a, adamw)
    step_b, _ = trainer(b, adamw)
    ids, labels = train_batch(a.config.vocab_size)
    worst = 0.0
    for i in range(LOCKSTEP_STEPS):
        la = float(step_a(ids, labels))
        with plain_attention(fa):
            lb = float(step_b(ids, labels))
        rel = abs(la - lb) / abs(lb)
        worst = max(worst, rel)
        log(f"# phase {phase}: {label} step {i}: loss kernel {la:.7f} "
            f"plain {lb:.7f} rel {rel:.2e}")
    bound = 2 * adamw["learning_rate"] * LOCKSTEP_STEPS
    far = total = 0
    dmax = 0.0
    pb = dict(b.named_parameters())
    for n, p in a.named_parameters():
        d = (p.detach() - pb[n].detach()).abs()
        dmax = max(dmax, d.max().item())
        far += int((d > LOCKSTEP_PARAM_ATOL).sum())
        total += d.numel()
    log(f"final params: max |kernel - plain| {dmax:.2e} (bound {bound:.1e}),"
        f" {far}/{total} beyond {LOCKSTEP_PARAM_ATOL}")
    if not worst <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"lockstep losses differ: rel {worst}")
    if not (dmax <= bound and far <= 0.01 * total):
        raise AssertionError("lockstep parameters differ")
    del step_a, step_b, a, b
    torch.cuda.empty_cache()


# -- phases 9-12: grouped matmul and MoE training -----------------------------

GMM_REPLACES = {
    "fwd": "paddle_tpu/ops/pallas/grouped_matmul.py:116",
    "drhs": "paddle_tpu/ops/pallas/grouped_matmul.py:164",
}

# (label, group sizes or a group count for a Dirichlet draw, M, K, N)
GMM_CASES = (
    ("aligned", [64, 64], 128, 32, 64),
    ("ragged", [50, 30, 48], 128, 32, 64),
    ("empty groups", [0, 100, 0, 28], 128, 32, 64),
    ("trailing empties", [128, 0, 0], 128, 32, 64),
    ("padding tail", [30, 40], 128, 32, 64),
    ("multi-tile group", [100, 156], 256, 32, 64),
    ("N=192", [40, 60, 28], 128, 32, 192),
    ("odd K", [50, 30, 48], 128, 33, 40),
    ("odd K and N", [300, 0, 211], 600, 45, 37),
    ("Mixtral top-2", MOE_EXPERTS, MOE_TOP_K * TRAIN_BATCH * TRAIN_SEQ,
     MOE_DIM, MOE_HIDDEN),
    # ~32 rows a group: most row tiles span several groups; G * K * N
    # passes 2^31, so the last groups' element offsets need 64 bits
    ("128 groups", 128, 4096, 2048, 8448),
)


def dirichlet_sizes(rng, m, g):
    """Imbalanced group sizes summing to m: the draw of
    scripts/bench_gmm_tpu.py (Dirichlet(2) proportions)."""
    props = rng.dirichlet(np.ones(g) * 2.0)
    sizes = np.floor(props * m).astype(np.int64)
    sizes[-1] += m - sizes.sum()
    return sizes


def gmm_inputs(gen, m, k, n, g, dtype):
    """lhs [m, k], rhs [g, k, n] (scaled by 1/sqrt(k)) and dout [m, n] on
    the card."""
    dev = DEVICE
    lhs = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    rhs = (torch.randn((g, k, n), generator=gen, device=dev)
           / np.sqrt(k)).to(dtype)
    dout = torch.randn((m, n), generator=gen, device=dev).to(dtype)
    return lhs, rhs, dout


def compare_gmm(gm, lhs, rhs, dout, sizes, worst, tag):
    """K4a on (lhs, rhs) and on (dout, rhs^T view), K4b on (lhs, dout),
    each vs its plain version. Padding rows and empty groups' drhs must be
    exactly zero. Updates worst[name] with (max|err|, relative) and raises
    past the tolerance."""
    tol = GMM_TOL[lhs.dtype]
    host = sizes.cpu().numpy()
    total = int(host.sum())
    empty = torch.as_tensor(np.flatnonzero(host == 0), device=DEVICE)
    rhs_t = rhs.transpose(1, 2)
    calls = (("out", gm.grouped_matmul_cuda, gm.grouped_matmul_plain,
              (lhs, rhs), tol),
             ("dlhs", gm.grouped_matmul_cuda, gm.grouped_matmul_plain,
              (dout, rhs_t), tol),
             ("drhs", gm.grouped_matmul_drhs_cuda,
              gm.grouped_matmul_drhs_plain, (lhs, dout),
              GMM_TOL[torch.float32]))
    line = []
    for name, kern, plain, args, t in calls:
        got = kern(*args, sizes)
        ref = plain(*args, sizes)
        torch.cuda.synchronize()
        if name == "drhs":
            if got[empty].any():
                raise AssertionError(f"{tag}: an empty group's drhs is not 0")
        elif got[total:].any():
            raise AssertionError(f"{tag}: a padding row of {name} is not 0")
        if not ref.abs().max().item() > 0:
            raise AssertionError(f"{tag}: {name} is all zero")
        err, rel = _rel(got, ref)
        prev = worst.get(name, (0.0, 0.0))
        worst[name] = (max(prev[0], err), max(prev[1], rel))
        line.append(f"{name} {rel:.1e}")
        if not rel <= t:
            raise AssertionError(f"{tag}: {name} differs from plain: {rel} "
                                 f"> {t} (max|err| {err})")
        del got, ref
    log(f"{tag}: rel err " + ", ".join(line))


def phase_gmm_sweep(gm):
    """Returns the worst (max|err|, relative) per output over the f32
    cases."""
    rng = np.random.default_rng(SEED + 5)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    worst, worst_bf16 = {}, {}
    log("# phase 9: grouped matmul K4a / K4b vs plain (tolerance "
        f"max|err|/max|ref|: f32 {GMM_TOL[torch.float32]}, bf16 out / dlhs "
        f"{GMM_TOL[torch.bfloat16]:.2e}, drhs f32 in both)")
    for label, sizes, m, k, n in GMM_CASES:
        if isinstance(sizes, int):
            sizes = dirichlet_sizes(rng, m, sizes)
        st = torch.as_tensor(np.asarray(sizes), dtype=torch.int32,
                             device=DEVICE)
        for dt in (torch.float32, torch.bfloat16):
            lhs, rhs, dout = gmm_inputs(gen, m, k, n, len(sizes), dt)
            compare_gmm(gm, lhs, rhs, dout, st,
                        worst if dt == torch.float32 else worst_bf16,
                        f"{label:16s} M={m:4d} K={k:4d} N={n:5d} "
                        f"G={len(sizes):3d} {str(dt)[6:]:8s}")
            del lhs, rhs, dout
            torch.cuda.empty_cache()
    log(f"worst (max|err|, rel) f32 {worst}, bf16 {worst_bf16}")
    return worst


def gmm_bound(kind, lhs, other, host_sizes, peaks):
    """:func:`bounds` of one call: the routed rows of lhs (and of dout)
    read once, the weights of non-empty groups read (fwd) or written in
    f32 (drhs) once, the output written once; 2 FLOPs per routed row x K
    x N of the inputs' type."""
    rows = int(host_sizes.sum())
    live = int((host_sizes > 0).sum())
    m, k = lhs.shape
    elt = lhs.element_size()
    if kind == "fwd":
        n = other.shape[2]
        nbytes = rows * k * elt + live * k * n * elt + m * n * elt
    else:
        n = other.shape[1]
        nbytes = rows * (k + n) * elt + live * k * n * 4
    nbytes += 4 * len(host_sizes)
    return bounds(nbytes, 2 * rows * k * n,
                  "f32" if lhs.dtype == torch.float32 else "bf16", peaks)


def grouped_library(kind, lhs, other, host_sizes, ends):
    """(call, label): ``torch._grouped_mm`` on these inputs where this
    torch has it and takes them, else a per-expert ``torch.mm`` loop."""
    spans = np.concatenate([[0], np.cumsum(host_sizes)])
    if kind == "fwd":
        def grouped():
            return torch._grouped_mm(lhs, other, offs=ends)
        out = torch.empty((lhs.shape[0], other.shape[2]), dtype=lhs.dtype,
                          device=DEVICE)

        def loop():
            for g in range(len(host_sizes)):
                s, e = int(spans[g]), int(spans[g + 1])
                torch.mm(lhs[s:e], other[g], out=out[s:e])
            return out
    else:
        def grouped():
            return torch._grouped_mm(lhs.T, other, offs=ends)
        out = torch.empty((len(host_sizes), lhs.shape[1], other.shape[1]),
                          dtype=lhs.dtype, device=DEVICE)

        def loop():
            for g in range(len(host_sizes)):
                s, e = int(spans[g]), int(spans[g + 1])
                torch.mm(lhs[s:e].T, other[s:e], out=out[g])
            return out
    try:
        grouped()
        torch.cuda.synchronize()
        return grouped, "torch._grouped_mm"
    except (AttributeError, RuntimeError, TypeError, ValueError) as exc:
        log(f"torch._grouped_mm refused {kind} {str(lhs.dtype)[6:]}: "
            f"{str(exc).splitlines()[0][:120]}")
        return loop, "per-expert torch.mm loop"


def moe_gmm_inputs():
    """The group sizes (device tensor, host array), their inclusive ends
    and the f32 operands of one MoE training step's grouped matmuls at the
    Mixtral widths, made from the seed."""
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    m, d, f, e = (MOE_TOP_K * TRAIN_BATCH * TRAIN_SEQ, MOE_DIM, MOE_HIDDEN,
                  MOE_EXPERTS)
    host = dirichlet_sizes(rng, m, e)
    sizes = torch.as_tensor(host, dtype=torch.int32, device=DEVICE)
    ends = torch.cumsum(sizes, 0, dtype=torch.int32)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    ops = dict(x=rand(m, d), a=rand(m, f), w_in=rand(e, d, f, scale=d ** -0.5),
               w_out=rand(e, f, d, scale=f ** -0.5), dh=rand(m, f),
               dy=rand(m, d))
    return sizes, host, ends, ops


def moe_gmm_calls(t):
    """(name, kind, lhs, other) of the step's five grouped matmuls on the
    operands t: both forward products, the down projection's dlhs on the
    rhs^T view, both weight gradients."""
    return (("up fwd", "fwd", t["x"], t["w_in"]),
            ("down fwd", "fwd", t["a"], t["w_out"]),
            ("down dlhs", "fwd", t["dy"], t["w_out"].transpose(1, 2)),
            ("up drhs", "drhs", t["x"], t["dh"]),
            ("down drhs", "drhs", t["a"], t["dy"]))


def phase_gmm_timing(gm, peaks):
    """The five grouped matmuls of one MoE training step at the Mixtral
    widths, in f32 (the training path's dtype) and in bf16 (names with a
    ``bf16`` suffix)."""
    sizes, host, ends, ops = moe_gmm_inputs()
    log(f"# phase 10: grouped matmuls of one MoE step, M={len(ops['x'])} "
        f"routed rows, dim {MOE_DIM}, hidden {MOE_HIDDEN}, {MOE_EXPERTS} "
        f"experts, sizes {host.tolist()}")
    rows = {}
    for dt, suffix in ((torch.float32, ""), (torch.bfloat16, " bf16")):
        t = {k: v.to(dt) for k, v in ops.items()}
        for name, kind, lhs, other in moe_gmm_calls(t):
            rows[name + suffix] = time_gmm_call(
                gm, peaks, name + suffix, kind, lhs, other, sizes, host,
                ends)
        del t, lhs, other
        torch.cuda.empty_cache()
    del ops
    torch.cuda.empty_cache()
    return rows


def time_gmm_call(gm, peaks, name, kind, lhs, other, sizes, host, ends):
    """One call checked against its plain version, then timed beside it,
    a dense ``torch.matmul`` of the same FLOPs and the grouped library
    call; returns its row (the ``kernels`` line's fields)."""
    kern = (gm.grouped_matmul_cuda if kind == "fwd"
            else gm.grouped_matmul_drhs_cuda)
    plain = (gm.grouped_matmul_plain if kind == "fwd"
             else gm.grouped_matmul_drhs_plain)
    got, ref = kern(lhs, other, sizes), plain(lhs, other, sizes)
    torch.cuda.synchronize()
    err, rel = _rel(got, ref)
    del got, ref
    tol = GMM_TOL[lhs.dtype if kind == "fwd" else torch.float32]
    if not rel <= tol:
        raise AssertionError(f"{name}: kernel disagrees, rel {rel}")
    ms = cuda_ms(lambda: kern(lhs, other, sizes), iters=10, warm=2)
    plain_ms = cuda_ms(lambda: plain(lhs, other, sizes), iters=3, warm=1)
    if kind == "fwd":
        dense_ms = cuda_ms(lambda: torch.matmul(lhs, other[0]), iters=10,
                           warm=2)
    else:
        dense_ms = cuda_ms(lambda: torch.matmul(lhs.T, other), iters=10,
                           warm=2)
    lib, lib_label = grouped_library(kind, lhs, other, host, ends)
    lib_ms = cuda_ms(lib, iters=5, warm=1)
    row = dict(
        ms=ms, plain_ms=plain_ms, dense_ms=dense_ms, max_abs_err=err,
        library_ms=lib_ms if lib_label == "torch._grouped_mm" else None,
        **gmm_bound(kind, lhs, other, host, peaks))
    log(f"{name:16s} [{lhs.shape[0]}x{lhs.shape[1]}] {kind:4s}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, dense torch.matmul "
        f"{dense_ms:.4f} ms, {lib_label} {lib_ms:.4f} ms, "
        f"{bound_text(row, ms)}, rel err {rel:.1e}")
    return row


@contextlib.contextmanager
def plain_grouped_matmul(gm):
    """The grouped matmul's plain versions standing in for K4a / K4b: the
    reference run of phases 11 and 12."""
    saved = (gm.grouped_matmul_cuda, gm.grouped_matmul_drhs_cuda)
    try:
        gm.grouped_matmul_cuda = gm.grouped_matmul_plain
        gm.grouped_matmul_drhs_cuda = gm.grouped_matmul_drhs_plain
        yield
    finally:
        gm.grouped_matmul_cuda, gm.grouped_matmul_drhs_cuda = saved


def build_moe(dim, hidden):
    """MoE -> Linear(dim, 1): the composition the JAX package trains its
    dropless MoE in (tests/test_grouped_matmul.py::test_dropless_moe_trains),
    weights from a seeded generator on the card."""
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.initializer import XavierNormal

    class MoERegressor(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            self.moe = MoELayer(dim, hidden, MOE_EXPERTS, top_k=MOE_TOP_K,
                                drop_tokens=False, device=DEVICE,
                                generator=gen)
            self.head = Linear(dim, 1, device=DEVICE, generator=gen,
                               weight_init=XavierNormal())

        def forward(self, x):
            return self.head(self.moe(x))

    return MoERegressor()


def moe_loss(model, x, y):
    from paddle_tpu_torch.nn.functional import mse_loss

    return mse_loss(model(x), y) + model.moe.last_aux_loss


def moe_batch(dim):
    """x [B, T, dim] and regression targets y [B, T, 1], made with numpy."""
    rng = np.random.default_rng(SEED + 7)
    x = rng.standard_normal((TRAIN_BATCH, TRAIN_SEQ, dim), np.float32)
    y = rng.standard_normal((TRAIN_BATCH, TRAIN_SEQ, 1), np.float32)
    return torch.as_tensor(x, device=DEVICE), torch.as_tensor(y, device=DEVICE)


def moe_trainer(model):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **MOE_ADAMW)
    return TrainStep(model, moe_loss, opt), opt


def phase_moe_training(gm, smi):
    t0 = time.perf_counter()
    model = build_moe(MOE_DIM, MOE_HIDDEN)
    step, opt = moe_trainer(model)
    x, y = moe_batch(MOE_DIM)
    with plain_grouped_matmul(gm), torch.no_grad():
        plain_loss = float(moe_loss(model, x, y))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"# phase 11: MoE (Mixtral 8x7B block: dim {MOE_DIM}, hidden "
        f"{MOE_HIDDEN}, {MOE_EXPERTS} experts, top-{MOE_TOP_K}; "
        f"{n_params / 1e9:.3f} B parameters) built and a no-grad plain loss "
        f"taken in {time.perf_counter() - t0:.2f} s (set-up)")
    torch.cuda.reset_peak_memory_stats()
    gm.launches_fwd = gm.launches_drhs = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = {"fwd": gm.launches_fwd, "drhs": gm.launches_drhs}
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, (l, ms) in enumerate(zip(losses, step_ms)):
        log(f"step {i}: loss {l:.7f}, {ms:.1f} ms, "
            f"{tokens / ms * 1e3:.1f} tokens/s")
    log(f"steps 1-{TRAIN_STEPS - 1} mean {np.mean(step_ms[1:]):.1f} ms = "
        f"{tokens / np.mean(step_ms[1:]) * 1e3:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches} = (3, 2) x "
        f"{TRAIN_STEPS} steps  [{smi}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    # per step: K4a for both forward products and the down projection's
    # dlhs (the input x needs no gradient, so the up projection's dlhs is
    # skipped); K4b for both weight gradients
    if launches != {"fwd": 3 * TRAIN_STEPS, "drhs": 2 * TRAIN_STEPS}:
        raise AssertionError(f"grouped matmul launches {launches} != "
                             f"(3, 2) x {TRAIN_STEPS}")
    states = [t for st in opt._accumulators for t in st.values()]
    if not all(t.device.type == DEVICE
               for t in [*model.parameters(), *states]):
        raise AssertionError("a parameter or optimizer state is off the card")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    log(f"first loss kernel {losses[0]:.7f} vs plain grouped matmul "
        f"{plain_loss:.7f}: rel {rel:.2e} (rtol {MOE_LOSS_RTOL})")
    if not rel <= MOE_LOSS_RTOL:
        raise AssertionError("first loss differs from the plain grouped "
                             "matmul")
    del step, opt, model, x, y
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms, losses=losses,
                peak_bytes=peak, tokens=tokens)


def routed(model, x):
    """[tokens, k] experts the model's gate picks for x."""
    with torch.no_grad():
        logits = model.moe.gate(x.reshape(-1, x.shape[-1]))
        return torch.topk(torch.softmax(logits.float(), -1), MOE_TOP_K).indices


def phase_moe_lockstep(gm):
    dim, hidden = MOE_LOCKSTEP_DIMS
    a, b = build_moe(dim, hidden), build_moe(dim, hidden)
    b.load_state_dict(a.state_dict())
    x, y = moe_batch(dim)
    params_a, params_b = list(a.parameters()), list(b.parameters())
    ga = torch.autograd.grad(moe_loss(a, x, y), params_a)
    with plain_grouped_matmul(gm):
        gb = torch.autograd.grad(moe_loss(b, x, y), params_b)
    worst_grad = 0.0
    for (n, _), u, v in zip(a.named_parameters(), ga, gb):
        _, rel = _rel(u, v)
        worst_grad = max(worst_grad, rel)
        if not rel <= MOE_GRAD_RTOL:
            raise AssertionError(f"step-1 gradient of {n} differs: rel {rel}")
    log(f"# phase 12: MoE dim {dim} hidden {hidden}: step-1 gradients of "
        f"all {len(ga)} parameters within rel {worst_grad:.2e} (rtol "
        f"{MOE_GRAD_RTOL})")
    del ga, gb
    step_a, _ = moe_trainer(a)
    step_b, _ = moe_trainer(b)
    worst = 0.0
    for i in range(LOCKSTEP_STEPS):
        alike = (routed(a, x) == routed(b, x)).float().mean().item()
        la = float(step_a(x, y))
        with plain_grouped_matmul(gm):
            lb = float(step_b(x, y))
        rel = abs(la - lb) / abs(lb)
        worst = max(worst, rel)
        log(f"step {i}: loss kernel {la:.7f} plain {lb:.7f} rel {rel:.2e}; "
            f"token slots routed alike {100 * alike:.3f} %")
    if not worst <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"lockstep losses differ: rel {worst}")


# -- phases 18-22: mixed precision ---------------------------------------------


def reset_flash(fa):
    """Zero the flash kernels' launch counts, all and bf16."""
    for kind in ("fwd", "dq", "dkv"):
        setattr(fa, f"launches_{kind}", 0)
        setattr(fa, f"launches_{kind}_bf16", 0)


def flash_counts(fa):
    return {f"{kind}{tag}": getattr(fa, f"launches_{kind}{tag}")
            for tag in ("", "_bf16") for kind in ("fwd", "dq", "dkv")}


def amp_loss(level):
    """``TrainStep``'s loss under ``auto_cast(level)``."""
    from paddle_tpu_torch.amp import auto_cast

    def loss_fn(model, ids, labels):
        with auto_cast(level=level):
            return model(ids, labels=labels)

    return loss_fn


def lr_schedule(peak):
    """Linear warmup from 10 % of ``peak``, then cosine decay to 10 %."""
    from paddle_tpu_torch.optimizer import lr

    return lr.LinearWarmup(
        lr.CosineAnnealingDecay(peak, T_max=COSINE_STEPS,
                                eta_min=peak / 10),
        warmup_steps=WARMUP_STEPS, start_lr=peak / 10, end_lr=peak)


def amp_trainer(model, adamw, level, schedule, decorate=False):
    """``TrainStep`` + ``AdamW`` (+ clip) under ``auto_cast(level)``, the
    learning rate from :func:`lr_schedule` when ``schedule``; O2 first
    ``decorate``s the model and the optimizer. Returns (step, optimizer,
    scheduler or None)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    sched = lr_schedule(adamw["learning_rate"]) if schedule else None
    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0),
                **dict(adamw, learning_rate=sched or adamw["learning_rate"]))
    if decorate:
        amp.decorate(model, opt, level="O2")
    return TrainStep(model, amp_loss(level), opt), opt, sched


def check_bf16_launches(launches, fwd_per_step, bwd_per_step, what):
    """Every flash launch of the run was bf16, and as many as the layers
    and steps give."""
    want = {"fwd": fwd_per_step, "dq": bwd_per_step, "dkv": bwd_per_step}
    for kind, n in want.items():
        if not launches[kind] == launches[f"{kind}_bf16"] == n:
            raise AssertionError(f"{what}: flash launches {launches}, want "
                                 f"{n} bf16 {kind}")


def run_steps(step, sched, ids, labels, fa):
    """TRAIN_STEPS steps from a reset peak and zeroed counts: losses, step
    ms, peak bytes and flash launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(fa)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
        if sched is not None:
            sched.step()
    return dict(losses=losses, step_ms=step_ms,
                peak_bytes=torch.cuda.max_memory_allocated(),
                launches=flash_counts(fa), tokens=ids.numel())


def report_steps(r, smi, f32=None):
    """Log a run's steps, beside the f32 run's where given."""
    for i, (l, ms) in enumerate(zip(r["losses"], r["step_ms"])):
        log(f"step {i}: loss {l:.6f}, {ms:.1f} ms, "
            f"{r['tokens'] / ms * 1e3:.1f} tokens/s")
    ms = float(np.mean(r["step_ms"][1:]))
    r["mean_ms"] = ms
    r["tokens_per_s"] = r["tokens"] / ms * 1e3
    r["peak_gib"] = r["peak_bytes"] / 2 ** 30
    line = (f"steps 1-{TRAIN_STEPS - 1} mean {ms:.1f} ms = "
            f"{r['tokens_per_s']:.1f} tokens/s; peak memory "
            f"{r['peak_gib']:.2f} GiB; launches {r['launches']}")
    if f32 is not None:
        f32_ms = float(np.mean(f32["step_ms"][1:]))
        line += (f"; f32 (same weights) {f32_ms:.1f} ms = "
                 f"{f32['tokens'] / f32_ms * 1e3:.1f} tokens/s, "
                 f"{f32['peak_bytes'] / 2 ** 30:.2f} GiB: "
                 f"{f32_ms / ms:.2f}x")
    log(f"{line}  [{smi}]")
    if not all(np.isfinite(r["losses"])):
        raise AssertionError(f"non-finite loss {r['losses']}")
    if not r["losses"][-1] < r["losses"][0]:
        raise AssertionError(f"loss did not fall: {r['losses']}")


def check_first_loss(r, f32, what):
    rel = abs(r["losses"][0] - f32["losses"][0]) / abs(f32["losses"][0])
    log(f"first loss bf16 {r['losses'][0]:.7f} vs f32 "
        f"{f32['losses'][0]:.7f}: rel {rel:.2e} (rtol {AMP_LOSS_RTOL:.2e})")
    if not rel <= AMP_LOSS_RTOL:
        raise AssertionError(f"{what}: first bf16 loss differs from f32")
    r["first_loss_rel"] = rel


def phase_amp_training(fa, smi, build, adamw, label, phase, level, f32,
                       schedule, decorate=False):
    """TRAIN_STEPS steps under ``auto_cast(level)``: the loss falls, K1 /
    K2a / K2b launch in bf16 once a layer a step; at O1 the first loss is
    within AMP_LOSS_RTOL of the f32 run's (``f32``, same weights and
    batch); at O2 every parameter is bf16 and every moment f32."""
    t0 = time.perf_counter()
    model = build()
    step, opt, sched = amp_trainer(model, adamw, level, schedule, decorate)
    ids, labels = train_batch(model.config.vocab_size)
    log(f"# phase {phase}: {label}, {level}"
        f"{' decorated' if decorate else ''}, lr "
        f"{'warmup + cosine' if schedule else 'held'}: built in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    r = run_steps(step, sched, ids, labels, fa)
    report_steps(r, smi, f32)
    layers = model.config.num_hidden_layers
    check_bf16_launches(r["launches"], layers * TRAIN_STEPS,
                        layers * TRAIN_STEPS, label)
    if level == "O1":
        check_first_loss(r, f32, label)
    if decorate:
        params = {p.dtype for p in model.parameters()}
        moments = {v.dtype for st in opt._accumulators
                   for k, v in st.items() if k.startswith("moment")}
        masters = {m.dtype for m in opt._master.values()}
        log(f"parameters {params}, moments {moments}, {len(opt._master)} "
            f"masters {masters}")
        if params != {torch.bfloat16} or moments != {torch.float32}:
            raise AssertionError("O2: parameters must stay bf16 and "
                                 "moments f32")
        if masters != {torch.float32} or \
                len(opt._master) != len(opt._parameter_list):
            raise AssertionError("O2: every bf16 parameter needs its f32 "
                                 "master")
    if sched is not None:
        log(f"lr now {opt.get_lr():.4e} after {TRAIN_STEPS} steps")
    del step, opt, model
    torch.cuda.empty_cache()
    return r


def o1_grads(model, ids, labels):
    """Loss and gradients (on the host) of one O1 forward and backward,
    and the peak memory they took on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = amp_loss("O1")(model, ids, labels)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return loss.detach().cpu(), [g.cpu() for g in grads], peak


def phase_recompute(fa, smi, o1, phase):
    """GPT-3 1.3B at O1 with ``use_recompute`` (granularity "full"): the
    step-1 loss and every gradient bit-equal to the run without, K1 twice
    a layer a step and K2a / K2b once, and the training step's peak memory
    below phase 18's (``o1``: the same model, batch and optimizer without
    recompute). The forward + backward's peaks on fresh models, with and
    without, are reported beside it."""
    build = lambda rc: build_model(24, use_recompute=rc)  # noqa: E731
    model = build(False)
    ids, labels = train_batch(model.config.vocab_size)
    want_loss, want, peak_without = o1_grads(model, ids, labels)
    del model
    torch.cuda.empty_cache()
    model = build(True)
    reset_flash(fa)
    loss, got, peak_with = o1_grads(model, ids, labels)
    one = flash_counts(fa)
    layers = model.config.num_hidden_layers
    check_bf16_launches(one, 2 * layers, layers, "recompute, one step")
    unequal = [n for (n, _), u, v in zip(model.named_parameters(), got, want)
               if not torch.equal(u, v)]
    log(f"# phase {phase}: GPT-3 1.3B O1, use_recompute (full): step-1 "
        f"loss {float(loss):.7f} vs {float(want_loss):.7f} without; "
        f"{len(got) - len(unequal)}/{len(got)} gradients bit-equal; "
        f"launches {one}; forward + backward peak memory "
        f"{peak_with / 2 ** 30:.2f} GiB with recompute, "
        f"{peak_without / 2 ** 30:.2f} GiB without  [{smi}]")
    if not torch.equal(loss, want_loss) or unequal:
        raise AssertionError(f"recompute changed the loss or gradients: "
                             f"{unequal[:5]}")
    del got, want
    step, opt, sched = amp_trainer(model, ADAMW, "O1", schedule=True)
    r = run_steps(step, sched, ids, labels, fa)
    report_steps(r, smi, None)
    check_bf16_launches(r["launches"], 2 * layers * TRAIN_STEPS,
                        layers * TRAIN_STEPS, "recompute")
    log(f"training step peak memory with recompute {r['peak_gib']:.2f} GiB,"
        f" without {o1['peak_gib']:.2f} GiB (phase 18)")
    if not r["peak_bytes"] < o1["peak_bytes"]:
        raise AssertionError("recompute did not lower the training step's "
                             "peak memory")
    r["fwd_bwd_peak_gib"] = peak_with / 2 ** 30
    r["fwd_bwd_peak_gib_without"] = peak_without / 2 ** 30
    del step, opt, model
    torch.cuda.empty_cache()
    return r


def phase_amp_lockstep(fa, build, adamw, label, phase):
    """A kernel trainer and a plain-attention trainer under O1 from the
    same weights: step-1 gradients, then LOCKSTEP_STEPS losses."""
    a, b = build(), build()
    b.load_state_dict(a.state_dict())
    ids, labels = train_batch(a.config.vocab_size)
    loss_fn = amp_loss("O1")
    ga = torch.autograd.grad(loss_fn(a, ids, labels), list(a.parameters()))
    with plain_attention(fa):
        gb = torch.autograd.grad(loss_fn(b, ids, labels),
                                 list(b.parameters()))
    worst_grad, worst_name = 0.0, None
    for (n, _), u, v in zip(a.named_parameters(), ga, gb):
        _, rel = _rel(u, v)
        if rel > worst_grad:
            worst_grad, worst_name = rel, n
    log(f"# phase {phase}: {label}, O1: step-1 gradients of all {len(ga)} "
        f"parameters within rel {worst_grad:.2e} ({worst_name}; rtol "
        f"{AMP_GRAD_RTOL:.2e})")
    if not worst_grad <= AMP_GRAD_RTOL:
        raise AssertionError(f"O1 lockstep gradient of {worst_name} "
                             f"differs: rel {worst_grad}")
    del ga, gb
    step_a, _, _ = amp_trainer(a, adamw, "O1", schedule=False)
    step_b, _, _ = amp_trainer(b, adamw, "O1", schedule=False)
    worst = 0.0
    for i in range(LOCKSTEP_STEPS):
        la = float(step_a(ids, labels))
        with plain_attention(fa):
            lb = float(step_b(ids, labels))
        rel = abs(la - lb) / abs(lb)
        worst = max(worst, rel)
        log(f"step {i}: loss kernel {la:.7f} plain {lb:.7f} rel {rel:.2e}")
    if not worst <= AMP_LOCKSTEP_LOSS_RTOL:
        raise AssertionError(f"O1 lockstep losses differ: rel {worst}")
    del step_a, step_b, a, b
    torch.cuda.empty_cache()


def phases_amp(fa, smi, gpt_f32, llama_f32):
    """Phases 18-22; returns their numbers for the ``amp`` JSON line."""
    o1 = phase_amp_training(fa, smi, lambda: build_model(24), ADAMW,
                            "GPT-3 1.3B", 18, "O1", gpt_f32, schedule=True)
    o2 = phase_amp_training(fa, smi, lambda: build_model(24), ADAMW,
                            "GPT-3 1.3B", 19, "O2", gpt_f32, schedule=True,
                            decorate=True)
    rc = phase_recompute(fa, smi, o1, 20)
    llama = phase_amp_training(
        fa, smi, lambda: build_llama(LLAMA_TRAIN_LAYERS), LLAMA_ADAMW,
        f"Llama-3-8B widths at depth {LLAMA_TRAIN_LAYERS}", 21, "O1",
        llama_f32, schedule=False)
    phase_amp_lockstep(fa, lambda: build_model(2), ADAMW,
                       "GPT-3 1.3B depth 2", 22)
    keys = ("mean_ms", "tokens_per_s", "peak_gib", "launches", "losses")
    out = {name: {k: r[k] for k in keys}
           for name, r in (("gpt_o1", o1), ("gpt_o2", o2),
                           ("gpt_o1_recompute", rc), ("llama_o1", llama))}
    for name, r in (("gpt_o1", o1), ("llama_o1", llama)):
        out[name]["first_loss_rel_f32"] = r["first_loss_rel"]
    for k in ("fwd_bwd_peak_gib", "fwd_bwd_peak_gib_without"):
        out["gpt_o1_recompute"][k] = rc[k]
    out["card"] = smi
    return out


# -- phases 23-26: the encoders, through paddle.Model and TrainStep ----------

# ERNIE-3.0-base (the reference's ErnieConfig.ernie3_base, PaddleNLP's
# ernie-3.0-base-zh: hidden 768, 12 layers, 12 heads, FFN 3072, vocab
# 40000, dropouts 0.1) fine-tuned as a 2-class sentence-pair classifier:
# batch 32 at max_seq_length 128, real lengths 16-128; AdamW at PaddleNLP's
# fine-tune settings (lr 3e-5, weight decay 0.01) under a linear warmup
# into a linear decay to 0
ERNIE_BATCH, ERNIE_SEQ, ERNIE_MIN_LEN = 32, 128, 16
ERNIE_STEPS, ERNIE_EVAL_BATCHES = 32, 8
ERNIE_LR, ERNIE_WD, ERNIE_WARMUP = 3e-5, 0.01, 3
CLS_ID, SEP_ID, MASK_ID = 1, 2, 103
# evaluate's logits, kernel vs plain attention on the same weights: each of
# the 12 layers' attention may differ by FLASH_TOL (relative, f32), and the
# post-LN blocks renormalise between layers, so the differences add: 12 x
# FLASH_TOL of the largest logit
ENCODER_LOGIT_RTOL = 12 * FLASH_TOL[torch.float32]
# BERT-base masked-LM pretraining (Devlin et al. 2019: L=12, H=768, A=12,
# vocab 30522; the reference's BertConfig defaults) at sequence 512, batch
# 8: AdamW with the paper's settings (lr 1e-4, beta2 0.999, eps 1e-6,
# weight decay 0.01) and a clip at 1.0; 15 % of the real tokens labelled
BERT_BATCH, BERT_SEQ, BERT_STEPS, MLM_SHARE = 8, 512, 4, 0.15
BERT_ADAMW = dict(learning_rate=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-6,
                  weight_decay=0.01)
ERNIE_BLOCKS = 12


class PairData:
    """Synthetic sentence pairs as a tokenizer pads them: ``[CLS] a [SEP] b
    [SEP]`` then 0s up to ``seq``, token types 0 on ``a`` and 1 on ``b``,
    keep-mask 1 on the real tokens, real lengths drawn from the seed. A
    sample's class (1 for three samples in four, as in an imbalanced
    sentiment set) shows in its tokens: a quarter of them come from that
    class's 16 cue ids, so the label is a function of the tokens. Samples
    are numpy (the DataLoader's worker processes stack them)."""

    CUE_IDS = (1000, 2000)  # class c's cues: CUE_IDS[c] + 0..15

    def __init__(self, n, vocab, seq, seed):
        rng = np.random.default_rng(seed)
        self.lengths = rng.integers(ERNIE_MIN_LEN, seq + 1, n)
        self.labels = (rng.random(n) < 0.75).astype(np.int64)
        self.ids = np.zeros((n, seq), np.int64)
        self.types = np.zeros((n, seq), np.int64)
        self.mask = np.zeros((n, seq), np.int64)
        for i, real in enumerate(self.lengths):
            body = rng.integers(SEP_ID + 1, vocab, real)
            cue = rng.random(real) < 0.25
            body[cue] = self.CUE_IDS[self.labels[i]] + rng.integers(
                0, 16, int(cue.sum()))
            half = real // 2
            body[0], body[half - 1], body[real - 1] = CLS_ID, SEP_ID, SEP_ID
            self.ids[i, :real] = body
            self.types[i, half:real] = 1
            self.mask[i, :real] = 1

    def __getitem__(self, i):
        return self.ids[i], self.types[i], self.mask[i], self.labels[i]

    def __len__(self):
        return len(self.labels)


def build_ernie(layers=ERNIE_BLOCKS, dropout=0.1):
    from paddle_tpu_torch.text.models.ernie import (
        ErnieConfig, ErnieForSequenceClassification)

    kw = dict(hidden_dropout_prob=dropout,
              attention_probs_dropout_prob=dropout)
    # ernie3_base fixes the depth; a cut depth keeps its widths
    cfg = (ErnieConfig.ernie3_base(**kw) if layers == ERNIE_BLOCKS else
           ErnieConfig(hidden_size=768, num_hidden_layers=layers,
                       num_attention_heads=12, **kw))
    return ErnieForSequenceClassification(cfg, num_classes=2, device=DEVICE,
                                          seed=SEED)


def ernie_model(net, steps=None):
    """``paddle.Model`` of ``net`` prepared as the fine-tune: AdamW with a
    linear warmup into a linear decay over ``steps`` (without ``steps``,
    ERNIE_LR held), cross entropy, accuracy."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW, lr

    sched = ERNIE_LR if steps is None else lr.LinearWarmup(
        lr.PolynomialDecay(ERNIE_LR, decay_steps=steps - ERNIE_WARMUP,
                           end_lr=0.0),
        warmup_steps=ERNIE_WARMUP, start_lr=0.0, end_lr=ERNIE_LR)
    opt = AdamW(learning_rate=sched, parameters=net.parameters(),
                weight_decay=ERNIE_WD)
    return Model(net).prepare(opt, CrossEntropyLoss(), Accuracy())


@contextlib.contextmanager
def flash_calls(fa):
    """Record how each K1 / K2a / K2b launch was called: ``{kind: [(causal,
    bias shape or None, want_ds), ...]}`` (launches through the kernels
    only: a ``plain_attention`` block inside records nothing)."""
    calls = {"fwd": [], "dq": [], "dkv": []}
    names = {"fwd": "forward", "dq": "bwd_dq", "dkv": "bwd_dkv"}
    saved = {k: getattr(fa, f"flash_attention_{n}_cuda")
             for k, n in names.items()}

    def spy(kind):
        real = saved[kind]

        def call(q, k, v, bias=None, *a, causal=False, **kw):
            calls[kind].append((causal, None if bias is None
                                else tuple(bias.shape),
                                kw.get("want_ds", False)))
            return real(q, k, v, bias, *a, causal=causal, **kw)
        return call

    try:
        for k, n in names.items():
            setattr(fa, f"flash_attention_{n}_cuda", spy(k))
        yield calls
    finally:
        for k, n in names.items():
            setattr(fa, f"flash_attention_{n}_cuda", saved[k])


def check_padded_calls(calls, kinds, n, bias_shape, what):
    """Each kind launched ``n`` times, all non-causal with the padding bias
    of ``bias_shape`` and no dS."""
    want = [(False, bias_shape, False)] * n
    for kind in kinds:
        if calls[kind] != want:
            got = sorted(set(calls[kind]))
            raise AssertionError(f"{what}: {kind} launched "
                                 f"{len(calls[kind])} times as {got}, want "
                                 f"{n} x non-causal, bias {bias_shape}, "
                                 "no dS")


def _clock():
    """A callback timing each training step (the batch is on the card at
    ``on_train_batch_begin``; ``train_batch`` syncs on the loss)."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        def __init__(self):
            super().__init__()
            self.ms, self.losses = [], []

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.ms.append(1e3 * (time.perf_counter() - self._t0))
            self.losses.append(logs["loss"])

    return StepClock()


def phase_ernie_finetune(fa, smi):
    """Phase 23: ERNIE-3.0-base at full width and depth fine-tuned through
    ``Model.fit`` over a ``DataLoader`` (shuffled, 2 worker processes),
    then ``evaluate`` and ``predict``."""
    from paddle_tpu_torch.io import DataLoader

    t0 = time.perf_counter()
    net = build_ernie()
    cfg = net.config
    train = PairData(ERNIE_STEPS * ERNIE_BATCH, cfg.vocab_size, ERNIE_SEQ,
                     SEED + 20)
    evals = PairData(ERNIE_EVAL_BATCHES * ERNIE_BATCH, cfg.vocab_size,
                     ERNIE_SEQ, SEED + 21)
    model = ernie_model(net, ERNIE_STEPS)
    np.random.seed(SEED)
    loader = DataLoader(train, batch_size=ERNIE_BATCH, shuffle=True,
                        num_workers=2, device=DEVICE)
    eval_loader = DataLoader(evals, batch_size=ERNIE_BATCH, num_workers=2,
                             device=DEVICE)
    real = []
    hook = net.register_forward_pre_hook(
        lambda m, args: real.append(args[2].sum()) if len(args) > 2
        else None)
    n_params = sum(p.numel() for p in net.parameters())
    log(f"# phase 23: ERNIE-3.0-base fine-tune ({n_params / 1e6:.1f} M "
        f"parameters, dropouts {cfg.hidden_dropout_prob}) built in "
        f"{time.perf_counter() - t0:.2f} s (set-up); {ERNIE_STEPS} steps of "
        f"{ERNIE_BATCH} x {ERNIE_SEQ} (real lengths "
        f"{ERNIE_MIN_LEN}-{ERNIE_SEQ}), 2 worker processes")
    clock = _clock()
    torch.cuda.synchronize()
    reset_flash(fa)
    with flash_calls(fa) as fit_calls:
        model.fit(loader, epochs=1, verbose=0, callbacks=[clock])
    fit_launches = flash_counts(fa)
    train_real = [int(r) for r in real]
    del real[:]
    # steps 2 on (the first pays the cuBLAS handles and the allocator)
    ms = float(np.mean(clock.ms[1:]))
    padded = ERNIE_BATCH * ERNIE_SEQ
    real_mean = float(np.mean(train_real[1:]))
    losses = clock.losses
    log(f"losses {[round(x, 4) for x in losses]}")
    log(f"steps 2-{ERNIE_STEPS} mean {ms:.2f} ms = "
        f"{ERNIE_BATCH / ms * 1e3:.1f} samples/s, "
        f"{padded / ms * 1e3:.0f} padded tokens/s, "
        f"{real_mean / ms * 1e3:.0f} real tokens/s ({real_mean:.0f} of "
        f"{padded} a step); flash launches in fit {fit_launches} "
        f"(attention dropout {cfg.attention_probs_dropout_prob}: the dense "
        f"route, as the reference)  [{smi}]")
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"fine-tune loss did not fall: first 4 mean "
                             f"{first}, last 4 mean {last}")
    if any(fit_launches.values()) or any(fit_calls.values()):
        raise AssertionError(f"fit launched flash kernels {fit_launches}: "
                             "training attention with dropout takes the "
                             "dense route")

    bias_shape = (ERNIE_BATCH, 1, 1, ERNIE_SEQ)
    n_eval = ERNIE_BLOCKS * ERNIE_EVAL_BATCHES
    outs = []
    capture = net.register_forward_hook(
        lambda m, args, out: outs.append(out.detach()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(fa)
    with flash_calls(fa) as calls:
        t1 = time.perf_counter()
        result = model.evaluate(eval_loader, verbose=0)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t1
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eval_launches = fa.launches_fwd
    check_padded_calls(calls, ("fwd",), n_eval, bias_shape, "evaluate")
    if calls["dq"] or calls["dkv"]:
        raise AssertionError("evaluate launched a backward kernel")
    logits = torch.cat(outs).float().cpu().numpy()
    outs.clear()
    with plain_attention(fa):
        plain_result = model.evaluate(eval_loader, verbose=0)
    plain = torch.cat(outs).float().cpu().numpy()
    capture.remove()
    hook.remove()
    eval_real = sum(int(r) for r in real[:ERNIE_EVAL_BATCHES])
    n_eval_samples = ERNIE_EVAL_BATCHES * ERNIE_BATCH
    # the same evaluate over an in-process loader: what the worker
    # processes' start-up costs an 8-batch evaluate
    t1 = time.perf_counter()
    model.evaluate(DataLoader(evals, batch_size=ERNIE_BATCH, device=DEVICE),
                   verbose=0)
    torch.cuda.synchronize()
    eval_s0 = time.perf_counter() - t1
    log(f"evaluate {result}: {n_eval_samples / eval_s:.1f} samples/s "
        f"({eval_s * 1e3:.1f} ms for {ERNIE_EVAL_BATCHES} batches, "
        f"{eval_real} real tokens; {n_eval_samples / eval_s0:.1f} "
        f"samples/s over an in-process loader), peak {eval_peak:.2f} GiB, "
        f"K1 {eval_launches} launches = {ERNIE_BLOCKS} layers x "
        f"{ERNIE_EVAL_BATCHES} batches, non-causal, bias {bias_shape}  "
        f"[{smi}]")
    if not 0.0 <= result["acc"] <= 1.0 or not np.isfinite(result["loss"]):
        raise AssertionError(f"evaluate gave {result}")
    err = float(np.abs(logits - plain).max())
    scale = float(np.abs(plain).max())
    log(f"evaluate's logits {logits.shape}, kernel vs plain attention "
        f"(plain: {plain_result}): max|err| {err:.3e} = {err / scale:.2e} "
        f"of max|logit| {scale:.3f} (rtol {ENCODER_LOGIT_RTOL:.1e})")
    if logits.shape != (n_eval_samples, 2) or \
            not np.isfinite(logits).all():
        raise AssertionError(f"evaluate gave {logits.shape} logits")
    if not err <= ENCODER_LOGIT_RTOL * scale:
        raise AssertionError("evaluate's logits differ from the plain "
                             "attention's")

    # predict feeds a batch's first field only (the reference's
    # Model.predict): the ids, with no attention mask, so K1 runs
    # non-causal without a bias
    reset_flash(fa)
    with flash_calls(fa) as calls:
        predicted = model.predict(eval_loader, stack_outputs=True)[0]
    predict_launches = fa.launches_fwd
    check_padded_calls(calls, ("fwd",), n_eval, None, "predict")
    log(f"predict (ids only, as the reference): outputs "
        f"{predicted.shape}, K1 {predict_launches} launches, non-causal, "
        f"no bias")
    if predicted.shape != (n_eval_samples, 2) or \
            not np.isfinite(predicted).all():
        raise AssertionError(f"predict gave {predicted.shape} outputs")
    out = dict(step_ms=ms, samples_per_s=ERNIE_BATCH / ms * 1e3,
               padded_tokens_per_s=padded / ms * 1e3,
               real_tokens_per_s=real_mean / ms * 1e3, losses=losses,
               fit_launches=fit_launches, eval=result,
               eval_samples_per_s=n_eval_samples / eval_s,
               eval_samples_per_s_in_process=n_eval_samples / eval_s0,
               eval_peak_gib=eval_peak, eval_launches_fwd=eval_launches,
               predict_launches_fwd=predict_launches,
               logit_err_vs_plain=err, card=smi)
    del model, net, loader, eval_loader
    torch.cuda.empty_cache()
    return out


def phase_ernie_lockstep(fa):
    """Phase 24: ERNIE at depth 2 with dropouts 0, a kernel model and a
    plain-attention model from the same weights through
    ``Model.train_batch`` for LOCKSTEP_STEPS steps on one batch: the
    losses agree, K1 / K2a / K2b run once a layer a step, non-causal with
    the padding bias and no dS."""
    from paddle_tpu_torch.io import DataLoader

    a, b = build_ernie(2, 0.0), build_ernie(2, 0.0)
    b.load_state_dict(a.state_dict())
    ma, mb = ernie_model(a), ernie_model(b)
    data = PairData(ERNIE_BATCH, a.config.vocab_size, ERNIE_SEQ, SEED + 22)
    *xs, ys = next(iter(DataLoader(data, batch_size=ERNIE_BATCH,
                                   device=DEVICE)))
    worst = 0.0
    reset_flash(fa)
    with flash_calls(fa) as calls:
        for i in range(LOCKSTEP_STEPS):
            la = ma.train_batch(xs, ys)[0]
            with plain_attention(fa):
                lb = mb.train_batch(xs, ys)[0]
            rel = abs(la - lb) / abs(lb)
            worst = max(worst, rel)
            log(f"# phase 24: ERNIE depth 2 step {i}: loss kernel {la:.7f} "
                f"plain {lb:.7f} rel {rel:.2e}")
    launches = flash_counts(fa)
    n = 2 * LOCKSTEP_STEPS
    check_padded_calls(calls, ("fwd", "dq", "dkv"), n,
                       (ERNIE_BATCH, 1, 1, ERNIE_SEQ), "lockstep")
    log(f"launches {launches} = 2 layers x {LOCKSTEP_STEPS} steps, "
        f"non-causal, padding bias, no dS; worst loss rel {worst:.2e} "
        f"(rtol {TRAIN_LOSS_RTOL})")
    if not worst <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"ERNIE lockstep losses differ: rel {worst}")
    del ma, mb, a, b
    torch.cuda.empty_cache()
    return launches


def mlm_batch(vocab):
    """BERT_BATCH sequences padded to BERT_SEQ (real lengths 128-512 drawn
    from the seed) of Zipf-distributed ids, as natural text is; 15 % of
    the real tokens between [CLS] and [SEP] replaced by [MASK] and
    labelled with the original id, the rest -100; token types 0 then 1
    from the middle."""
    rng = np.random.default_rng(SEED + 23)
    b, t = BERT_BATCH, BERT_SEQ
    lengths = rng.integers(128, t + 1, b)
    lengths[0] = t
    ids = np.zeros((b, t), np.int64)
    types = np.zeros((b, t), np.int64)
    mask = np.zeros((b, t), np.int64)
    labels = np.full((b, t), -100, np.int64)
    for i, real in enumerate(lengths):
        body = np.minimum(rng.zipf(1.3, real) + MASK_ID, vocab - 1)
        body[0], body[real - 1] = CLS_ID, SEP_ID
        picked = np.flatnonzero(rng.random(real - 2) < MLM_SHARE) + 1
        labels[i, picked] = body[picked]
        body[picked] = MASK_ID
        ids[i, :real] = body
        types[i, real // 2:real] = 1
        mask[i, :real] = 1
    return [torch.as_tensor(x, device=DEVICE)
            for x in (ids, types, mask, labels)], int(lengths.sum())


def build_bert():
    """BERT-base for masked-LM pretraining, attention dropout 0 (the
    kernels carry no dropout, as the reference's Pallas route)."""
    from paddle_tpu_torch.text.models.bert import BertConfig, BertForMaskedLM

    return BertForMaskedLM(BertConfig(attention_probs_dropout_prob=0.0),
                           device=DEVICE, seed=SEED)


def bert_trainer(level):
    """``TrainStep`` + AdamW (+ clip) on BERT-base from the seed, in f32
    (``level`` None) or under ``auto_cast(level)``, and its batch."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    model = build_bert()
    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **BERT_ADAMW)

    def loss_fn(m, ids, types, mask, labels):
        with amp.auto_cast(enable=level is not None, level=level or "O1"):
            return m(ids, types, attention_mask=mask, labels=labels)

    batch, real = mlm_batch(model.config.vocab_size)
    return TrainStep(model, loss_fn, opt), batch, real


def bert_run(fa, level):
    """BERT_STEPS steps of :func:`bert_trainer` from a reset peak and
    zeroed counts."""
    step, batch, real = bert_trainer(level)
    torch.manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(fa)
    losses, step_ms = [], []
    with flash_calls(fa) as calls:
        for _ in range(BERT_STEPS):
            t0 = time.perf_counter()
            loss = step(*batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(loss))
    r = dict(losses=losses, step_ms=step_ms, launches=flash_counts(fa),
             peak_bytes=torch.cuda.max_memory_allocated(),
             tokens=batch[0].numel(), real_tokens=real, calls=calls)
    del step
    torch.cuda.empty_cache()
    return r


def phase_bert_mlm(fa, smi):
    """Phase 25: BERT-base masked-LM pretraining at T = 512 in f32 and
    under O1: the loss falls, K1 / K2a / K2b launch 12 x BERT_STEPS times
    (bf16 under O1), non-causal with the padding bias; the first O1 loss
    lies within AMP_LOSS_RTOL of the f32 one."""
    out = {}
    n = ERNIE_BLOCKS * BERT_STEPS
    bias_shape = (BERT_BATCH, 1, 1, BERT_SEQ)
    for level in (None, "O1"):
        label = "f32" if level is None else level
        r = bert_run(fa, level)
        ms = float(np.mean(r["step_ms"][1:]))
        log(f"# phase 25: BERT-base MLM {label}, {BERT_BATCH} x {BERT_SEQ} "
            f"({r['real_tokens']} real tokens): losses "
            f"{[round(x, 5) for x in r['losses']]}, steps 2-{BERT_STEPS} "
            f"{ms:.2f} ms = {r['tokens'] / ms * 1e3:.0f} tokens/s "
            f"({r['real_tokens'] / ms * 1e3:.0f} real), peak "
            f"{r['peak_bytes'] / 2 ** 30:.2f} GiB, launches {r['launches']}"
            f"  [{smi}]")
        if not all(np.isfinite(r["losses"])) or \
                not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"BERT {label}: loss did not fall: "
                                 f"{r['losses']}")
        check_padded_calls(r["calls"], ("fwd", "dq", "dkv"), n, bias_shape,
                           f"BERT {label}")
        want_bf16 = n if level else 0
        if any(r["launches"][f"{k}_bf16"] != want_bf16
               for k in ("fwd", "dq", "dkv")):
            raise AssertionError(f"BERT {label}: launches {r['launches']}, "
                                 f"want {want_bf16} in bf16")
        out[label] = dict(step_ms=ms, tokens_per_s=r["tokens"] / ms * 1e3,
                          real_tokens_per_s=r["real_tokens"] / ms * 1e3,
                          peak_gib=r["peak_bytes"] / 2 ** 30,
                          launches=r["launches"], losses=r["losses"])
    f32, o1 = out["f32"]["losses"][0], out["O1"]["losses"][0]
    rel = abs(o1 - f32) / abs(f32)
    log(f"first loss O1 {o1:.6f} vs f32 {f32:.6f}: rel {rel:.2e} (rtol "
        f"{AMP_LOSS_RTOL:.2e})")
    if not rel <= AMP_LOSS_RTOL:
        raise AssertionError("BERT: first O1 loss differs from f32")
    out["first_loss_rel_f32"] = rel
    out["card"] = smi
    return out


def phase_encoder_flash_timing(fa, peaks, label, b, t, h=12, d=64):
    """K1, K2a, K2b at an encoder's shapes: non-causal, q / k / v strided
    out of the fused projection, the padding bias [b, 1, 1, t]; each
    checked against its plain version, K1 timed in turns with SDPA's
    forward and K2a + K2b with SDPA's backward under the same additive
    mask, beside the plain versions and the bound; f32 and bf16."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = flash_inputs(gen, b, t, t, h, h, d, dt, True)
        bias = padding_bias(gen, b, t)
        worst = {}
        tag = f"{label} B={b} T={t} H={h} D={d} {str(dt)[6:]}"
        compare_flash(fa, q, k, v, do, bias, False, False, worst, tag)
        o, lse = fa.flash_attention_forward_cuda(q, k, v, bias)
        delta = fa._delta(o, do).contiguous()
        calls = {
            "fwd": (lambda: fa.flash_attention_forward_cuda(q, k, v, bias),
                    lambda: fa.flash_attention_forward_plain(q, k, v, bias)),
            "dq": (lambda: fa.flash_attention_bwd_dq_cuda(
                       q, k, v, bias, do, lse, delta),
                   lambda: fa.flash_attention_bwd_dq_plain(
                       q, k, v, bias, do, lse, delta)),
            "dkv": (lambda: fa.flash_attention_bwd_dkv_cuda(
                        q, k, v, bias, do, lse, delta),
                    lambda: fa.flash_attention_bwd_dkv_plain(
                        q, k, v, bias, do, lse, delta)),
        }

        def pair():
            calls["dq"][0]()
            calls["dkv"][0]()

        yard = sdpa_yardsticks(q, k, v)[0]
        mask = bias.to(dt)
        lib_label, turns, bturns = time_in_turns(
            calls["fwd"][0], pair, yard, do, {"attn_mask": mask})
        lib_fwd = (turns[1] + turns[2]) / 2
        lib_bwd = (bturns[1] + bturns[2]) / 2
        pair_ms = (bturns[0] + bturns[3]) / 2
        for kind, (kern, plain) in calls.items():
            ms = ((turns[0] + turns[3]) / 2 if kind == "fwd"
                  else cuda_ms(kern))
            plain_ms = cuda_ms(plain, iters=5, warm=1)
            lib = lib_fwd if kind == "fwd" else lib_bwd
            r = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                     max_abs_err=worst[kind],
                     **flash_bound(kind, q, k, False, peaks, bias))
            if kind != "fwd":
                r["pair_ms"] = pair_ms
            rows[(kind, dt)] = r
            log(f"{kind:3s} {tag} padded: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa "
                f"{'forward' if kind == 'fwd' else 'backward (dq+dk+dv)'} "
                f"[{lib_label}, attn_mask] {lib:.4f} ms, "
                f"{bound_text(r, ms)}")
        log(f"pair {tag}: K2a + K2b {pair_ms:.4f} ms vs sdpa backward "
            f"{lib_bwd:.4f} ms = {pair_ms / lib_bwd:.3f}x")
        del q, k, v, do, o, lse, delta, yard
        torch.cuda.empty_cache()
    return rows


def phases_encoders(fa, smi, peaks):
    """Phases 23-26; returns the ``encoders`` JSON line's numbers and the
    timed rows per shape."""
    finetune = phase_ernie_finetune(fa, smi)
    lockstep = phase_ernie_lockstep(fa)
    bert = phase_bert_mlm(fa, smi)
    log("# phase 26: K1 / K2 at the encoders' shapes, padding bias")
    timed = {
        "ernie": phase_encoder_flash_timing(fa, peaks, "ERNIE",
                                            ERNIE_BATCH, ERNIE_SEQ),
        "bert": phase_encoder_flash_timing(fa, peaks, "BERT", BERT_BATCH,
                                           BERT_SEQ),
    }
    line = {"ernie_finetune": finetune, "ernie_lockstep_launches": lockstep,
            "bert_mlm": bert,
            "flash": {f"{shape} {kind} {str(dt)[6:]}": {
                k: r[k] for k in ("ms", "plain_ms", "library_ms", "pair_ms",
                                  "bound_ms", "bound_fma_ms") if k in r}
                for shape, rows in timed.items()
                for (kind, dt), r in rows.items()}, "card": smi}
    return line, timed, lockstep


# -- phases 27-30: ResNet-50 --------------------------------------------------

# ResNet-50 (He et al. 2016, Table 1; the reference's resnet50(num_classes=
# 1000)) at 224 x 224, batch 256, trained with the repo's own benchmark
# recipe (bench_configs.py::run_resnet50): Momentum(0.1, 0.9, weight decay
# 1e-4), cross entropy, one fixed batch of standard-normal images and
# uniform labels
RESNET_BATCH, RESNET_HW, RESNET_CLASSES, RESNET_STEPS = 256, 224, 1000, 12
RESNET_LR = 0.1
RESNET_MOMENTUM = dict(momentum=0.9, weight_decay=1e-4)
# the learning rate ramps linearly from lr / 10 to lr over the 12 steps
# (Goyal et al. 2017, section 2.2's gradual warmup). At a constant 0.1
# from random weights the fixed batch's loss climbs back over steps 5-9,
# and the gate's margin (the mean of the first 4 steps' losses less the
# last 4's) was 0.17 and 0.27 in two runs, -0.84 over 16 steps; a 4- or
# 8-step warmup moves the bump later (0.94, 0.60); the 12-step ramp gave
# 1.53 with the loss falling almost throughout (scripts/
# resnet_warmup_sweep.py on an H100; cuDNN's algorithms sum in a
# run-dependent order, and the trajectory amplifies it)
RESNET_WARMUP_STEPS, RESNET_WARMUP_START = 12, 0.01
# a training image costs 3 forwards: ResNet-50's 4.1 GMAC (8.2 GFLOP)
# forward, and a backward of twice that
RESNET_TRAIN_FLOP = 3 * 8.2e9
RESNET_PARAMS = 25_557_032
# phase 29: paddle.Model over FakeData through the ImageNet transforms
FIT_STEPS, EVAL_BATCHES, FAKE_HW = 8, 4, 256
IMAGENET_MEAN, IMAGENET_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
# phase 30, card against CPU, as max|err| / max|CPU|: f32 sums in other
# orders (cuDNN's algorithms, TF32 off) through 50 layers
CARD_CPU_RTOL = 1e-4
# the op sweep: one conv / pool, f32 sums of at most a few hundred terms
OP_SWEEP_RTOL = 1e-5


def build_resnet(**kw):
    from paddle_tpu_torch.vision.models import resnet50

    return resnet50(device=kw.pop("device", DEVICE), seed=SEED, **kw)


def resnet_batch():
    """The fixed batch, made with numpy from the seed as the reference's
    benchmark makes it, then put on the card once."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((RESNET_BATCH, 3, RESNET_HW, RESNET_HW),
                            dtype=np.float32)
    y = rng.integers(0, RESNET_CLASSES, (RESNET_BATCH,))
    return torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE)


def resnet_trainer(model, level):
    """``TrainStep`` + ``Momentum`` (under the warmup; the caller steps
    the schedule) in f32 (``level`` None), under ``auto_cast(level=
    "O1")``, or after ``decorate(level="O2")`` with ``multi_precision``
    under ``auto_cast(level="O2")`` (the reference benchmark's setting)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F

    sched = topt.lr.LinearWarmup(RESNET_LR, RESNET_WARMUP_STEPS,
                                 RESNET_WARMUP_START, RESNET_LR)
    opt = topt.Momentum(sched, parameters=model.parameters(),
                        multi_precision=level == "O2", **RESNET_MOMENTUM)
    if level == "O2":
        amp.decorate(model, opt, level="O2")

    def loss_fn(m, x, y):
        with amp.auto_cast(enable=level is not None, level=level or "O1"):
            return F.cross_entropy(m(x), y)

    return TrainStep(model, loss_fn, opt)


def device_busy_ms(run):
    """Device time of ``run()`` under ``torch.profiler``: the sum of its
    kernels' self time, and the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = launches = 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and \
                evt.self_device_time_total > 0:
            busy += evt.self_device_time_total / 1e3
            launches += evt.count
    return busy, launches


def bn_buffers(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("_mean", "_variance"))}


@contextlib.contextmanager
def conv_bn_spy():
    """The dtypes each ``torch.nn.functional.conv2d`` / ``batch_norm``
    call of the port receives, as ``{"conv": [...], "bn": [...]}``."""
    import torch.nn.functional as tF

    seen = {"conv": [], "bn": []}
    conv, bn = tF.conv2d, tF.batch_norm

    def conv_spy(x, w, *a, **kw):
        seen["conv"].append((x.dtype, w.dtype))
        return conv(x, w, *a, **kw)

    def bn_spy(x, mean, var, weight=None, bias=None, *a, **kw):
        seen["bn"].append((x.dtype, mean.dtype,
                           None if weight is None else weight.dtype))
        return bn(x, mean, var, weight, bias, *a, **kw)

    tF.conv2d, tF.batch_norm = conv_spy, bn_spy
    try:
        yield seen
    finally:
        tF.conv2d, tF.batch_norm = conv, bn


def run_resnet(smi, peaks, level, batch, phase, f32=None):
    """``RESNET_STEPS`` steps of ResNet-50 at ``level`` on ``batch``; the
    step times (steps 3 on), the peak, the device's busy share over two
    more profiled steps, and the gates of the phase."""
    t0 = time.perf_counter()
    model = build_resnet()
    step = resnet_trainer(model, level)
    tag = level or "f32"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    spy_calls = None
    for i in range(RESNET_STEPS):
        t1 = time.perf_counter()
        if i == 0 and level is not None:
            with conv_bn_spy() as spy_calls:
                loss = step(*batch)
        else:
            loss = step(*batch)
        losses.append(float(loss))  # syncs
        ms.append(1e3 * (time.perf_counter() - t1))
        step._opt._learning_rate.step()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy, launches = device_busy_ms(lambda: [step(*batch) for _ in range(2)])
    step_ms = float(np.mean(ms[2:]))
    busy_step = busy / 2
    images = RESNET_BATCH / step_ms * 1e3
    peak_kind = "f32" if level is None else "bf16"
    bound_images = peaks[peak_kind] / RESNET_TRAIN_FLOP
    out = dict(level=tag, step_ms=step_ms, step_ms_all=ms,
               images_per_s=images, bound_images_per_s=bound_images,
               share_of_bound=images / bound_images, peak_gib=peak,
               device_busy_ms=busy_step,
               device_idle_share=max(0.0, 1.0 - busy_step / step_ms),
               launches_per_step=launches // 2, losses=losses, card=smi)
    log(f"# phase {phase}: ResNet-50 {tag}, {RESNET_BATCH} x {RESNET_HW}^2, "
        f"Momentum lr {RESNET_LR} (warmup {RESNET_WARMUP_STEPS} steps from "
        f"{RESNET_WARMUP_START}), {RESNET_MOMENTUM}: steps "
        f"3-{RESNET_STEPS} {step_ms:.2f} ms "
        f"= {images:.1f} images/s ({100 * images / bound_images:.1f} % of the "
        f"{peak_kind} bound {bound_images:.0f} images/s at "
        f"{peaks[peak_kind] / 1e12:.0f} TFLOP/s), peak {peak:.2f} GiB, "
        f"device busy {busy_step:.2f} ms a step (idle "
        f"{100 * out['device_idle_share']:.1f} %), {launches // 2} launches "
        f"a step; {time.perf_counter() - t0:.1f} s  [{smi}]")
    log(f"losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in ms]}")
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"ResNet-50 {tag}: loss did not fall on the "
                             f"fixed batch: first 4 mean {first}, last 4 "
                             f"mean {last}")
    bufs = bn_buffers(model)
    stuck = [k for k, v in bufs.items() if not torch.isfinite(v).all()
             or torch.all(v == (0.0 if k.endswith("_mean") else 1.0))]
    if len(bufs) != 106 or stuck:
        raise AssertionError(f"ResNet-50 {tag}: {len(bufs)} BN buffers, "
                             f"not finite or unmoved: {stuck[:4]}")
    if spy_calls is not None:
        convs, bns = spy_calls["conv"], spy_calls["bn"]
        bad_conv = [c for c in convs if c != (torch.bfloat16,) * 2]
        bad_bn = [c for c in bns if c[0] != torch.float32 or c[1]
                  != torch.float32 or c[2] != torch.float32]
        log(f"spy, step 1: {len(convs)} conv2d launches, all (x, w) "
            f"{sorted(set(convs))}; {len(bns)} batch_norm launches, "
            f"(x, running, weight) {sorted(set(bns))}")
        if len(convs) != 53 or len(bns) != 53 or bad_conv or bad_bn:
            raise AssertionError(f"ResNet-50 {tag}: conv / batch norm cast "
                                 f"points wrong: {len(convs)} convs "
                                 f"({bad_conv[:2]}), {len(bns)} batch norms "
                                 f"({bad_bn[:2]})")
        out["spy"] = dict(convs=len(convs), batch_norms=len(bns))
    if f32 is not None:
        rel = abs(losses[0] - f32["losses"][0]) / abs(f32["losses"][0])
        log(f"first {tag} loss {losses[0]:.6f} vs f32 "
            f"{f32['losses'][0]:.6f}: {rel:.2e} (rtol "
            f"{AMP_LOSS_RTOL:.2e} gates O1)")
        out["first_loss_rel_vs_f32"] = rel
        if level == "O1" and not rel <= AMP_LOSS_RTOL:
            raise AssertionError("first O1 loss off the f32 one")
    del model, step
    torch.cuda.empty_cache()
    return out


def imagenet_transforms(train):
    from paddle_tpu_torch.vision import transforms as T

    first = ([T.RandomResizedCrop(RESNET_HW), T.RandomHorizontalFlip()]
             if train else [T.Resize(FAKE_HW), T.CenterCrop(RESNET_HW)])
    return T.Compose(first + [T.ToTensor(),
                              T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])


def resnet_model(net):
    from paddle_tpu_torch import Model, metric
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt

    sched = topt.lr.PiecewiseDecay([FIT_STEPS // 2], [0.1, 0.01])
    return Model(net).prepare(
        topt.Momentum(sched, 0.9, parameters=net.parameters(),
                      weight_decay=1e-4),
        tnn.CrossEntropyLoss(), metric.Accuracy(topk=(1, 5)))


def phase_resnet_hapi(smi, step_images):
    """Phase 29: ``Model.fit`` / ``evaluate`` / ``predict`` / ``save`` /
    ``load`` on ResNet-50 over ``FakeData`` through the reference's
    ImageNet transforms and a ``DataLoader`` of worker processes."""
    import os
    import tempfile

    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import FakeData

    t0 = time.perf_counter()
    workers = min(8, os.cpu_count() or 1)
    train = FakeData(FIT_STEPS * RESNET_BATCH, (FAKE_HW, FAKE_HW, 3),
                     RESNET_CLASSES, imagenet_transforms(True))
    evals = FakeData(EVAL_BATCHES * RESNET_BATCH, (FAKE_HW, FAKE_HW, 3),
                     RESNET_CLASSES, imagenet_transforms(False))
    np.random.seed(SEED)
    loader = DataLoader(train, batch_size=RESNET_BATCH, shuffle=True,
                        num_workers=workers, device=DEVICE)
    eval_loader = DataLoader(evals, batch_size=RESNET_BATCH,
                             num_workers=workers, device=DEVICE)
    net = build_resnet()
    model = resnet_model(net)

    class Beats(Callback):
        """The time each batch arrives (the loader's wait included) and
        each step's loss."""

        def __init__(self):
            super().__init__()
            self.t, self.losses = [], []

        def on_train_batch_begin(self, step, logs=None):
            self.t.append(time.perf_counter())

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    beats = Beats()
    t1 = time.perf_counter()
    model.fit(loader, epochs=1, verbose=0, callbacks=[beats])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    gaps = np.diff(beats.t)
    fit_images = RESNET_BATCH / float(np.mean(gaps[1:])) if len(gaps) > 1 \
        else float("nan")
    log(f"# phase 29: ResNet-50 through paddle.Model: fit {FIT_STEPS} steps "
        f"of {RESNET_BATCH} FakeData images ({FAKE_HW}^2 -> "
        f"RandomResizedCrop({RESNET_HW}), flip, ToTensor, Normalize), "
        f"{workers} worker processes: {fit_s:.2f} s; steps 3-{FIT_STEPS} "
        f"arrive every {1e3 * float(np.mean(gaps[1:])):.1f} ms = "
        f"{fit_images:.1f} images/s against phase 27's "
        f"{step_images:.1f} images/s a step (ratio "
        f"{fit_images / step_images:.2f}); losses "
        f"{[round(x, 4) for x in beats.losses]}  [{smi}]")
    if len(beats.losses) != FIT_STEPS or \
            not all(np.isfinite(beats.losses)):
        raise AssertionError(f"fit gave losses {beats.losses}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    result = model.evaluate(eval_loader, verbose=0)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_eval = EVAL_BATCHES * RESNET_BATCH
    predicted = model.predict(eval_loader)[0]
    summary = model.summary()
    log(f"evaluate {result}: {n_eval / eval_s:.1f} images/s ({eval_s:.2f} s "
        f"for {EVAL_BATCHES} batches, Resize({FAKE_HW}), CenterCrop("
        f"{RESNET_HW}), worker start included), peak {eval_peak:.2f} GiB; "
        f"predict {[p.shape for p in predicted]}; summary {summary}")
    for k in ("acc_top1", "acc_top5"):
        if not 0.0 <= result[k] <= 1.0:
            raise AssertionError(f"evaluate gave {result}")
    if len(predicted) != EVAL_BATCHES or any(
            p.shape != (RESNET_BATCH, RESNET_CLASSES)
            or not np.isfinite(p).all() for p in predicted):
        raise AssertionError("predict gave wrong outputs")
    if summary["total_params"] != RESNET_PARAMS:
        raise AssertionError(f"summary counts {summary}")

    # save, then load into a fresh model built from another seed: the
    # same eval logits on one batch, running statistics included
    x = next(iter(eval_loader))[0]
    net.eval()
    with torch.no_grad():
        want = net(x).float()
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "resnet50"))
        from paddle_tpu_torch.vision.models import resnet50

        fresh_net = resnet50(device=DEVICE, seed=SEED + 1)
        fresh = resnet_model(fresh_net)
        fresh.load(os.path.join(tmp, "resnet50"))
    fresh_net.eval()
    with torch.no_grad():
        got = fresh_net(x).float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    same_bn = all(torch.equal(a, b) for a, b in zip(
        bn_buffers(net).values(), bn_buffers(fresh_net).values()))
    log(f"save / load into a fresh model: eval logits max|err| {err:.3e} "
        f"of {scale:.3f}, BN buffers equal {same_bn}, velocities "
        f"{len(fresh._optimizer.state_dict()) - 1}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if not same_bn or not err <= 1e-6 * scale:
        raise AssertionError("save / load changed the model")
    out = dict(fit_images_per_s=fit_images, step_images_per_s=step_images,
               fit_over_step=fit_images / step_images, fit_s=fit_s,
               fit_losses=beats.losses, workers=workers, eval=result,
               eval_images_per_s=n_eval / eval_s, eval_peak_gib=eval_peak,
               card=smi)
    del model, net, fresh, fresh_net, loader, eval_loader
    torch.cuda.empty_cache()
    return out


def rel_to_cpu(got, want):
    """max|got - want| / max|want|, ``got`` on any device, ``want`` on
    the CPU."""
    return float((got.cpu().double() - want.double()).abs().max()
                 / max(float(want.abs().max()), 1e-30))


# name -> (op, input shape, weight shape or None, keyword arguments)
OP_CASES = {
    "conv-same-s2": ("conv2d", (2, 3, 10, 11), (5, 3, 3, 3),
                     dict(stride=2, padding="SAME")),
    "conv-per-side": ("conv2d", (2, 3, 8, 9), (4, 3, 3, 3),
                      dict(padding=[1, 0, 2, 1], stride=2)),
    "conv-groups-dilation": ("conv2d", (2, 4, 11, 10), (6, 2, 3, 3),
                             dict(padding=2, dilation=2, groups=2)),
    "conv-nhwc": ("conv2d", (2, 9, 10, 3), (4, 3, 3, 3),
                  dict(stride=2, padding="SAME", data_format="NHWC")),
    "convT-opad": ("conv2d_transpose", (2, 4, 5, 5), (4, 3, 3, 3),
                   dict(stride=2, padding=1, output_padding=1)),
    "convT-same-groups": ("conv2d_transpose", (2, 4, 5, 6), (4, 2, 3, 3),
                          dict(stride=2, padding="SAME", groups=2)),
    "max-ceil": ("max_pool2d", (2, 3, 9, 10), None,
                 dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    "max-wide-pad": ("max_pool2d", (2, 3, 9, 10), None,
                     dict(kernel_size=3, stride=1, padding=2)),
    "max-nhwc": ("max_pool2d", (2, 9, 10, 3), None,
                 dict(kernel_size=3, stride=2, padding=1,
                      data_format="NHWC")),
    "avg-ceil-excl": ("avg_pool2d", (2, 3, 9, 10), None,
                      dict(kernel_size=3, stride=2, ceil_mode=True)),
    "avg-ceil-incl": ("avg_pool2d", (2, 3, 9, 10), None,
                      dict(kernel_size=3, stride=2, padding=1,
                           ceil_mode=True, exclusive=False)),
    "avg-wide-pad": ("avg_pool2d", (2, 3, 9, 10), None,
                     dict(kernel_size=3, stride=1, padding=[2, 1])),
}


def phase_card_vs_cpu(smi):
    """Phase 30: ResNet-50 (10 classes) on the card and on the CPU from the
    same weights, and a sweep of convs and pools through the explicit
    padding route, forward and gradient."""
    from paddle_tpu_torch.framework import load_numpy_state
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch import optimizer as topt

    t0 = time.perf_counter()
    errs = {}
    cpu = build_resnet(num_classes=10, device="cpu")
    card = build_resnet(num_classes=10)
    load_numpy_state(card, {k: v.numpy() for k, v in
                            cpu.state_dict().items()})
    rng = np.random.default_rng(SEED + 30)
    x = torch.from_numpy(rng.standard_normal((8, 3, 64, 64),
                                             dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (8,)))
    for m in (cpu, card):
        m.eval()
    with torch.no_grad():
        errs["eval logits"] = rel_to_cpu(card(x.to(DEVICE)), cpu(x))
    for m in (cpu, card):
        m.train()
    with torch.no_grad():
        errs["train logits"] = rel_to_cpu(card(x.to(DEVICE)), cpu(x))
    cb, pb = bn_buffers(card), bn_buffers(cpu)
    errs["BN buffers after a train forward"] = max(
        rel_to_cpu(cb[k], pb[k]) for k in pb)
    # one Momentum step through TrainStep at 32 x 32, batch 2, with the
    # batch norms in inference mode: there the gradient is continuous in
    # the inputs' rounding (with batch statistics, a ReLU input rounded to
    # the other side of 0 moves a whole channel's gradient:
    # tests/test_torch_resnet.py)
    xs, ys = x[:2, :, :32, :32].contiguous(), y[:2]
    for m in (cpu, card):
        m.eval()
        step = TrainStep(m, lambda mm, a, b: F.cross_entropy(mm(a), b),
                         topt.Momentum(RESNET_LR,
                                       parameters=m.parameters(),
                                       use_nesterov=True,
                                       **RESNET_MOMENTUM))
        dev = next(m.parameters()).device
        step(xs.to(dev), ys.to(dev))
    cs, ps = card.state_dict(), cpu.state_dict()
    errs["one Momentum step, parameters"] = max(
        rel_to_cpu(cs[k], ps[k]) for k in ps)
    for k, v in errs.items():
        log(f"card vs CPU, ResNet-50 (10 classes, 64 x 64, batch 8): {k} "
            f"{v:.2e} (rtol {CARD_CPU_RTOL:.0e})")
    bad = {k: v for k, v in errs.items() if not v <= CARD_CPU_RTOL}

    gen = torch.Generator().manual_seed(SEED + 31)
    sweep = 0.0
    for name, (op, xs_, ws, kw) in OP_CASES.items():
        args = [torch.randn(xs_, generator=gen)]
        if ws is not None:
            args.append(0.3 * torch.randn(ws, generator=gen))
        fn = getattr(F, op)
        outs = {}
        for dev in ("cpu", DEVICE):
            ts = [a.to(dev).requires_grad_(True) for a in args]
            out = fn(*ts, **kw)
            cot = torch.ones_like(out) + 0.1 * torch.arange(
                out.numel(), device=dev, dtype=out.dtype).reshape(
                out.shape).sin()
            outs[dev] = [out.detach()] + list(torch.autograd.grad(out, ts,
                                                                  cot))
        worst = max(rel_to_cpu(c, p)
                    for c, p in zip(outs[DEVICE], outs["cpu"]))
        sweep = max(sweep, worst)
        if not worst <= OP_SWEEP_RTOL:
            bad[f"op {name}"] = worst
    log(f"op sweep card vs CPU ({len(OP_CASES)} conv / transpose / max / "
        f"avg cases, forward and gradients): worst {sweep:.2e} (rtol "
        f"{OP_SWEEP_RTOL:.0e}); phase {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"card and CPU differ: {bad}")
    errs["op sweep"] = sweep
    del cpu, card
    torch.cuda.empty_cache()
    return errs


def phases_vision(smi, peaks):
    """Phases 27-30; returns the ``vision`` JSON line's numbers."""
    t0 = time.perf_counter()
    batch = resnet_batch()
    # cuDNN picks its algorithms by timing them once per shape (the first
    # step pays it); TF32 stays off
    torch.backends.cudnn.benchmark = True
    try:
        f32 = run_resnet(smi, peaks, None, batch, 27)
        t1 = time.perf_counter()
        o1 = run_resnet(smi, peaks, "O1", batch, "28 (O1)", f32)
        o2 = run_resnet(smi, peaks, "O2", batch, "28 (O2)", f32)
        log(f"phase 28: {time.perf_counter() - t1:.1f} s")
        del batch
        torch.cuda.empty_cache()
        hapi = phase_resnet_hapi(smi, f32["images_per_s"])
    finally:
        torch.backends.cudnn.benchmark = False
    card_cpu = phase_card_vs_cpu(smi)
    log(f"phases 27-30: {time.perf_counter() - t0:.1f} s")
    slim = lambda r: {k: v for k, v in r.items()  # noqa: E731
                      if k not in ("step_ms_all", "card")}
    return {"resnet50": {"f32": slim(f32), "O1": slim(o1), "O2": slim(o2),
                         "hapi": {k: v for k, v in hapi.items()
                                  if k != "card"},
                         "card_vs_cpu_rel_err": card_cpu,
                         "card": smi}}


# -- phases 31-34: the generation API and the top-level namespace ------------

# phase 31: GPT-3 1.3B at full width and depth, 4 prompts of 128 tokens, 64
# new; phase 32: Llama-3-8B, 2 prompts of 64, 32 new
GEN_GPT = dict(prompts=4, prompt_len=128, new=64)
GEN_LLAMA = dict(prompts=2, prompt_len=64, new=32)
GEN_SAMPLING = dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.8,
                    seed=SEED)
# phase 33: generate_padded and beam_search at depth 2
GEN_SHORT = dict(prompts=2, prompt_len=32, new=8, beams=4)
EXAMPLE = "examples/train_vision_hapi.py"
EXAMPLE_IMPORT = "import paddle_tpu as paddle\n"


def gen_prompts(vocab, b, t):
    return np.random.default_rng(SEED + t).integers(1, vocab, (b, t))


def synced(fn):
    """``fn()`` and its wall time in seconds, the card drained around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_streams(fa, model, prompts, streams, what):
    """Every stream of ``streams`` ({route: [B, T] ids}) equal to the
    first; a split is reported as :func:`report_divergence` reports it."""
    (name0, ref), *rest = streams.items()
    for name, got in rest:
        if got.shape == ref.shape and np.array_equal(got, ref):
            continue
        report_divergence(fa, model, list(prompts), list(got), list(ref),
                          names=(name, name0))
        raise AssertionError(f"{what}: the {name} stream differs from the "
                             f"{name0} stream")


def phase_generation(fa, pa, smi, model, label, phase, prompts, new):
    """``model.generate`` (KV-cached), ``generate(use_engine=False)`` (the
    pow2-bucket loop) and ``generate`` through ``enable_decode_engine``
    on ``prompts``: K1 launches once a layer on the cached route (its
    prefill; the decode steps attend through ``F.decode_attention``) and
    once a layer a step on the loop; K3 launches on the engine route in
    the regimes ``_k3_regime`` picks and K1 not at all. Greedy streams
    equal on the three routes, sampled ones on the cached and loop
    routes."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.text import generation

    cfg = model.config
    layers = cfg.num_hidden_layers
    group = cfg.num_attention_heads // getattr(
        cfg, "num_key_value_heads", cfg.num_attention_heads)
    b, t0 = prompts.shape
    res = {}
    reset_flash(fa)
    cached, secs = synced(lambda: model.generate(prompts, new))
    if fa.launches_fwd != layers:
        raise AssertionError(f"cached generate launched K1 "
                             f"{fa.launches_fwd} times, expected {layers} "
                             "(the prefill only)")
    res["cached"] = dict(seconds=secs, tokens_per_s=b * new / secs,
                         k1_launches=fa.launches_fwd)
    reset_flash(fa)
    loop, secs = synced(lambda: generation.generate(model, prompts, new,
                                                    use_engine=False))
    if fa.launches_fwd != layers * new:
        raise AssertionError(f"the loop launched K1 {fa.launches_fwd} "
                             f"times, expected {layers} x {new}")
    res["loop"] = dict(seconds=secs, tokens_per_s=b * new / secs,
                       k1_launches=fa.launches_fwd)
    eng = inference.enable_decode_engine(
        model, kv_dtype="f32", num_slots=b,
        max_length=generation._pow2_bucket(t0 + new), page_size=16,
        seed=SEED, device=DEVICE)
    try:
        reset_flash(fa)
        for n in K3_COUNTERS:
            setattr(pa, n, 0)
        engine, secs = synced(lambda: generation.generate(model, prompts,
                                                          new))
        launches, tile, split, decode, verify = k3_counts(pa)
        st = eng.stats()
        want = k3_expected(pa, layers, st, eng, group)
        if (tile, split, decode, verify) != want or not launches:
            raise AssertionError(
                f"engine route: K3 launches (tile, split, decode, verify) "
                f"= {(tile, split, decode, verify)}, expected {want}")
        if fa.launches_fwd:
            raise AssertionError("the engine route launched K1")
    finally:
        inference.disable_decode_engine(model)
    res["engine"] = dict(seconds=secs, tokens_per_s=b * new / secs,
                         k1_launches=fa.launches_fwd,
                         k3_launches=dict(tile=tile, split=split,
                                          decode=decode, verify=verify),
                         prefill_calls=st["prefill_calls"],
                         decode_steps=st["decode_steps"])
    streams = {"cached": cached, "loop": loop, "engine": engine}
    for name, out in streams.items():
        if out.shape != (b, t0 + new):
            raise AssertionError(f"{name}: shape {out.shape}")
        if not ((out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"{name}: token id out of the vocabulary")
    check_streams(fa, model, prompts, streams, f"{label} greedy")
    sampled = {"cached": model.generate(prompts, new, **GEN_SAMPLING),
               "loop": generation.generate(model, prompts, new,
                                           use_engine=False, **GEN_SAMPLING)}
    check_streams(fa, model, prompts, sampled, f"{label} sampled")
    if np.array_equal(sampled["cached"], cached):
        raise AssertionError("the sampled stream is the greedy one")
    log(f"# phase {phase}: {label}, {b} prompts of {t0} tokens, {new} new: "
        + "; ".join(f"{k} {r['tokens_per_s']:.1f} tok/s ({r['seconds']:.3f}"
                    f" s, K1 {r['k1_launches']})" for k, r in res.items())
        + f"; K3 {res['engine']['k3_launches']}; greedy streams of the "
        "three routes equal, sampled (top-k 50, top-p 0.9, T 0.8) cached = "
        f"loop  [{smi}]")
    return dict(res, prompts=b, prompt_len=t0, new_tokens=new, card=smi)


def phase_generation_plain(fa, build, label, phase):
    """``generate_padded`` and ``beam_search`` (``GEN_SHORT['beams']``
    beams) at depth 2: K1 launches once a layer a forward, and each
    stream equals the same call's on the plain attention."""
    from paddle_tpu_torch.text import generation

    model = build(2)
    c = GEN_SHORT
    prompts = gen_prompts(model.config.vocab_size, c["prompts"],
                          c["prompt_len"])
    forwards = []
    hook = model.register_forward_hook(lambda *a: forwards.append(1))
    routes = {
        "generate_padded": lambda: generation.generate_padded(
            model, prompts, c["prompt_len"] + c["new"], use_engine=False),
        "beam_search": lambda: generation.beam_search(
            model, prompts, c["new"], num_beams=c["beams"])}
    res = {}
    try:
        for name, run in routes.items():
            reset_flash(fa)
            forwards.clear()
            got = run()
            n = len(forwards)
            if not n or fa.launches_fwd != 2 * n:
                raise AssertionError(f"{name}: K1 launched "
                                     f"{fa.launches_fwd} times over {n} "
                                     "forwards at 2 layers")
            res[name] = dict(forwards=n, k1_launches=fa.launches_fwd)
            with plain_attention(fa):
                want = run()
            check_streams(fa, model, prompts, {"plain": want, "K1": got},
                          f"{label} {name}")
    finally:
        hook.remove()
    log(f"# phase {phase}: {label} at depth 2: " + "; ".join(
        f"{k} {r['forwards']} forwards, K1 {r['k1_launches']}"
        for k, r in res.items()) + "; streams equal to the plain "
        "attention's")
    del model
    torch.cuda.empty_cache()
    return res


def phase_namespace(smi):
    """The body of ``examples/train_vision_hapi.py`` run against
    ``paddle_tpu_torch`` on the default device (its one ``import
    paddle_tpu as paddle`` line replaced in memory): fit, evaluate,
    predict, summary; finite logits, every parameter on the card. Then
    ``to_tensor`` on the card, and on the CPU after ``set_device("cpu")``
    (the default restored after)."""
    import io
    from pathlib import Path

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice

    path = Path(__file__).resolve().parent / EXAMPLE
    src = path.read_text()
    if src.count(EXAMPLE_IMPORT) != 1:
        raise AssertionError(f"{EXAMPLE}: expected one {EXAMPLE_IMPORT!r}")
    src = src.replace(EXAMPLE_IMPORT, "import paddle_tpu_torch as paddle\n")
    seen = []

    class Model(paddle.Model):
        def predict_batch(self, inputs):
            out = super().predict_batch(inputs)
            seen.append((self, inputs, out))
            return out

    saved = paddle.Model
    paddle.Model = Model
    printed = io.StringIO()
    try:
        ns = {"__name__": "train_vision_hapi", "__file__": str(path)}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            exec(compile(src, str(path), "exec"), ns)
            ns["main"]()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        paddle.Model = saved
    (model, inputs, (logits,)), = seen
    params = list(model.network.parameters())
    if not all(p.device.type == DEVICE for p in params) or \
            inputs[0].device.type != DEVICE:
        raise AssertionError("a parameter or the predict input is off the "
                             "card")
    if logits.shape != (4, 10) or not np.isfinite(logits).all() or \
            not all(torch.isfinite(p).all() for p in params):
        raise AssertionError("non-finite logits or parameters")
    evals = [ln for ln in printed.getvalue().splitlines()
             if ln.startswith("eval:")]
    on_card = paddle.to_tensor(np.ones(3)).device
    prev = tdevice._default
    try:
        paddle.set_device("cpu")
        on_cpu = paddle.to_tensor(np.ones(3)).device
        shown = paddle.get_device()
    finally:
        tdevice._default = prev
    if on_card.type != DEVICE or on_cpu.type != "cpu" or shown != "cpu" \
            or paddle.to_tensor([1.0]).device.type != DEVICE:
        raise AssertionError(f"to_tensor landed on {on_card} / {on_cpu} "
                             f"(get_device {shown!r})")
    log(f"# phase 34: {EXAMPLE} on the port on {paddle.get_device()}: "
        f"{secs:.2f} s, {evals[0] if evals else 'no eval line'}; logits "
        f"finite, {len(params)} parameters on the card; to_tensor on "
        f"{on_card}, on {on_cpu} after set_device('cpu')  [{smi}]")
    return dict(seconds=secs, eval=evals[0] if evals else None, card=smi)


def phases_generation(fa, pa, smi):
    """Phases 31-34; returns the ``generation`` JSON line's numbers."""
    t0 = time.perf_counter()
    model = build_model(24)
    c = GEN_GPT
    gpt = phase_generation(
        fa, pa, smi, model, "GPT-3 1.3B (24 layers)", "31 (A)",
        gen_prompts(model.config.vocab_size, c["prompts"], c["prompt_len"]),
        c["new"])
    del model
    torch.cuda.empty_cache()
    model = build_llama(LLAMA3_8B["num_hidden_layers"])
    c = GEN_LLAMA
    llama = phase_generation(
        fa, pa, smi, model,
        f"Llama-3-8B ({LLAMA3_8B['num_hidden_layers']} layers, G=4)",
        "32 (B)",
        gen_prompts(model.config.vocab_size, c["prompts"], c["prompt_len"]),
        c["new"])
    del model
    torch.cuda.empty_cache()
    short = {"gpt3_1p3b": phase_generation_plain(fa, build_model,
                                                 "GPT-3 1.3B", "33 (C)"),
             "llama3_8b": phase_generation_plain(fa, build_llama,
                                                 "Llama-3-8B", "33 (C)")}
    namespace = phase_namespace(smi)
    secs = time.perf_counter() - t0
    log(f"phases 31-34: {secs:.1f} s")
    return {"gpt3_1p3b": gpt, "llama3_8b": llama, "depth2": short,
            "namespace": namespace, "seconds": secs, "card": smi}


# -- phases 35-37: nn.Layer and the core tensor API --------------------------

# GPTConfig.gpt3_1p3b's widths and depth (text/models/gpt.py): the
# user-written LM of phase 36 is built at them, phase 37's at depth 2
USER_LM = dict(vocab=50304, hidden=2048, heads=16, ffn=8192, layers=24,
               positions=2048)
USER_LM_FIT_BATCHES = 4
# phase 37's card-against-CPU batch, 1 x 256 tokens: the CPU runs the
# full-width vocab products of a forward and backward in a few seconds
USER_LM_CPU_SEQ = 256
# phase 35, card against CPU on the same inputs: f32 within the CPU
# sweep's tolerance against the reference (tests/test_torch_tensor_api.py)
API_RTOL, API_ATOL, API_SPECIAL_RTOL = 1e-5, 1e-6, 1e-4


def load_api_cases():
    """The tensor-API sweep's cases (``tests/tensor_api_cases.py``, numpy
    only), loaded by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "tensor_api_cases.py"
    spec = importlib.util.spec_from_file_location("tensor_api_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def api_diff(got, want, special, what):
    """The largest |got - want| of the card's result ``got`` against the
    CPU's ``want``: same structure, dtypes and shapes, every tensor of
    ``got`` on the card, integers and bools equal, floats within the
    sweep's tolerance; raises otherwise."""
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise AssertionError(f"{what}: {type(got)} vs {type(want)}")
        return max([api_diff(g, w, special, f"{what}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))] or [0.0])
    if not isinstance(want, torch.Tensor):
        if got != want:
            raise AssertionError(f"{what}: {got!r} vs {want!r}")
        return 0.0
    if not isinstance(got, torch.Tensor) or got.device.type != DEVICE or \
            got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(
            f"{what}: card {getattr(got, 'device', type(got))} "
            f"{getattr(got, 'dtype', '')} {tuple(getattr(got, 'shape', ()))}"
            f" vs CPU {want.dtype} {tuple(want.shape)}")
    g = got.detach().cpu().resolve_conj()
    w = want.detach().resolve_conj()
    if not (w.is_floating_point() or w.is_complex()):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: integer / bool results differ")
        return 0.0
    rtol = API_SPECIAL_RTOL if special else API_RTOL
    if not torch.allclose(g, w, rtol=rtol, atol=API_ATOL, equal_nan=True):
        raise AssertionError(f"{what}: max |err| "
                             f"{float((g - w).abs().nan_to_num(0).max())}")
    return float((g - w).abs().nan_to_num(0).max()) if w.numel() else 0.0


def phase_tensor_api(smi):
    """Phase 35: every case of the tensor-API sweep run on CUDA inputs and
    on CPU copies, compared; creation without a device on the card; each
    random function's draw on the card repeated after ``paddle.seed``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice

    t0 = time.perf_counter()
    cases = load_api_cases()
    names, worst, worst_case = set(), 0.0, None
    for case in sorted(cases.CASES):
        name = case.split(":")[0]
        fn = getattr(paddle, name)
        args, kwargs = cases.CASES[case](cases.case_rng(case))
        outs = {}
        for dev in (DEVICE, "cpu"):
            prev = tdevice._default
            try:
                if dev == "cpu":
                    paddle.set_device("cpu")
                outs[dev] = fn(*(cases.port_arg(a, dev) for a in args),
                               **{k: cases.port_arg(v, dev)
                                  for k, v in kwargs.items()})
            finally:
                tdevice._default = prev
        err = api_diff(outs[DEVICE], outs["cpu"], name in cases.SPECIAL,
                       case)
        if err > worst:
            worst, worst_case = err, case
        names.add(name)
    # as_strided, which the reference refuses, beside the CPU's view
    flat = np.arange(12, dtype=np.float32)
    api_diff(*(paddle.as_strided(torch.from_numpy(flat).to(dev), [3, 3],
                                 [2, 1], 1) for dev in (DEVICE, "cpu")),
             False, "as_strided")
    names.add("as_strided")
    drawn = 0
    for name, (args, kwargs, dtype, check) in sorted(cases.RANDOM.items()):
        draws = []
        for _ in range(2):
            paddle.seed(SEED)
            draws.append(getattr(paddle, name)(*args, **kwargs))
        a, b = draws
        if a.device.type != DEVICE or str(a.dtype) != f"torch.{dtype}" or \
                not torch.equal(a, b) or \
                not check(a.cpu().numpy().astype(np.float64)):
            raise AssertionError(f"{name}: draw on {a.device} {a.dtype} "
                                 "not repeated or off its law")
        drawn += 1
    for name, (x, args, kwargs, check) in sorted(cases.RANDOM_LIKE.items()):
        draws = []
        for _ in range(2):
            paddle.seed(SEED)
            draws.append(getattr(paddle, name)(
                torch.from_numpy(x.copy()).to(DEVICE), *args, **kwargs))
        a, b = draws
        if a.device.type != DEVICE or not torch.equal(a, b) or \
                not check(a.cpu().numpy().astype(np.float64), x):
            raise AssertionError(f"{name}: draw not repeated or off its law")
        drawn += 1
    draws = []
    for _ in range(2):
        paddle.seed(SEED)
        draws.append(paddle.binomial(
            torch.full((4096,), 10, device=DEVICE),
            torch.full((4096,), 0.3, device=DEVICE)))
    a, b = draws
    if not torch.equal(a, b) or a.dtype != torch.int64 or \
            not 0 <= int(a.min()) <= int(a.max()) <= 10 or \
            abs(float(a.double().mean()) - 3) > 0.2:
        raise AssertionError("binomial: draw not repeated or off its law")
    drawn += 1
    if not torch.equal(paddle.uniform([64], seed=7),
                       paddle.uniform([64], seed=7)):
        raise AssertionError("uniform(seed=) did not repeat")
    names |= set(cases.RANDOM) | set(cases.RANDOM_LIKE) | {"binomial"}
    secs = time.perf_counter() - t0
    log(f"# phase 35: tensor API on the card: {len(names)} functions, "
        f"{len(cases.CASES) + 1} cases against the same calls on CPU copies "
        f"(f32 rtol {API_RTOL:.0e} atol {API_ATOL:.0e}, special functions "
        f"rtol {API_SPECIAL_RTOL:.0e}, integers and bools exact, dtypes "
        f"equal), largest |err| {worst:.3e} ({worst_case}); creation "
        f"without a device on the card; {drawn} random functions repeat "
        f"after paddle.seed; {secs:.1f} s  [{smi}]")
    return dict(functions=len(names), cases=len(cases.CASES) + 1,
                max_abs_err=worst, worst_case=worst_case,
                random_functions=drawn, seconds=secs)


def user_lm(paddle, layers):
    """A causal LM written as Paddle users write one, a ``paddle.nn.Layer``
    subclass over the public API only, at ``USER_LM``'s widths and
    ``layers`` deep; and its loss layer. Returns ``(model, loss)``."""
    nn, F = paddle.nn, paddle.nn.functional
    c = USER_LM
    hidden, heads = c["hidden"], c["heads"]

    class Block(nn.Layer):
        """Pre-LN: causal attention over a fused QKV, then a GELU MLP."""

        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(hidden)
            self.qkv = nn.Linear(hidden, 3 * hidden)
            self.proj = nn.Linear(hidden, hidden)
            self.ln2 = nn.LayerNorm(hidden)
            self.fc1 = nn.Linear(hidden, c["ffn"])
            self.fc2 = nn.Linear(c["ffn"], hidden)

        def forward(self, x):
            b, t = x.shape[0], x.shape[1]
            qkv = paddle.reshape(self.qkv(self.ln1(x)),
                                 [b, t, 3, heads, hidden // heads])
            q, k, v = (paddle.reshape(z, [b, t, heads, hidden // heads])
                       for z in paddle.split(
                           paddle.transpose(qkv, [2, 0, 1, 3, 4]), 3, axis=0))
            a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + self.proj(paddle.reshape(a, [b, t, hidden]))
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))

    class UserLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.wte = nn.Embedding(c["vocab"], hidden)
            self.wpe = self.create_parameter(
                [c["positions"], hidden],
                default_initializer=nn.initializer.Normal(0.0, 0.02))
            self.blocks = nn.LayerList([Block() for _ in range(layers)])
            self.ln_f = nn.LayerNorm(hidden)

        def forward(self, ids):
            x = self.wte(ids) + paddle.gather(self.wpe,
                                              paddle.arange(ids.shape[1]))
            for block in self.blocks:
                x = block(x)
            return paddle.matmul(self.ln_f(x), self.wte.weight,
                                 transpose_y=True)

    class NextTokenLoss(nn.Layer):
        """Each position's cross entropy against the next token; the last
        position, which has none, ignored."""

        def forward(self, logits, ids):
            tail = paddle.full([ids.shape[0], 1], -100, dtype=ids.dtype)
            labels = paddle.concat([ids[:, 1:], tail], axis=1)
            return F.cross_entropy(paddle.reshape(logits, [-1, c["vocab"]]),
                                   paddle.reshape(labels, [-1]))

    return UserLM(), NextTokenLoss()


def phase_user_lm(fa, smi):
    """Phase 36: the user-written LM at GPT-3 1.3B's widths and depth,
    ``TRAIN_STEPS`` steps through ``TrainStep`` + ``AdamW`` in f32: K1,
    K2a and K2b each launched once a layer a step, causal; finite
    losses."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    paddle.seed(SEED)
    model, loss_layer = user_lm(paddle, USER_LM["layers"])
    opt = AdamW(parameters=model.parameters(), **ADAMW)
    step = TrainStep(model, lambda m, ids: loss_layer(m(ids), ids), opt)
    ids, _ = train_batch(USER_LM["vocab"])
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    losses, step_ms = [], []
    with flash_calls(fa) as calls:
        for _ in range(TRAIN_STEPS):
            t1 = time.perf_counter()
            losses.append(float(step(ids)))  # syncs
            step_ms.append(1e3 * (time.perf_counter() - t1))
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                "dkv": fa.launches_dkv}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy, per_step = device_busy_ms(lambda: step(ids))
    ms = float(np.mean(step_ms[1:]))
    tokens = ids.numel()
    idle = max(0.0, 1.0 - busy / ms)
    layers = USER_LM["layers"]
    want = layers * TRAIN_STEPS
    log(f"# phase 36: user-written paddle.nn.Layer LM at GPT-3 1.3B's "
        f"widths ({n_params / 1e9:.3f} B parameters, {layers} layers), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, AdamW f32: set-up "
        f"{setup:.2f} s; steps 1-{TRAIN_STEPS - 1} {ms:.1f} ms = "
        f"{tokens / ms * 1e3:.1f} tokens/s; peak {peak:.2f} GiB; device "
        f"busy {busy:.1f} ms of a step (idle {100 * idle:.1f} %, "
        f"{per_step} launches); flash launches {launches}  [{smi}]")
    log(f"losses {[round(x, 5) for x in losses]}; step ms "
        f"{[round(x, 1) for x in step_ms]}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss {losses}")
    spied = {k: len(v) for k, v in calls.items()}
    causal = all(c[0] and c[1] is None for v in calls.values() for c in v)
    if any(n != want for n in launches.values()) or \
            any(n != want for n in spied.values()) or not causal:
        raise AssertionError(f"flash launches {launches} / spied {spied} "
                             f"(all causal, no bias: {causal}) != {layers} "
                             f"x {TRAIN_STEPS}")
    del step, opt, model
    torch.cuda.empty_cache()
    return dict(parameters=n_params, layers=layers, step_ms=ms,
                step_ms_all=step_ms, tokens_per_s=tokens / ms * 1e3,
                peak_gib=peak, device_busy_ms=busy, device_idle_share=idle,
                launches=launches, losses=losses, setup_s=setup, card=smi)


class _Tokens:
    """``n`` rows of next-token ids as ``(ids, ids)`` samples for
    ``Model``: the loss layer reads the labels off the ids."""

    def __init__(self, n, seq, seed):
        rng = np.random.default_rng(seed)
        self.rows = rng.integers(0, USER_LM["vocab"], (n, seq))

    def __getitem__(self, i):
        return self.rows[i], self.rows[i]

    def __len__(self):
        return len(self.rows)


def phase_user_lm_depth2(fa, smi):
    """Phase 37: the same class at depth 2 through ``paddle.Model``
    (``fit`` / ``evaluate``), a save / ``set_state_dict`` round trip,
    forward hooks, and the card against the CPU on the same weights and
    batch."""
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    paddle.seed(SEED + 37)
    model, loss_layer = user_lm(paddle, 2)
    data = type("Data", (_Tokens, paddle.io.Dataset), {})
    hapi = paddle.Model(model).prepare(
        AdamW(parameters=model.parameters(), **ADAMW), loss_layer)
    clock = _clock()
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    hapi.fit(data(USER_LM_FIT_BATCHES * TRAIN_BATCH, TRAIN_SEQ, SEED),
             batch_size=TRAIN_BATCH, epochs=1, shuffle=False, verbose=0,
             callbacks=[clock])
    fit_launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                    "dkv": fa.launches_dkv}
    ev = hapi.evaluate(data(USER_LM_FIT_BATCHES * TRAIN_BATCH, TRAIN_SEQ,
                            SEED + 1), batch_size=TRAIN_BATCH, verbose=0)
    fit_losses = [float(np.ravel(x)[0]) for x in clock.losses]
    want = 2 * USER_LM_FIT_BATCHES
    if fit_launches != {"fwd": want, "dq": want, "dkv": want} or \
            len(fit_losses) != USER_LM_FIT_BATCHES or \
            not np.isfinite(fit_losses).all() or \
            not np.isfinite(np.ravel(ev["loss"])).all():
        raise AssertionError(f"Model.fit / evaluate: launches {fit_launches}"
                             f", losses {fit_losses}, eval {ev}")

    # save, then set_state_dict into a fresh model: bit-equal, ([], [])
    fresh, _ = user_lm(paddle, 2)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/user_lm.pdparams"
        paddle.save(model.state_dict(), path)
        result = fresh.set_state_dict(paddle.load(path))
    state, back = model.state_dict(), fresh.state_dict()
    bit_equal = all(torch.equal(state[k], back[k]) for k in state)
    if result != ([], []) or not bit_equal or set(state) != set(back):
        raise AssertionError(f"round trip: {result}, bit-equal {bit_equal}")
    del fresh

    # forward hooks: once per call each, none after remove()
    seen = []
    pre = model.register_forward_pre_hook(lambda m, i: seen.append("pre"))
    post = model.register_forward_post_hook(
        lambda m, i, o: seen.append("post"))
    small = torch.as_tensor(_Tokens(1, 64, SEED + 2).rows, device=DEVICE)
    with torch.no_grad():
        model(small)
        pre.remove()
        post.remove()
        model(small)
    if seen != ["pre", "post"]:
        raise AssertionError(f"hooks fired {seen}")

    # the card against the CPU: one loss and every parameter's gradient
    ids = torch.as_tensor(_Tokens(1, USER_LM_CPU_SEQ, SEED + 3).rows)
    cpu_state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    results = {}
    for dev in (DEVICE, "cpu"):
        prev = tdevice._default
        try:
            if dev == "cpu":
                paddle.set_device("cpu")
                net, loss_fn = user_lm(paddle, 2)
                net.set_state_dict(cpu_state)
            else:
                net, loss_fn = model, loss_layer
            net.clear_gradients(set_to_zero=False)
            x = ids.to(dev)
            loss = loss_fn(net(x), x)
            loss.backward()
            results[dev] = (loss.detach(),
                            {k: p.grad for k, p in net.named_parameters()})
        finally:
            tdevice._default = prev
    (lc, gc), (lp, gp) = results[DEVICE], results["cpu"]
    errs = {"loss": rel_to_cpu(lc, lp)}
    errs["gradients (worst parameter)"] = max(rel_to_cpu(gc[k], gp[k])
                                              for k in gp)
    secs = time.perf_counter() - t0
    log(f"# phase 37: the same class at depth 2: Model.fit "
        f"{USER_LM_FIT_BATCHES} batches (losses "
        f"{[round(x, 4) for x in fit_losses]}, step ms "
        f"{[round(x, 1) for x in clock.ms]}), evaluate loss "
        f"{float(np.ravel(ev['loss'])[0]):.4f}; flash launches in fit "
        f"{fit_launches}; save / set_state_dict bit-equal, {result}; hooks "
        f"{seen}; card vs CPU (1 x {USER_LM_CPU_SEQ}): loss "
        f"{errs['loss']:.2e}, gradients {errs['gradients (worst parameter)']:.2e} "
        f"(rtol {CARD_CPU_RTOL:.0e}); {secs:.1f} s  [{smi}]")
    bad = {k: v for k, v in errs.items() if not v <= CARD_CPU_RTOL}
    if bad:
        raise AssertionError(f"card and CPU differ: {bad}")
    del model, hapi, results
    torch.cuda.empty_cache()
    return dict(fit_losses=fit_losses, fit_step_ms=clock.ms,
                fit_launches=fit_launches,
                eval_loss=float(np.ravel(ev["loss"])[0]),
                round_trip=list(result), card_vs_cpu=errs, seconds=secs,
                card=smi)


def phases_layer(fa, smi):
    """Phases 35-37; returns the ``layer`` JSON line's numbers."""
    t0 = time.perf_counter()
    api = phase_tensor_api(smi)
    lm = phase_user_lm(fa, smi)
    depth2 = phase_user_lm_depth2(fa, smi)
    secs = time.perf_counter() - t0
    log(f"phases 35-37: {secs:.1f} s")
    return {"tensor_api": api, "user_lm_1p3b": lm, "depth2": depth2,
            "seconds": secs, "card": smi}


# -- phases 38-39: hybrid-parallel training (paddle.distributed) -------------

# phase 39's configurations (two ranks on the one card over gloo): mp 2
# with sequence parallelism, dp 2, sharding 2 (ZeRO-1); GPT-3 1.3B's
# widths at depth 2, LOCKSTEP_STEPS AdamW steps on phase 7's batch
FLEET_CONFIGS = {"mp2_sp": dict(mp_degree=2, sequence_parallel=True),
                 "dp2": dict(dp_degree=2),
                 "sharding2": dict(sharding_degree=2)}
FLEET_DEPTH = 2
# a collective gloo refuses on CUDA tensors (the card's check before
# phase 39): point-to-point, whose send passes the device pointer to the
# socket (writev: Bad address); no configuration of phase 39 sends one
GLOO_CUDA_REFUSED = ("send / recv / batch_isend_irecv",)


@contextlib.contextmanager
def launch_env(**env):
    """The launch environment ``init_parallel_env`` reads, restored after."""
    import os

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dist_trainer(model, adamw=ADAMW):
    """``fleet.distributed_model`` / ``distributed_optimizer`` /
    ``DistTrainStep`` over ``trainer``'s AdamW and clip."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **adamw)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    step = fleet.DistTrainStep(model, lambda m, ids, lab: m(ids, labels=lab),
                               opt)
    return step, opt


def meta_strategy(meta=None, strategy=None):
    """``strategy`` (default a new one) with the meta-optimizer ``meta``
    set: "lamb" (A3_LAMB) or "lars" (A3_LARS)."""
    from paddle_tpu_torch.distributed import fleet

    s = strategy or fleet.DistributedStrategy()
    if meta == "lamb":
        s.lamb = True
        s.lamb_configs.update(A3_LAMB)
    elif meta == "lars":
        s.lars = True
        s.lars_configs.update(A3_LARS)
    return s


def fleet_init(meta=None, **degrees):
    from paddle_tpu_torch.distributed import fleet

    s = meta_strategy(meta)
    s.hybrid_configs.update({"dp_degree": -1, **degrees})
    fleet.init(is_collective=True, strategy=s)


def phase_fleet_nccl(fa, smi, trained):
    """Phase 38: ``init_parallel_env`` on a ``file://`` store at world size
    1 (NCCL: the default device is the card), ``fleet.init``, then GPT-3
    1.3B at full depth through ``DistTrainStep`` for TRAIN_STEPS steps
    (K1 / K2a / K2b 24 x 4 launches, the NCCL all-reduces counted), and a
    depth-2 ``DistTrainStep`` against ``TrainStep`` on the same weights
    and batch: losses and parameters bit-equal (an all-reduce over one
    rank is the identity, the division by 1 exact)."""
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    with launch_env(PADDLE_TRAINER_ID=0, PADDLE_TRAINERS_NUM=1,
                    PADDLE_MASTER=f"file://{tmp}/rendezvous"):
        dist.init_parallel_env()
    backend = dist.get_backend()
    if backend != "NCCL":
        raise AssertionError(f"init_parallel_env chose {backend}, not NCCL")
    fleet_init()
    model = build_model(24)
    step, opt = dist_trainer(model)
    ids, labels = train_batch(model.config.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(fa)
    collective.reset_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = {k: getattr(fa, f"launches_{k}") for k in ("fwd", "dq", "dkv")}
    counts = dict(collective.counts)
    peak = torch.cuda.max_memory_allocated()
    tokens = ids.numel()
    ms = float(np.mean(step_ms[1:]))
    log(f"# phase 38: GPT-3 1.3B (24 layers) through fleet.init -> "
        f"distributed_model -> distributed_optimizer -> DistTrainStep, "
        f"backend {backend}, world size {dist.get_world_size()}")
    for i, (l, t) in enumerate(zip(losses, step_ms)):
        log(f"step {i}: loss {l:.6f}, {t:.1f} ms")
    log(f"steps 1-{TRAIN_STEPS - 1} mean {ms:.1f} ms = "
        f"{tokens / ms * 1e3:.1f} tokens/s (phase 7's TrainStep "
        f"{np.mean(trained['step_ms'][1:]):.1f} ms); peak memory "
        f"{peak / 2**30:.2f} GiB; NCCL collectives {counts}; flash "
        f"launches {launches}  [{smi}]")
    layers = model.config.num_hidden_layers
    if any(n != layers * TRAIN_STEPS for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != {layers} x "
                             f"{TRAIN_STEPS}")
    if not counts.get("all_reduce", 0) >= TRAIN_STEPS:
        raise AssertionError(f"no gradient all-reduce ran: {counts}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"losses {losses}")
    buckets = counts["all_reduce"] // TRAIN_STEPS
    del step, opt, model
    torch.cuda.empty_cache()

    a, b = build_model(FLEET_DEPTH), build_model(FLEET_DEPTH)
    step_a, _ = dist_trainer(a)
    step_b, _ = trainer(b)
    for i in range(LOCKSTEP_STEPS):
        la, lb = step_a(ids, labels), step_b(ids, labels)
        log(f"# phase 38: depth {FLEET_DEPTH} step {i}: DistTrainStep "
            f"{float(la):.7f} TrainStep {float(lb):.7f}")
        if not torch.equal(la, lb):
            raise AssertionError("DistTrainStep's loss differs from "
                                 "TrainStep's")
    pb = dict(b.named_parameters())
    differ = [n for n, p in a.named_parameters() if not torch.equal(p, pb[n])]
    log(f"# phase 38: {len(pb) - len(differ)}/{len(pb)} parameters "
        "bit-equal to TrainStep's after "
        f"{LOCKSTEP_STEPS} steps")
    if differ:
        raise AssertionError(f"parameters differ from TrainStep: {differ}")
    del step_a, step_b, a, b
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return dict(backend=backend, step_ms=step_ms, losses=losses,
                tokens_per_s=tokens / ms * 1e3, peak_gib=peak / 2 ** 30,
                collectives=counts, buckets_per_step=buckets,
                launches=launches,
                trainstep_step_ms=float(np.mean(trained["step_ms"][1:])),
                lockstep_bit_equal=True)


def _rank_fleet(out_dir, configs):
    """One rank of phase 39 (run by ``paddle.distributed.spawn``): each
    configuration in turn, its results pickled to ``out_dir``."""
    import hashlib
    import os
    import pickle

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.layers import mpu
    from paddle_tpu_torch.framework.io_state import gather_full_state
    from paddle_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    out = {"backend": dist.get_backend()}
    for name, degrees in configs.items():
        degrees = dict(degrees)
        sp = degrees.pop("sequence_parallel", False)
        meta = degrees.pop("meta", None)
        fleet_init(meta, **degrees)
        hcg = fleet.get_hybrid_communicate_group()
        model = build_model(FLEET_DEPTH, sequence_parallel=sp)
        step, opt = dist_trainer(model)
        ids, labels = train_batch(model.config.vocab_size)
        reset_flash(fa)
        torch.cuda.reset_peak_memory_stats()
        sq_sums, unwatch = (record_sq_sums(opt._inner_opt, model)
                            if meta else ({}, None))
        losses, step_ms = [], []
        for _ in range(LOCKSTEP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(ids, labels)))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if unwatch is not None:  # the first step's norms only
                unwatch = unwatch()
        launches = {k: getattr(fa, f"launches_{k}")
                    for k in ("fwd", "dq", "dkv")}
        # the replicated parameters, bit-equal on the mp ranks
        mp = hcg.get_model_parallel_group()
        rep_equal = True
        for _, p in model.named_parameters():
            if not mpu.is_mp_shard(p):
                got = dist.all_gather(None, p.detach(), group=mp)
                rep_equal &= all(torch.equal(g, got[0]) for g in got)
        full = gather_full_state(model)
        digest = hashlib.sha1()
        for n in sorted(full):
            digest.update(full[n].cpu().numpy().tobytes())
        res = dict(losses=losses, step_ms=step_ms, launches=launches,
                   digest=digest.hexdigest(),
                   heads=model.gpt.decoder[0].attn.num_heads,
                   replicated_bit_equal=bool(rep_equal),
                   mp_rank=hcg.get_model_parallel_rank(),
                   inner=type(opt._inner_opt).__name__, sq_sums=sq_sums,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del step, opt, model
        # the single-process reference is built with no hybrid group in
        # force: its layers are the plain ones
        fleet.topology.set_hybrid_communicate_group(None)
        if rank == 0:
            ref = build_model(FLEET_DEPTH)
            ref_step, ref_opt = trainer(ref, meta=meta)
            res["ref_sq_sums"], unwatch = (
                record_sq_sums(ref_opt, ref) if meta else ({}, None))
            res["ref_losses"] = []
            for _ in range(LOCKSTEP_STEPS):
                res["ref_losses"].append(float(ref_step(ids, labels)))
                if unwatch is not None:
                    unwatch = unwatch()
            dmax, far, total = 0.0, 0, 0
            for n, p in ref.named_parameters():
                d = (full[n] - p.detach()).abs()
                dmax = max(dmax, d.max().item())
                far += int((d > LOCKSTEP_PARAM_ATOL).sum())
                total += d.numel()
            res.update(param_max=dmax, param_far=far, param_total=total)
            del ref_step, ref_opt, ref
        del full
        torch.cuda.empty_cache()
        out[name] = res
        dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn_fleet_ranks(configs, timeout):
    """``_rank_fleet`` on two processes sharing the card over gloo: each
    rank's results and the seconds taken."""
    import os
    import pickle
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.parallel import join_spawned

    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    t0 = time.perf_counter()
    ctx = dist.spawn(_rank_fleet, (tmp, configs), nprocs=2, join=False,
                     backend="gloo", master=f"file://{tmp}/rendezvous")
    join_spawned(ctx, timeout)
    secs = time.perf_counter() - t0
    res = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res, secs


def check_gloo_config(name, a, b, smi, phase):
    """The gates of one two-rank configuration (ranks ``a``, ``b``) against
    rank 0's single-process ``TrainStep``: equal losses on the ranks, within
    TRAIN_LOSS_RTOL of the baseline, the gathered parameters by phase 8's
    rule, the mp ranks' replicated parameters bit-equal, each rank's
    K1 / K2a / K2b launches at its heads (8 at mp 2, 16 otherwise)."""
    bound = 2 * ADAMW["learning_rate"] * LOCKSTEP_STEPS
    rel = max(abs(x - y) / abs(y)
              for x, y in zip(a["losses"], a["ref_losses"]))
    heads = 8 if name.startswith("mp") else 16
    want = FLEET_DEPTH * LOCKSTEP_STEPS
    log(f"# phase {phase}: {name}: {a['inner']}, losses {a['losses']} vs "
        f"TrainStep {a['ref_losses']} (rel {rel:.2e}); params max |d| "
        f"{a['param_max']:.2e} (bound {bound:.1e}), "
        f"{a['param_far']}/{a['param_total']} beyond "
        f"{LOCKSTEP_PARAM_ATOL}; step ms {a['step_ms']}; peak "
        f"{a['peak_gib']:.2f} GiB; launches rank 0 {a['launches']} rank 1 "
        f"{b['launches']} at H={a['heads']}; replicated bit-equal "
        f"{a['replicated_bit_equal']}  [{smi}]")
    if a["losses"] != b["losses"]:
        raise AssertionError(f"{name}: the ranks' losses differ")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{name}: losses differ from TrainStep")
    if not (a["param_max"] <= bound
            and a["param_far"] <= 0.01 * a["param_total"]):
        raise AssertionError(f"{name}: parameters differ from TrainStep")
    if not (a["replicated_bit_equal"] and b["replicated_bit_equal"]):
        raise AssertionError(f"{name}: replicated parameters differ "
                             "across the mp ranks")
    for r in (a, b):
        if r["heads"] != heads or any(n != want
                                      for n in r["launches"].values()):
            raise AssertionError(f"{name}: launches {r['launches']} at "
                                 f"H={r['heads']}")
    out = {k: a[k] for k in ("losses", "ref_losses", "step_ms", "launches",
                             "heads", "param_max", "param_far", "peak_gib")}
    out["rank1_launches"] = b["launches"]
    return out


def phase_fleet_gloo(smi, timeout=600):
    """Phase 39: two processes on the one card over gloo (``backend="gloo"``
    given explicitly: NCCL runs one rank per device), each configuration
    of FLEET_CONFIGS at GPT-3 1.3B's widths and depth 2 against a
    single-process ``TrainStep`` on the same full weights: losses within
    TRAIN_LOSS_RTOL, gathered parameters within phase 8's rule, the mp
    ranks' replicated parameters bit-equal, sharding 2 bit-equal to dp 2;
    each rank's K1 / K2a / K2b launches at its heads (8 at mp 2, 16
    otherwise)."""
    res, secs = spawn_fleet_ranks(FLEET_CONFIGS, timeout)
    out = {"seconds": secs, "backend": res[0]["backend"],
           "refused_on_cuda": list(GLOO_CUDA_REFUSED)}
    for name in FLEET_CONFIGS:
        out[name] = check_gloo_config(name, res[0][name], res[1][name], smi,
                                      "39")
    # ZeRO-1 at sharding 2 against dp 2: the same two data ranks, the same
    # gradients, an elementwise update
    zero_equal = (res[0]["sharding2"]["losses"] == res[0]["dp2"]["losses"]
                  and res[0]["sharding2"]["digest"] == res[0]["dp2"]["digest"])
    log(f"# phase 39: sharding2 bit-equal to dp2 (losses and every "
        f"parameter): {zero_equal}")
    if not zero_equal:
        raise AssertionError("ZeRO-1 differs from dp 2")
    out["sharding2_bit_equal_dp2"] = zero_equal
    log(f"# phase 39: {secs:.1f} s (two processes, spawn, build and run)")
    return out


def phases_distributed(fa, smi, trained):
    """Phases 38-39; returns the ``distributed`` JSON line's numbers."""
    t0 = time.perf_counter()
    nccl = phase_fleet_nccl(fa, smi, trained)
    gloo = phase_fleet_gloo(smi)
    secs = time.perf_counter() - t0
    log(f"phases 38-39: {secs:.1f} s")
    return {"fleet_nccl_1p3b": nccl, "gloo_two_ranks": gloo,
            "seconds": secs, "card": smi}


# -- phases 40-41: fold_layers and pipeline parallelism ------------------------

# phase 41's batch: PP_MICROBATCHES micro-batches of one PP_SEQ-token row
PP_BATCH, PP_SEQ, PP_MICROBATCHES = 4, 1024, 4
# phase 41's configurations (pp 2, two ranks on the one card over gloo):
# GPT-3 1.3B at half its depth under 1F1B (24 layers until phase 56
# needed the room), then the other schedules at depth 4
PP_CONFIGS = {"1f1b_12": dict(layers=12, schedule="1f1b", vpp=1),
              "gpipe_4": dict(layers=4, schedule="gpipe", vpp=1),
              "zero_bubble_4": dict(layers=4, schedule="zero_bubble", vpp=1),
              "1f1b_v2_4": dict(layers=4, schedule="1f1b", vpp=2)}


def pp_batch(vocab, device=None):
    """Next-token batch [PP_BATCH, PP_SEQ] of ids and labels (numpy)."""
    rng = np.random.default_rng(SEED + 41)
    tok = rng.integers(0, vocab, (PP_BATCH, PP_SEQ + 1))
    tok = torch.as_tensor(tok, device=device or DEVICE)
    return tok[:, :-1].contiguous(), tok[:, 1:].contiguous()


def param_gap(got, want):
    """Phase 8's rule on ``{name: tensor}`` pairs: ``(max |d|, elements
    beyond LOCKSTEP_PARAM_ATOL, elements)``."""
    dmax, far, total = 0.0, 0, 0
    for n, w in want.items():
        d = (got[n].to(w.device) - w).abs()
        dmax = max(dmax, d.max().item())
        far += int((d > LOCKSTEP_PARAM_ATOL).sum())
        total += d.numel()
    return dmax, far, total


def check_param_gap(gap, steps, what, lr=ADAMW["learning_rate"]):
    """Phase 8's rule: max |d| within twice AdamW's move over ``steps`` at
    learning rate ``lr``, at most 1% of the elements beyond
    LOCKSTEP_PARAM_ATOL."""
    dmax, far, total = gap
    if not (dmax <= 2 * lr * steps and far <= 0.01 * total):
        raise AssertionError(f"{what}: parameters differ from TrainStep "
                             f"(max {dmax}, {far}/{total} beyond)")


def unstacked(state, order, prefix="gpt.decoder."):
    """A gathered stacked state under the unfolded names: the stacked
    ``{prefix}{leaf with __}`` ``[L, ...]`` (layers in ``order``) as
    ``{prefix}{layer}.{leaf}``."""
    out = {}
    for k, v in state.items():
        if k.startswith(prefix) and "__" in k[len(prefix):]:
            leaf = k[len(prefix):].replace("__", ".")
            for pos, layer in enumerate(order):
                out[f"{prefix}{layer}.{leaf}"] = v[pos]
        else:
            out[k] = v
    return out


def timed_steps(step, batch, steps, sync):
    losses, step_ms = [], []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    return losses, step_ms


def phase_fold(fa, smi, trained):
    """Phase 40: GPT-3 1.3B (24 layers) with ``fold_layers=True`` through
    ``TrainStep``, LOCKSTEP_STEPS steps on phase 7's weights and batch:
    the losses against phase 7's (bit-equal, else within TRAIN_LOSS_RTOL),
    the final parameters against an unfolded ``TrainStep``'s by phase 8's
    rule, K1 / K2a / K2b 24 x LOCKSTEP_STEPS launches."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import SpmdPipeline

    model = build_model(24, fold_layers=True)
    if not isinstance(model.gpt.decoder, SpmdPipeline) \
            or model.gpt.decoder.pipelined:
        raise AssertionError("fold_layers did not build the fold")
    step, _ = trainer(model)
    batch = train_batch(model.config.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash(fa)
    losses, step_ms = timed_steps(step, batch, LOCKSTEP_STEPS,
                                  torch.cuda.synchronize)
    launches = {k: getattr(fa, f"launches_{k}") for k in ("fwd", "dq", "dkv")}
    peak = torch.cuda.max_memory_allocated()
    want = trained["losses"][:LOCKSTEP_STEPS]
    bit_equal = losses == want
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    folded = {n.replace("decoder.blocks.", "decoder."): p.detach()
              for n, p in model.named_parameters()}
    del step, model
    torch.cuda.empty_cache()
    ref = build_model(24)
    ref_step, _ = trainer(ref)
    for _ in range(LOCKSTEP_STEPS):
        ref_step(*batch)
    gap = param_gap(folded, {n: p.detach() for n, p in ref.named_parameters()})
    del ref_step, ref, folded
    torch.cuda.empty_cache()
    layers = 24
    log(f"# phase 40: GPT-3 1.3B (24 layers) fold_layers=True through "
        f"TrainStep: losses {losses} vs phase 7's {want}: "
        f"{'bit-equal' if bit_equal else f'rel {rel:.2e}'}; params max |d| "
        f"{gap[0]:.2e}, {gap[1]}/{gap[2]} beyond {LOCKSTEP_PARAM_ATOL}; "
        f"step ms {[round(t, 1) for t in step_ms]} (phase 7's "
        f"{[round(t, 1) for t in trained['step_ms'][:LOCKSTEP_STEPS]]}); "
        f"peak {peak / 2**30:.2f} GiB; launches {launches}  [{smi}]")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("the folded losses differ from phase 7's")
    check_param_gap(gap, LOCKSTEP_STEPS, "phase 40")
    if any(n != layers * LOCKSTEP_STEPS for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != {layers} x "
                             f"{LOCKSTEP_STEPS}")
    return dict(losses=losses, phase7_losses=want, bit_equal=bit_equal,
                rel=rel, step_ms=step_ms,
                phase7_step_ms=trained["step_ms"][:LOCKSTEP_STEPS],
                peak_gib=peak / 2 ** 30, param_max=gap[0],
                param_far=gap[1], launches=launches)


def _boundary_messages(S, V, stage):
    """Chunk boundaries this stage sends or receives across, per
    micro-batch and direction: chunk c hands on to chunk c + 1."""
    return sum((c % S == stage) + ((c + 1) % S == stage)
               for c in range(S * V - 1))


def pp_launches(c, stage):
    """K1 / K2a / K2b launches of one pp-2 rank over LOCKSTEP_STEPS steps:
    one of each per local layer and micro-batch, but under zero_bubble a
    chunk with an input cotangent to send runs its backward twice (the
    input-gradient tick, then the deferred weight-gradient pass through the
    same graph, as the reference's weight-gradient scan does)."""
    chunk = c["layers"] // (2 * c["vpp"])
    bwd = sum(chunk * (2 if c["schedule"] == "zero_bubble"
                       and v * 2 + stage > 0 else 1)
              for v in range(c["vpp"]))
    n = PP_MICROBATCHES * LOCKSTEP_STEPS
    return {"fwd": chunk * c["vpp"] * n, "dq": bwd * n, "dkv": bwd * n}


def _rank_pipeline(out_dir, configs, spec):
    """One rank of phase 41 (run by ``paddle.distributed.spawn``): each
    configuration in turn at pp 2 through ``fleet.init`` ->
    ``distributed_model`` -> ``distributed_optimizer`` -> ``DistTrainStep``,
    its results pickled to ``out_dir``; rank 0 then trains the same
    weights through a single-process ``TrainStep``. ``spec``: the device,
    and the model's config for a rehearsal (None: ``build_model``)."""
    import os
    import pickle

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        pipeline_parallel as pp)
    from paddle_tpu_torch.framework.io_state import gather_full_state
    from paddle_tpu_torch.ops import flash_attention as fa

    device = spec["device"]
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if spec.get("prepare"):
        spec["prepare"]()

    def build(layers):
        if spec.get("model") is None:
            return build_model(layers)
        from paddle_tpu_torch.text.models.gpt import (GPTConfig,
                                                      GPTForCausalLM)

        return GPTForCausalLM(GPTConfig(**dict(
            spec["model"], num_hidden_layers=layers)), device=device,
            seed=SEED)

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    out = {"backend": dist.get_backend()}
    for name, c in configs.items():
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=-1, pp_degree=2)
        s.pipeline_configs.update(schedule=c["schedule"],
                                  virtual_pp_degree=c["vpp"],
                                  accumulate_steps=PP_MICROBATCHES)
        fleet.init(is_collective=True, strategy=s)
        hcg = fleet.get_hybrid_communicate_group()
        model = build(c["layers"])
        pipe = model.gpt.decoder
        if not (isinstance(pipe, pp.SpmdPipeline) and pipe.pipelined):
            raise AssertionError(f"{name}: the decoder is not pipelined")
        step, _ = dist_trainer(model)
        batch = pp_batch(model.config.vocab_size, device)
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_flash(fa)
        collective.reset_counts()
        pp.reset_counts()
        losses, step_ms = timed_steps(step, batch, LOCKSTEP_STEPS, sync)
        launches = {k: getattr(fa, f"launches_{k}")
                    for k in ("fwd", "dq", "dkv")}
        hidden = model.config.hidden_size
        group = hcg.get_pipe_parallel_group()
        rep = [p for p in model.parameters() if not pp.is_pipeline_local(p)]
        rep_equal = True
        for p in rep:
            got = dist.all_gather(None, p.detach(), group=group)
            rep_equal &= all(torch.equal(g, got[0]) for g in got)
        res = dict(
            losses=losses, step_ms=step_ms, launches=launches,
            stage=hcg.get_stage_id(), local_blocks=len(pipe.blocks),
            staged_bytes=collective.counts.get("p2p_staged_bytes", 0),
            boundary_bytes=PP_BATCH // PP_MICROBATCHES * PP_SEQ * hidden * 4,
            boundary_messages=_boundary_messages(2, c["vpp"],
                                                 hcg.get_stage_id()),
            replicated_grad_bytes=pp.counts["replicated_grad_bytes"],
            replicated_bytes=sum(p.numel() * p.element_size() for p in rep),
            ops=dict(pp.counts), replicated_bit_equal=bool(rep_equal),
            peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                      if on_card else 0.0),
            schedule_info=pipe.schedule_info(PP_BATCH))
        order = list(pipe._layer_order)
        full = gather_full_state(model)
        del step, model, pipe, rep
        fleet.topology.set_hybrid_communicate_group(None)
        if rank == 0:
            if on_card:
                torch.cuda.empty_cache()
            ref = build(c["layers"])
            ref_step, _ = trainer(ref)
            res["ref_losses"], res["ref_step_ms"] = timed_steps(
                ref_step, batch, LOCKSTEP_STEPS, sync)
            gap = param_gap(unstacked(full, order),
                            {n: p.detach() for n, p in ref.named_parameters()})
            res.update(param_max=gap[0], param_far=gap[1],
                       param_total=gap[2])
            del ref_step, ref
        del full
        if on_card:
            torch.cuda.empty_cache()
        out[name] = res
        dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_pipeline_gloo(smi, timeout=600, spec=None):
    """Phase 41: pipeline parallelism at pp 2, two processes on the one
    card over gloo (``backend="gloo"`` given explicitly: NCCL runs one
    rank per device), point to point staged through pinned host buffers.
    Each configuration of PP_CONFIGS (GPT-3 1.3B at 12 layers under 1F1B,
    then gpipe, zero_bubble and interleaved 1F1B at depth 4) against a
    single-process ``TrainStep`` on the same full weights and batch:
    losses within TRAIN_LOSS_RTOL, gathered parameters by phase 8's rule,
    the replicated parameters bit-equal on both ranks, each rank's K1 /
    K2a / K2b launches = its layers x micro-batches x steps, the staged
    bytes = the chunk boundaries' activations and cotangents, the
    replicated gradients summed over the pipe group once a step."""
    import os
    import pickle
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.parallel import join_spawned

    spec = spec or {"device": DEVICE}
    configs = PP_CONFIGS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    t0 = time.perf_counter()
    ctx = dist.spawn(_rank_pipeline, (tmp, configs, spec), nprocs=2,
                     join=False, backend="gloo",
                     master=f"file://{tmp}/rendezvous")
    join_spawned(ctx, timeout)
    secs = time.perf_counter() - t0
    res = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    out = {"seconds": secs, "backend": res[0]["backend"]}
    for name, c in configs.items():
        a, b = res[0][name], res[1][name]
        rel = max(abs(x - y) / abs(y)
                  for x, y in zip(a["losses"], a["ref_losses"]))
        info = a["schedule_info"]
        log(f"# phase 41: pp 2 {c['schedule']} V={c['vpp']} at "
            f"{c['layers']} layers, M={PP_MICROBATCHES}: losses "
            f"{a['losses']} vs TrainStep {a['ref_losses']} (rel "
            f"{rel:.2e}); params max |d| {a['param_max']:.2e}, "
            f"{a['param_far']}/{a['param_total']} beyond "
            f"{LOCKSTEP_PARAM_ATOL}; step ms rank 0 "
            f"{[round(t, 1) for t in a['step_ms']]} rank 1 "
            f"{[round(t, 1) for t in b['step_ms']]} (TrainStep "
            f"{[round(t, 1) for t in a['ref_step_ms']]}); bubble fraction "
            f"{info['bubble_fraction']:.3f} analytic "
            f"{info['analytic_bubble_fraction']:.3f} measured "
            f"{info['measured_bubble_fraction']:.3f}; launches rank 0 "
            f"{a['launches']} rank 1 {b['launches']}; staged "
            f"{a['staged_bytes']} / {b['staged_bytes']} B; replicated "
            f"gradients {a['replicated_grad_bytes']} B; peak "
            f"{a['peak_gib']:.2f} / {b['peak_gib']:.2f} GiB; replicated "
            f"bit-equal {a['replicated_bit_equal']}  [{smi}]")
        if a["losses"] != b["losses"]:
            raise AssertionError(f"{name}: the ranks' losses differ")
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"{name}: losses differ from TrainStep")
        check_param_gap((a["param_max"], a["param_far"], a["param_total"]),
                        LOCKSTEP_STEPS, f"phase 41 {name}")
        if not (a["replicated_bit_equal"] and b["replicated_bit_equal"]):
            raise AssertionError(f"{name}: replicated parameters differ "
                                 "across the pp ranks")
        if {a["stage"], b["stage"]} != {0, 1}:
            raise AssertionError(f"{name}: stages {a['stage']}, {b['stage']}")
        for r in (a, b):
            want = pp_launches(c, r["stage"])
            if r["local_blocks"] * 2 != c["layers"] or r["launches"] != want:
                raise AssertionError(f"{name}: launches {r['launches']} "
                                     f"!= {want}")
            staged = (r["boundary_messages"] * 2 * PP_MICROBATCHES
                      * r["boundary_bytes"] * LOCKSTEP_STEPS)
            if spec["device"] == "cuda" and r["staged_bytes"] != staged:
                raise AssertionError(f"{name}: staged {r['staged_bytes']} B "
                                     f"!= {staged} B")
            if r["replicated_grad_bytes"] != \
                    r["replicated_bytes"] * LOCKSTEP_STEPS:
                raise AssertionError(f"{name}: replicated gradients "
                                     f"{r['replicated_grad_bytes']} B")
        out[name] = {k: a[k] for k in (
            "losses", "ref_losses", "step_ms", "ref_step_ms", "launches",
            "param_max", "param_far", "staged_bytes", "boundary_bytes",
            "replicated_grad_bytes", "peak_gib", "schedule_info")}
        out[name].update(rank1_launches=b["launches"],
                         rank1_step_ms=b["step_ms"],
                         rank1_staged_bytes=b["staged_bytes"],
                         rank1_peak_gib=b["peak_gib"],
                         staged_per_step=a["staged_bytes"] // LOCKSTEP_STEPS)
    log(f"# phase 41: {secs:.1f} s (two processes, spawn, build and run)")
    return out


def phases_pipeline(fa, smi, trained):
    """Phases 40-41; returns the ``pipeline`` JSON line's numbers."""
    t0 = time.perf_counter()
    fold = phase_fold(fa, smi, trained)
    torch.cuda.empty_cache()
    pipe = phase_pipeline_gloo(smi)
    secs = time.perf_counter() - t0
    log(f"phases 40-41: {secs:.1f} s")
    return {"fold_1p3b": fold, "pp2_gloo": pipe, "seconds": secs,
            "card": smi}


# -- phases 42-43: the sep axis and expert parallelism ------------------------

# phase 42a's ring: GPT-3 1.3B's attention at phase 7's batch, split in two
SEP_RING = dict(b=TRAIN_BATCH, t=TRAIN_SEQ, h=16, d=128)
SEP_DEGREE = 2
SEP_LAYERS = 24
# phase 43: Mixtral 8x7B's MoE block on the capacity path, experts split
# over sharding 2 (4 a rank)
EP_DEGREE = 2
EP_CAPACITY_FACTOR = 1.25


def ring_blocks(shape, dtype, device, n, rank):
    """Global causal-attention inputs q, k, v, dO ``[B, T, H, D]`` from one
    seeded generator (the same on every rank) and this rank's contiguous
    blocks of them."""
    gen = torch.Generator(device=device).manual_seed(SEED + 42)
    full = [torch.randn((shape["b"], shape["t"], shape["h"], shape["d"]),
                        generator=gen, device=device).to(dtype)
            for _ in range(4)]
    tl = shape["t"] // n
    return full, [x[:, rank * tl:(rank + 1) * tl].contiguous() for x in full]


def ring_run(fn, blocks, group):
    """``fn``'s output and q / k / v gradients under dO on one rank."""
    q, k, v = (x.detach().clone().requires_grad_() for x in blocks[:3])
    o = fn(q, k, v, group, causal=True)
    o.backward(blocks[3])
    return [o.detach(), q.grad, k.grad, v.grad]


def f64_oracle_probe(fa, full, got, want, n, rank):
    """ROADMAP §C's probe of the ring's f32 error: causal attention on
    the whole sequence in float64 torch (the oracle), sliced to this
    rank's block, against the kernel ring (``got``), the plain ring
    (``want``) and K1 / K2 on the whole sequence (``fa.flash_attention``,
    sliced the same way): (max|err|, max|err| / max|oracle|) per tensor
    and route. A probe: it prints, it gates nothing."""
    q, k, v, do = (x.detach().double() for x in full)
    q.requires_grad_()
    k.requires_grad_()
    v.requires_grad_()
    d = q.shape[-1]
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    o.backward(do)
    oracle = [o.detach(), q.grad, k.grad, v.grad]
    del s, o
    whole = ring_run(lambda q_, k_, v_, _g, causal: fa.flash_attention(
        q_, k_, v_, causal=causal), full, None)
    tl = t // n
    blk = slice(rank * tl, (rank + 1) * tl)
    out = {}
    for route, vals in (("kernel_ring", got), ("plain_ring", want),
                        ("k1_whole", [x[:, blk] for x in whole])):
        out[route] = {name: _rel(g.double(), w[:, blk])
                      for name, g, w in zip(("o", "dq", "dk", "dv"), vals,
                                            oracle)}
    return out


def staged_per_step(layers, n, b, tl, h, d):
    """Bytes a rank stages through pinned host memory in one f32 training
    step of ``layers`` ring attentions at sep ``n``: every rotation stages
    its send and its receive; the forward rotates K/V ``n - 1`` times, the
    backward (which keeps the blocks received) their f32 dK / dV ``n - 1``
    times."""
    kv = 2 * b * tl * h * d * 4
    return layers * 2 * 2 * (n - 1) * kv


def build_ep_moe(dim, hidden, device=None):
    """Phase 11's regressor on the capacity path (``drop_tokens=True``),
    built after ``fleet.init`` when one is in force (its experts then
    split over the expert axis)."""
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.initializer import XavierNormal

    dev = device or DEVICE

    class MoERegressor(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator(device=dev).manual_seed(SEED)
            self.moe = MoELayer(dim, hidden, MOE_EXPERTS, top_k=MOE_TOP_K,
                                capacity_factor=EP_CAPACITY_FACTOR,
                                device=dev, generator=gen)
            self.head = Linear(dim, 1, device=dev, generator=gen,
                               weight_init=XavierNormal())

        def forward(self, x):
            return self.head(self.moe(x))

    return MoERegressor()


def _rank_sep_ep(out_dir, trained_losses, spec):
    """One rank of phases 42-43 (run by ``paddle.distributed.spawn``), its
    results pickled to ``out_dir``. 42a: the kernel ring against the plain
    ring at SEP_RING, f32 and bf16, and (rank 0) the gathered output
    against K1 on the whole sequence; in f32 both rings and K1 / K2 on the
    whole sequence against an f64 oracle (:func:`f64_oracle_probe`); 42b:
    GPT-3 1.3B at SEP_LAYERS layers through ``DistTrainStep`` at sep 2,
    then (rank 0) a single-process
    ``TrainStep`` on the same weights and batch; 43: the capacity MoE block
    at EP 2 through ``DistTrainStep``, then (each rank) a single-process
    ``TrainStep`` on the same weights and batch. ``spec``: the device, and
    for a rehearsal a tiny ``GPTConfig`` dict, ring shape, MoE widths and
    a ``prepare`` function the child runs first."""
    import os
    import pickle

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.framework.io_state import gather_full_state
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.functional import ring_attention as ra
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    device = spec["device"]
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if spec.get("prepare"):
        spec["prepare"]()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0

    def reset_peak():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    out = {"backend": dist.get_backend()}

    # -- 42a: the ring on the kernels against the plain ring
    fleet_init(sep_degree=SEP_DEGREE)
    group = fleet.get_hybrid_communicate_group().get_sep_parallel_group()
    shape = spec.get("ring", SEP_RING)
    ring = {}
    for dtype in (torch.float32, torch.bfloat16):
        full, blocks = ring_blocks(shape, dtype, device, SEP_DEGREE,
                                   group.rank)
        got = ring_run(ra.ring_flash_attention, blocks, group)
        # the plain ring on the same values in f32 (the exact math)
        want = ring_run(ra.ring_flash_attention_plain,
                        [x.float() for x in blocks], group)
        sync()
        errs = {name: _rel(g, w) for name, g, w in
                zip(("o", "dq", "dk", "dv"), got, want)}
        probe = (f64_oracle_probe(fa, full, got, want, SEP_DEGREE,
                                  group.rank)
                 if dtype == torch.float32 else None)
        gathered = dist.all_gather(None, got[0].contiguous(), group=group)
        whole = None
        if rank == 0:
            o_full, _ = fa.flash_attention_forward_cuda(*full[:3],
                                                        causal=True)
            whole = _rel(torch.cat(gathered, dim=1), o_full)
        times = {}
        for route, fn, ins in (
                ("kernels", ra.ring_flash_attention, blocks),
                ("plain", ra.ring_flash_attention_plain,
                 [x.float() for x in blocks])):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            ring_run(fn, ins, group)
            sync()
            times[route] = 1e3 * (time.perf_counter() - t0)
        ring[str(dtype)[6:]] = dict(errs=errs, whole=whole, ms=times,
                                    shape=shape, f64_probe=probe)
        del full, blocks, got, want, gathered
    out["ring"] = ring
    fleet.topology.set_hybrid_communicate_group(None)

    # -- 42b: GPT-3 1.3B at sep 2 through DistTrainStep
    def build(layers):
        if spec.get("model") is None:
            return build_model(layers)
        from paddle_tpu_torch.text.models.gpt import (GPTConfig,
                                                      GPTForCausalLM)

        return GPTForCausalLM(GPTConfig(**dict(
            spec["model"], num_hidden_layers=layers)), device=device,
            seed=SEED)

    fleet_init(sep_degree=SEP_DEGREE)
    model = build(SEP_LAYERS)
    step = dist_trainer(model)[0]
    ids, labels = train_batch(model.config.vocab_size)
    reset_peak()
    reset_flash(fa)
    collective.reset_counts()
    losses, step_ms = timed_steps(step, (ids, labels), LOCKSTEP_STEPS, sync)
    cfg = model.config
    heads = cfg.num_attention_heads
    full = gather_full_state(model)
    out["sep"] = dict(
        losses=losses, step_ms=step_ms, peak_gib=peak_gib(),
        launches={k: getattr(fa, f"launches_{k}")
                  for k in ("fwd", "dq", "dkv")},
        sep_rank=group.rank,
        staged_bytes=collective.counts.get("p2p_staged_bytes", 0),
        staged_want=staged_per_step(
            SEP_LAYERS, SEP_DEGREE, ids.shape[0],
            ids.shape[1] // SEP_DEGREE, heads,
            cfg.hidden_size // heads) * LOCKSTEP_STEPS,
        rotations=collective.counts.get("batch_isend_irecv", 0),
        digests={k: v.double().sum().item() for k, v in full.items()},
        ref_losses=list(trained_losses[:LOCKSTEP_STEPS]))
    del step, model
    fleet.topology.set_hybrid_communicate_group(None)
    reset_peak()
    if rank == 0:
        # the same weights and batch through a single-process TrainStep
        ref = build(SEP_LAYERS)
        ref_step, ref_opt = trainer(ref)
        timed_steps(ref_step, (ids, labels), LOCKSTEP_STEPS, sync)
        out["sep"]["param_gap"] = param_gap(
            full, {n: p.detach() for n, p in ref.named_parameters()})
        del ref_step, ref_opt, ref
    del full
    reset_peak()
    dist.barrier()

    # -- 43: the capacity MoE block at EP 2 through DistTrainStep
    dim, hidden = spec.get("moe", (MOE_DIM, MOE_HIDDEN))
    fleet_init(sharding_degree=EP_DEGREE)
    hcg = fleet.get_hybrid_communicate_group()
    model = build_ep_moe(dim, hidden, device)
    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **MOE_ADAMW)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    step = fleet.DistTrainStep(model, moe_loss, opt)
    rng = np.random.default_rng(SEED + 43)
    x = torch.as_tensor(rng.standard_normal(
        (TRAIN_BATCH, TRAIN_SEQ, dim), np.float32), device=device)
    y = torch.as_tensor(rng.standard_normal(
        (TRAIN_BATCH, TRAIN_SEQ, 1), np.float32), device=device)
    reset_peak()
    collective.reset_counts()
    losses, step_ms = timed_steps(step, (x, y), LOCKSTEP_STEPS, sync)
    er = hcg.get_expert_parallel_rank()
    el = MOE_EXPERTS // EP_DEGREE
    g = TRAIN_BATCH * TRAIN_SEQ
    cap = max(MOE_TOP_K, int(np.ceil(MOE_TOP_K * EP_CAPACITY_FACTOR * g
                                     / MOE_EXPERTS)))
    ep = dict(
        losses=losses, step_ms=step_ms, peak_gib=peak_gib(),
        expert_rank=er, expert_axis=hcg.get_expert_parallel_axis(),
        local_experts=int(model.moe.w_in.shape[0]),
        scatter_bytes=collective.counts.get("global_scatter_bytes", 0),
        gather_bytes=collective.counts.get("global_gather_bytes", 0),
        # a step sends the [E, C, h] buffer out (global_scatter) and its
        # output back (global_gather); the backward returns the output's
        # cotangent (global_gather's backward) and, only when the block's
        # input takes a gradient, the buffer's (not here: x is data)
        scatter_want=MOE_EXPERTS * cap * dim * 4 * LOCKSTEP_STEPS,
        gather_want=2 * MOE_EXPERTS * cap * dim * 4 * LOCKSTEP_STEPS,
        capacity=cap)
    mine = {n: p.detach().clone() for n, p in model.named_parameters()}
    del step, opt, model
    fleet.topology.set_hybrid_communicate_group(None)
    reset_peak()
    ref = build_ep_moe(dim, hidden, device)
    ref_opt = AdamW(parameters=ref.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0), **MOE_ADAMW)
    ref_step = TrainStep(ref, moe_loss, ref_opt)
    ep["ref_losses"], ep["ref_step_ms"] = timed_steps(
        ref_step, (x, y), LOCKSTEP_STEPS, sync)
    want = {}
    for n, p in ref.named_parameters():
        w = p.detach()
        if n.startswith("moe.") and n != "moe.gate.weight" and \
                n != "moe.gate.bias":
            w = w[er * el:(er + 1) * el]
        want[n] = w
    ep["param_gap"] = param_gap(mine, want)
    gate = ("moe.gate.weight", "moe.gate.bias")
    ep["gate_gap"] = param_gap({n: mine[n] for n in gate},
                               {n: want[n] for n in gate})
    out["ep"] = ep
    del ref_step, ref_opt, ref, mine, want, x, y
    reset_peak()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phases_sep_ep(fa, smi, trained, timeout=900, spec=None):
    """Phases 42-43, two processes on the one card over gloo (point to
    point staged through pinned host buffers). Phase 42: the ring at
    GPT-3 1.3B's attention shape (kernels against the plain ring, the
    gathered output against K1 on the whole sequence), then GPT-3 1.3B at
    SEP_LAYERS layers at sep 2 against phase 7's ``TrainStep`` losses on
    the same weights and batch, the parameters (each leaf's sum equal on
    both ranks) against a single-process ``TrainStep``'s by phase 8's
    rule, each rank's K1 / K2a / K2b launches (rank ``r`` runs ``r + 1``
    ring blocks a layer) and its staged bytes against the K/V
    arithmetic. Phase 43: Mixtral 8x7B's MoE block on the capacity path
    at EP 2 (over sharding) against a single-process ``TrainStep``:
    losses, each rank's expert slice by phase 8's rule at MOE_ADAMW's
    rate, every element of the gate's leaves within LOCKSTEP_PARAM_ATOL,
    the exchange's bytes against the ``[E, C, h]`` arithmetic. Returns the
    ``sep_ep`` JSON line's numbers."""
    import os
    import pickle
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.parallel import join_spawned

    spec = spec or {"device": DEVICE}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sep_ep_")
    t0 = time.perf_counter()
    ctx = dist.spawn(_rank_sep_ep, (tmp, trained["losses"], spec), nprocs=2,
                     join=False, backend="gloo",
                     master=f"file://{tmp}/rendezvous")
    join_spawned(ctx, timeout)
    secs = time.perf_counter() - t0
    res = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    a, b = res
    out = {"seconds": secs, "backend": a["backend"], "card": smi}

    # 42a
    for dt, ra_ in a["ring"].items():
        tol = FLASH_TOL[getattr(torch, dt)]
        for r, rr in enumerate((ra_, b["ring"][dt])):
            sh = rr["shape"]
            log(f"# phase 42a: ring {dt} B={sh['b']} T={sh['t']} "
                f"H={sh['h']} D={sh['d']} sep {SEP_DEGREE} rank "
                f"{r}: kernels vs plain ring rel "
                + ", ".join(f"{k} {v[1]:.1e}" for k, v in rr["errs"].items())
                + f" (tol {tol:.1e}); ms kernels {rr['ms']['kernels']:.1f} "
                f"plain {rr['ms']['plain']:.1f} (forward + backward, host "
                f"staged rotations)  [{smi}]")
            for route, errs in (rr.get("f64_probe") or {}).items():
                log(f"# phase 42a probe: {dt} rank {r} {route} vs the f64 "
                    "oracle on the whole sequence: rel "
                    + ", ".join(f"{k} {v[1]:.2e}" for k, v in errs.items())
                    + f"  [{smi}]")
            for k, (err, rel) in rr["errs"].items():
                if not rel <= tol:
                    raise AssertionError(f"phase 42a: {dt} rank {r} {k} "
                                         f"differs: {rel} > {tol}")
        err, rel = ra_["whole"]
        log(f"# phase 42a: {dt} gathered ring output vs K1 on the whole "
            f"sequence: rel {rel:.1e} (tol {tol:.1e})")
        if not rel <= tol:
            raise AssertionError(f"phase 42a: {dt} ring differs from K1")
    out["ring"] = {"rank0": a["ring"], "rank1": b["ring"]}

    # 42b
    sa, sb = a["sep"], b["sep"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(sa["losses"],
                                                  sa["ref_losses"]))
    log(f"# phase 42b: GPT-3 1.3B ({SEP_LAYERS} layers) at sep "
        f"{SEP_DEGREE}, {TRAIN_BATCH} x {TRAIN_SEQ}: losses {sa['losses']} "
        f"vs phase 7's TrainStep {sa['ref_losses']} (rel {rel:.2e}); step "
        f"ms rank 0 {[round(t, 1) for t in sa['step_ms']]} rank 1 "
        f"{[round(t, 1) for t in sb['step_ms']]}; peak {sa['peak_gib']:.2f}"
        f" / {sb['peak_gib']:.2f} GiB; launches rank 0 {sa['launches']} "
        f"rank 1 {sb['launches']}; staged {sa['staged_bytes']} / "
        f"{sb['staged_bytes']} B (K/V arithmetic {sa['staged_want']} B); "
        f"params vs TrainStep max |d| {sa['param_gap'][0]:.2e}, "
        f"{sa['param_gap'][1]}/{sa['param_gap'][2]} beyond "
        f"{LOCKSTEP_PARAM_ATOL}  [{smi}]")
    if sa["losses"] != sb["losses"]:
        raise AssertionError("phase 42b: the ranks' losses differ")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("phase 42b: losses differ from TrainStep")
    if sa["digests"] != sb["digests"]:
        raise AssertionError("phase 42b: the sep ranks' parameters differ")
    check_param_gap(sa["param_gap"], LOCKSTEP_STEPS, "phase 42b")
    for s_ in (sa, sb):
        blocks = s_["sep_rank"] + 1
        want = SEP_LAYERS * blocks * LOCKSTEP_STEPS
        if any(n != want for n in s_["launches"].values()):
            raise AssertionError(f"phase 42b: launches {s_['launches']} != "
                                 f"{SEP_LAYERS} x {blocks} x "
                                 f"{LOCKSTEP_STEPS}")
        if spec["device"] == "cuda" and \
                s_["staged_bytes"] != s_["staged_want"]:
            raise AssertionError(f"phase 42b: staged {s_['staged_bytes']} "
                                 f"B != {s_['staged_want']} B")
    out["sep_1p3b"] = dict(
        {k: sa[k] for k in ("losses", "ref_losses", "step_ms", "peak_gib",
                            "launches", "staged_bytes", "staged_want")},
        rel=rel, param_max=sa["param_gap"][0], param_far=sa["param_gap"][1],
        rank1_step_ms=sb["step_ms"], rank1_peak_gib=sb["peak_gib"],
        rank1_launches=sb["launches"],
        rank1_staged_bytes=sb["staged_bytes"],
        staged_per_step=sa["staged_bytes"] // LOCKSTEP_STEPS)

    # 43
    ea, eb = a["ep"], b["ep"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(ea["losses"],
                                                  ea["ref_losses"]))
    log(f"# phase 43: Mixtral 8x7B MoE block (capacity path, "
        f"{MOE_EXPERTS} experts, top-{MOE_TOP_K}, C={ea['capacity']}) at EP "
        f"{EP_DEGREE} over {ea['expert_axis']}: losses {ea['losses']} vs "
        f"TrainStep {ea['ref_losses']} (rel {rel:.2e}); params max |d| "
        f"{ea['param_gap'][0]:.2e} / {eb['param_gap'][0]:.2e}, "
        f"{ea['param_gap'][1]} + {eb['param_gap'][1]} beyond "
        f"{LOCKSTEP_PARAM_ATOL} (gate max |d| {ea['gate_gap'][0]:.2e} / "
        f"{eb['gate_gap'][0]:.2e}); step ms rank 0 "
        f"{[round(t, 1) for t in ea['step_ms']]} rank 1 "
        f"{[round(t, 1) for t in eb['step_ms']]} (TrainStep "
        f"{[round(t, 1) for t in ea['ref_step_ms']]}); peak "
        f"{ea['peak_gib']:.2f} / {eb['peak_gib']:.2f} GiB; global_scatter "
        f"{ea['scatter_bytes']} B, global_gather {ea['gather_bytes']} B "
        f"([E, C, h] arithmetic {ea['scatter_want']} / {ea['gather_want']} "
        f"B)  [{smi}]")
    if ea["losses"] != eb["losses"]:
        raise AssertionError("phase 43: the ranks' losses differ")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("phase 43: losses differ from TrainStep")
    if {ea["expert_rank"], eb["expert_rank"]} != {0, 1}:
        raise AssertionError("phase 43: expert ranks")
    for e_ in (ea, eb):
        check_param_gap(e_["param_gap"], LOCKSTEP_STEPS, "phase 43",
                        MOE_ADAMW["learning_rate"])
        # the gate's leaves, which the gate's all-reduced sums feed, on
        # their own: every element
        if e_["gate_gap"][1]:
            raise AssertionError(f"phase 43: gate parameters differ from "
                                 f"TrainStep (max {e_['gate_gap'][0]})")
        if e_["local_experts"] != MOE_EXPERTS // EP_DEGREE:
            raise AssertionError(f"phase 43: {e_['local_experts']} experts "
                                 "on a rank")
        if e_["scatter_bytes"] != e_["scatter_want"] or \
                e_["gather_bytes"] != e_["gather_want"]:
            raise AssertionError("phase 43: exchange bytes differ from the "
                                 "[E, C, h] arithmetic")
    out["ep_mixtral_block"] = dict(
        {k: ea[k] for k in ("losses", "ref_losses", "step_ms",
                            "ref_step_ms", "peak_gib", "scatter_bytes",
                            "gather_bytes", "scatter_want", "gather_want",
                            "capacity", "expert_axis")},
        rel=rel, param_max=max(ea["param_gap"][0], eb["param_gap"][0]),
        gate_max=max(ea["gate_gap"][0], eb["gate_gap"][0]),
        rank1_step_ms=eb["step_ms"], rank1_peak_gib=eb["peak_gib"])
    log(f"# phases 42-43: {secs:.1f} s (two processes, spawn, build and "
        "run)")
    return out


# -- phases 44-45: ZeRO-3, the quantized wires and gradient merge ------------

# phase 44: GPT-3 1.3B's widths at ZERO3_LAYERS layers, phase 7's batch
# and AdamW, sharding 2 at stage 3 (phase 46a holds ZeRO-3 at larger
# widths); phase 45: its widths at depth 2 under the gradient wire (dp 2)
# and the mp wire (mp 2), and gradient merge over k micro-batches
ZERO3_DEGREE = 2
ZERO3_LAYERS = 8
WIRE_LAYERS = 2
# the trajectories against the exact exchange, as the reference's tests
# bound them: the bf16 gradient wire within 5e-3 of the f32 exchange
# (tests/test_grad_comm.py :304), the int8 + error-feedback one converging
# (:311: one absmax scale a bucket sends a gradient below 1/254 of the
# bucket's largest as 0, which Adam's normalised step then does not move
# until the residual carries it), the int8 mp wire within 5e-2 of the wire
# off (tests/test_mp_comm.py :346)
GRAD_WIRE_ATOL = {"bf16": 5e-3, "int8_ef": None}
MP_WIRE_ATOL = 5e-2
# the gradient wires of phase 45 (name -> grad_comm_configs); f32 is the
# exact all-reduce they are held against
GRAD_WIRES = {"f32": None, "bf16": dict(wire_dtype="bf16"),
              "int8_ef": dict(wire_dtype="int8", error_feedback=True)}
# gradient merge: k micro-batches of one MERGE_SEQ-token row each
MERGE_K, MERGE_SEQ = 4, 1024


def wire_strategy(grad_wire=None, mp_wire=None, **degrees):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update({"dp_degree": -1, **degrees})
    if grad_wire:
        s.grad_comm = True
        s.grad_comm_configs.update(grad_wire)
    if mp_wire:
        s.mp_comm = True
        s.mp_comm_configs.update(wire_dtype=mp_wire)
    return s


def zero3_gather_want(model, n):
    """The bytes a rank receives by the forward's gathers of one step: the
    other ranks' part of every sliced parameter, the tied embedding twice
    (the embedding and the LM head each gather it)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        sharding_stage3 as z3)

    part = {n_: p.numel() * p.element_size() * (n - 1)
            for n_, p in model.named_parameters() if z3.is_zero3_slice(p)}
    tied = part.get("gpt.embeddings.word_embeddings.weight", 0) \
        if model.config.tie_word_embeddings else 0
    return sum(part.values()) + tied


def mp_wire_want(cfg, b, t, n, steps):
    """The int8 mp wire's bytes a rank sends over ``steps`` steps: each
    summed activation ``[b, t, hidden]`` once to the n - 1 others with an
    f32 scale a row. A step sums the embedding's lookup and, per layer,
    the two row-parallel outputs in the forward, and per layer the two
    column-parallel inputs' gradients and the tied head's input gradient
    in the backward."""
    sites = 1 + 2 * cfg.num_hidden_layers + 2 * cfg.num_hidden_layers + 1
    per = (n - 1) * (b * t * cfg.hidden_size + b * t * 4)
    return sites * per * steps


def _rank_zero3_wires(out_dir, trained_losses, spec):
    """One rank of phases 44-45 (run by ``paddle.distributed.spawn``), its
    results pickled to ``out_dir``. 44: GPT-3 1.3B's widths at
    ZERO3_LAYERS layers through ``DistTrainStep`` at sharding 2, stage 3,
    then (rank 0) a single-process ``TrainStep`` on the same weights and
    batch. 45: the
    depth-2 model at dp 2 under each gradient wire of GRAD_WIRES, then at
    mp 2 with the mp wire off and int8. ``spec``: the device, and for a
    rehearsal a tiny ``GPTConfig`` dict, a sequence length and a
    ``prepare`` function the child runs first."""
    import os
    import pickle

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.framework.io_state import gather_full_state
    from paddle_tpu_torch.ops import flash_attention as fa

    device = spec["device"]
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if spec.get("prepare"):
        spec["prepare"]()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0

    def reset_peak():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def build(layers):
        if spec.get("model") is None:
            return build_model(layers)
        from paddle_tpu_torch.text.models.gpt import (GPTConfig,
                                                      GPTForCausalLM)

        return GPTForCausalLM(GPTConfig(**dict(
            spec["model"], num_hidden_layers=layers)), device=device,
            seed=SEED)

    def launches():
        return {k: getattr(fa, f"launches_{k}") for k in ("fwd", "dq", "dkv")}

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    out = {"backend": dist.get_backend()}

    # -- 44: GPT-3 1.3B at ZeRO-3 over sharding 2
    layers = spec.get("layers", ZERO3_LAYERS)
    s = wire_strategy(sharding_degree=ZERO3_DEGREE)
    s.sharding_configs["stage"] = 3
    fleet.init(is_collective=True, strategy=s)
    model = build(layers)
    total_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    step, opt = dist_trainer(model)
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    gather_want = zero3_gather_want(model, ZERO3_DEGREE)
    ids, labels = train_batch(model.config.vocab_size)
    reset_peak()
    reset_flash(fa)
    collective.reset_counts()
    losses, step_ms = timed_steps(step, (ids, labels), LOCKSTEP_STEPS, sync)
    c = collective.counts
    full = gather_full_state(model)
    out["zero3"] = dict(
        losses=losses, step_ms=step_ms, peak_gib=peak_gib(),
        launches=launches(), layers=layers,
        model_bytes=total_bytes, held_bytes=held,
        gather_bytes=c.get("zero3_gather_bytes", 0) // LOCKSTEP_STEPS,
        regather_bytes=c.get("zero3_regather_bytes", 0) // LOCKSTEP_STEPS,
        reduce_scatter_bytes=c.get("zero3_reduce_scatter_bytes", 0)
        // LOCKSTEP_STEPS,
        gather_want=gather_want,
        moments=sum(v.numel() * v.element_size()
                    for st in opt._inner_opt._accumulators if st
                    for v in st.values()))
    del step, opt, model
    fleet.topology.set_hybrid_communicate_group(None)
    reset_peak()
    if rank == 0:
        ref = build(layers)
        ref_step, ref_opt = trainer(ref)
        # at 24 layers the single-process losses are phase 7's
        out["zero3"]["ref_losses"], out["zero3"]["ref_step_ms"] = \
            timed_steps(ref_step, (ids, labels), LOCKSTEP_STEPS, sync)
        if layers == 24:
            out["zero3"]["ref_losses"] = list(
                trained_losses[:LOCKSTEP_STEPS])
        out["zero3"]["param_gap"] = param_gap(
            full, {n: p.detach() for n, p in ref.named_parameters()})
        del ref_step, ref_opt, ref
    del full
    reset_peak()
    dist.barrier()

    # -- 45a: the gradient wire at dp 2
    wires = {}
    for name, cfg in GRAD_WIRES.items():
        fleet.init(is_collective=True, strategy=wire_strategy(
            grad_wire=cfg, dp_degree=2))
        model = build(WIRE_LAYERS)
        step, opt = dist_trainer(model)
        reset_flash(fa)
        collective.reset_counts()
        w_losses, w_ms = timed_steps(step, (ids, labels), LOCKSTEP_STEPS,
                                     sync)
        wire = opt._grad_wire()
        wires[name] = dict(
            losses=w_losses, step_ms=w_ms, launches=launches(),
            wire_bytes=collective.counts.get("grad_wire_bytes", 0),
            f32_bytes=collective.counts.get("grad_wire_f32_bytes", 0),
            want=None if wire is None else dict(
                bytes_wire=wire.bytes_wire, bytes_f32=wire.bytes_f32,
                buckets=len(wire.zero_layouts) + len(wire.tail_layouts),
                n_elems=wire.n_elems),
            n_params=sum(p.numel() for p in model.parameters()),
            residuals=sum(k.startswith("grad_comm.")
                          for k in opt.state_dict()))
        del step, opt, model
        fleet.topology.set_hybrid_communicate_group(None)
        reset_peak()
    out["grad_wire"] = wires

    # -- 45b: the mp wire at mp 2
    mp = {}
    for name, wire in (("off", None), ("int8", "int8")):
        fleet.init(is_collective=True, strategy=wire_strategy(
            mp_wire=wire, mp_degree=2))
        model = build(WIRE_LAYERS)
        step, _ = dist_trainer(model)
        reset_flash(fa)
        collective.reset_counts()
        m_losses, m_ms = timed_steps(step, (ids, labels), LOCKSTEP_STEPS,
                                     sync)
        mp[name] = dict(
            losses=m_losses, step_ms=m_ms, launches=launches(),
            wire_bytes=collective.counts.get("mp_wire_bytes", 0),
            f32_bytes=collective.counts.get("mp_wire_f32_bytes", 0),
            want=mp_wire_want(model.config, ids.shape[0], ids.shape[1], 2,
                              LOCKSTEP_STEPS))
        del step, model
        fleet.topology.set_hybrid_communicate_group(None)
        reset_peak()
    out["mp_wire"] = mp
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_gradient_merge(fa, smi, build=None):
    """Phase 45c: gradient merge (``GradientMergeOptimizer``, k = MERGE_K)
    over MERGE_K one-row micro-batches against ``TrainStep`` on the whole
    batch, LOCKSTEP_STEPS updates at GPT-3 1.3B's widths and depth
    WIRE_LAYERS: each cycle's mean micro-batch loss against the whole
    batch's loss within TRAIN_LOSS_RTOL, the parameters by phase 8's rule,
    the parameters still between boundaries."""
    from paddle_tpu_torch.distributed.fleet import GradientMergeOptimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    build = build or (lambda: build_model(WIRE_LAYERS))
    model = build()
    vocab = model.config.vocab_size
    rng = np.random.default_rng(SEED + 45)
    tok = torch.as_tensor(rng.integers(0, vocab, (MERGE_K, MERGE_SEQ + 1)),
                          device=DEVICE)
    ids, labels = tok[:, :-1].contiguous(), tok[:, 1:].contiguous()
    opt = GradientMergeOptimizer(
        AdamW(parameters=model.parameters(),
              grad_clip=ClipGradByGlobalNorm(1.0), **ADAMW),
        k_steps=MERGE_K)
    step = TrainStep(model, lambda m, i, lab: m(i, labels=lab), opt)
    reset_flash(fa)
    losses, still = [], True
    t0 = time.perf_counter()
    for _ in range(LOCKSTEP_STEPS):
        micro = []
        for j in range(MERGE_K):
            before = model.gpt.decoder[0].mlp.fc_in.weight.detach().clone()
            micro.append(float(step(ids[j:j + 1], labels[j:j + 1])))
            if j < MERGE_K - 1:
                still &= torch.equal(
                    before, model.gpt.decoder[0].mlp.fc_in.weight.detach())
        losses.append(sum(micro) / MERGE_K)
    secs = time.perf_counter() - t0
    merged_launches = {k: getattr(fa, f"launches_{k}")
                       for k in ("fwd", "dq", "dkv")}
    ref = build()
    ref_step, _ = trainer(ref)
    ref_losses = [float(ref_step(ids, labels))
                  for _ in range(LOCKSTEP_STEPS)]
    gap = param_gap({n: p.detach() for n, p in model.named_parameters()},
                    {n: p.detach() for n, p in ref.named_parameters()})
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    log(f"# phase 45c: gradient merge k={MERGE_K} over [1, {MERGE_SEQ}] "
        f"micro-batches, depth {WIRE_LAYERS}: mean micro-batch losses "
        f"{losses} vs TrainStep on the [{MERGE_K}, {MERGE_SEQ}] batch "
        f"{ref_losses} (rel {rel:.2e}); params max |d| {gap[0]:.2e}, "
        f"{gap[1]}/{gap[2]} beyond {LOCKSTEP_PARAM_ATOL}; parameters held "
        f"between boundaries {still}; launches {merged_launches}; "
        f"{secs:.1f} s  [{smi}]")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("phase 45c: merged losses differ from the "
                             "whole batch's")
    check_param_gap(gap, LOCKSTEP_STEPS, "phase 45c")
    if not still:
        raise AssertionError("phase 45c: parameters moved within a cycle")
    n = WIRE_LAYERS * MERGE_K * LOCKSTEP_STEPS
    if any(v != n for v in merged_launches.values()):
        raise AssertionError(f"phase 45c: launches {merged_launches} != {n}")
    del step, opt, model, ref_step, ref
    return dict(losses=losses, ref_losses=ref_losses, rel=rel,
                param_max=gap[0], param_far=gap[1], launches=merged_launches,
                seconds=secs)


def phases_zero3_wires(fa, smi, trained, timeout=900, spec=None):
    """Phases 44-45. Phase 44: GPT-3 1.3B's widths at ZERO3_LAYERS layers
    at ZeRO-3 over sharding 2, two processes on the one card over gloo,
    against a single-process ``TrainStep`` on the same weights and batch
    (rank 0): losses within TRAIN_LOSS_RTOL, parameters by phase 8's rule;
    each rank's K1 / K2a / K2b launches (layers x LOCKSTEP_STEPS), the
    bytes its forward gathers
    (the other rank's half of every sliced parameter, the tied embedding
    twice) and reduce-scatters a step, the parameter bytes it holds.
    Phase 45: the depth-2 model at dp 2 with the bf16 and the int8 +
    error-feedback gradient wire against the f32 exchange, at mp 2 with
    the int8 mp wire against the wire off (each within the tier-1
    tolerance; the bytes each rank sends against the arithmetic), and
    gradient merge (phase 45c, one process; ``spec["merge"]`` builds its
    model in a rehearsal). Returns the ``zero3_wires`` JSON line's
    numbers."""
    import os
    import pickle
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.parallel import join_spawned

    spec = spec or {"device": DEVICE}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zero3_")
    t0 = time.perf_counter()
    child = {k: v for k, v in spec.items() if k != "merge"}
    ctx = dist.spawn(_rank_zero3_wires, (tmp, trained["losses"], child),
                     nprocs=2, join=False, backend="gloo",
                     master=f"file://{tmp}/rendezvous")
    join_spawned(ctx, timeout)
    secs = time.perf_counter() - t0
    res = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    a, b = res
    out = {"seconds": secs, "backend": a["backend"], "card": smi}

    # 44
    za, zb = a["zero3"], b["zero3"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(za["losses"],
                                                  za["ref_losses"]))
    n_steps, layers = LOCKSTEP_STEPS, za["layers"]
    log(f"# phase 44: GPT-3 1.3B ({layers} layers) at ZeRO-3 over sharding "
        f"{ZERO3_DEGREE}, {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
        f"{za['losses']} vs TrainStep {za['ref_losses']} (rel "
        f"{rel:.2e}); params vs TrainStep max |d| {za['param_gap'][0]:.2e}, "
        f"{za['param_gap'][1]}/{za['param_gap'][2]} beyond "
        f"{LOCKSTEP_PARAM_ATOL}; step ms rank 0 "
        f"{[round(t, 1) for t in za['step_ms']]} rank 1 "
        f"{[round(t, 1) for t in zb['step_ms']]} (TrainStep "
        f"{[round(t, 1) for t in za['ref_step_ms']]}); peak "
        f"{za['peak_gib']:.2f} / {zb['peak_gib']:.2f} GiB; launches rank 0 "
        f"{za['launches']} rank 1 {zb['launches']}; a step gathers "
        f"{za['gather_bytes']} B (want {za['gather_want']}), gathers again "
        f"{za['regather_bytes']} B in the backward, reduce-scatters "
        f"{za['reduce_scatter_bytes']} B; parameters held "
        f"{za['held_bytes']} / {zb['held_bytes']} B of {za['model_bytes']}, "
        f"moments {za['moments']} B  [{smi}]")
    if za["losses"] != zb["losses"]:
        raise AssertionError("phase 44: the ranks' losses differ")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("phase 44: losses differ from TrainStep's")
    check_param_gap(za["param_gap"], n_steps, "phase 44")
    for z in (za, zb):
        if any(v != layers * n_steps for v in z["launches"].values()):
            raise AssertionError(f"phase 44: launches {z['launches']} != "
                                 f"{layers} x {n_steps}")
        if z["gather_bytes"] != z["gather_want"] or \
                z["reduce_scatter_bytes"] != z["gather_bytes"]:
            raise AssertionError("phase 44: gathered / reduce-scattered "
                                 "bytes differ from the arithmetic")
        if not z["held_bytes"] < 0.6 * z["model_bytes"]:
            raise AssertionError("phase 44: a rank holds more than its "
                                 "slices")
    out["zero3_1p3b"] = dict(
        {k: za[k] for k in ("losses", "ref_losses", "step_ms",
                            "ref_step_ms", "peak_gib", "launches",
                            "gather_bytes", "regather_bytes",
                            "reduce_scatter_bytes", "held_bytes",
                            "model_bytes", "moments")},
        rel=rel, param_max=za["param_gap"][0], param_far=za["param_gap"][1],
        rank1_step_ms=zb["step_ms"], rank1_peak_gib=zb["peak_gib"],
        rank1_launches=zb["launches"])

    # 45a
    base = a["grad_wire"]["f32"]
    gw = {}
    for name, w in a["grad_wire"].items():
        wb = b["grad_wire"][name]
        err = max(abs(x - y) for x, y in zip(w["losses"], base["losses"]))
        tol = GRAD_WIRE_ATOL.get(name, 0.0)
        log(f"# phase 45a: depth {WIRE_LAYERS} at dp 2, {name} gradient "
            f"wire: losses {w['losses']} (f32 exchange {base['losses']}, "
            f"max |d| {err:.2e}, "
            f"{'converging' if tol is None else f'tol {tol}'}); step ms "
            f"{[round(t, 1) for t in w['step_ms']]}; wire bytes "
            f"{w['wire_bytes']} (f32 {w['f32_bytes']}; plan {w['want']}); "
            f"residual buffers in state_dict {w['residuals']}; launches "
            f"{w['launches']}  [{smi}]")
        if w["losses"] != wb["losses"]:
            raise AssertionError(f"phase 45a {name}: the ranks differ")
        if not (w["losses"][-1] < w["losses"][0] if tol is None
                else err <= tol):
            raise AssertionError(f"phase 45a {name}: losses differ from "
                                 "the f32 exchange")
        for r in (w, wb):
            if any(v != WIRE_LAYERS * n_steps
                   for v in r["launches"].values()):
                raise AssertionError(f"phase 45a {name}: launches")
        if name != "f32":
            want, n = w["want"], w["n_params"]
            per = 2 * n if name == "bf16" else n + 4 * want["buckets"]
            if not (want["bytes_wire"] == per and want["n_elems"] == n
                    and w["wire_bytes"] == per * n_steps
                    and w["f32_bytes"] == 4 * n * n_steps
                    and w["wire_bytes"] < w["f32_bytes"]):
                raise AssertionError(f"phase 45a {name}: wire bytes differ "
                                     "from the arithmetic")
            if name == "int8_ef" and w["residuals"] != want["buckets"]:
                raise AssertionError("phase 45a: residuals not in the "
                                     "optimizer state")
        gw[name] = dict({k: w[k] for k in ("losses", "step_ms", "launches",
                                           "wire_bytes", "f32_bytes")},
                        max_abs_loss_d=err, rank1_launches=wb["launches"])
    out["grad_wire_dp2"] = gw

    # 45b
    off, q = a["mp_wire"]["off"], a["mp_wire"]["int8"]
    err = max(abs(x - y) for x, y in zip(q["losses"], off["losses"]))
    log(f"# phase 45b: depth {WIRE_LAYERS} at mp 2, int8 mp wire: losses "
        f"{q['losses']} (wire off {off['losses']}, max |d| {err:.2e}, tol "
        f"{MP_WIRE_ATOL}); step ms {[round(t, 1) for t in q['step_ms']]} "
        f"(off {[round(t, 1) for t in off['step_ms']]}); wire bytes "
        f"{q['wire_bytes']} (arithmetic {q['want']}; the f32 all-reduces "
        f"{q['f32_bytes']}); launches {q['launches']}  [{smi}]")
    for name in ("off", "int8"):
        if a["mp_wire"][name]["losses"] != b["mp_wire"][name]["losses"]:
            raise AssertionError(f"phase 45b {name}: the ranks differ")
    if not err <= MP_WIRE_ATOL or not q["losses"][-1] < q["losses"][0]:
        raise AssertionError("phase 45b: int8 losses differ from the wire "
                             "off")
    if q["wire_bytes"] != q["want"] or \
            not q["wire_bytes"] <= 0.6 * q["f32_bytes"] or off["wire_bytes"]:
        raise AssertionError("phase 45b: mp wire bytes differ from the "
                             "arithmetic")
    for r in (a, b):
        for name in ("off", "int8"):
            if any(v != WIRE_LAYERS * n_steps for v in
                   r["mp_wire"][name]["launches"].values()):
                raise AssertionError(f"phase 45b {name}: launches")
    out["mp_wire_mp2"] = dict(
        {k: q[k] for k in ("losses", "step_ms", "launches", "wire_bytes",
                           "f32_bytes")},
        off_losses=off["losses"], off_step_ms=off["step_ms"],
        max_abs_loss_d=err, rank1_launches=b["mp_wire"]["int8"]["launches"])
    log(f"# phases 44-45b: {secs:.1f} s (two processes, spawn, build and "
        "run)")
    if spec["device"] == "cuda":
        torch.cuda.empty_cache()
    out["gradient_merge"] = phase_gradient_merge(fa, smi, spec.get("merge"))
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 46: ZeRO-3 and the sep axis inside the pipeline -------------------

# GPT-3 6.7B's widths (BASELINE.json's fifth configuration, the reference's
# bench_configs.py::run_gpt_6p7b_ppsharding) at depth 2 (4 until phase 56
# needed the room), one layer a stage, phase 7's AdamW, on four gloo ranks
# sharing the one card: 46a pp 2 x sharding 2 at stage 3 in f32, 46b the
# same with the reference's knobs (bf16 parameters, block recompute), 46c
# pp 2 x sep 2 in f32, and 46c again with the ring's plain version
# (``ring_flash_attention_plain``: f32 einsums, no kernel) on the same
# weights, which tells the kernels' 3xTF32 products from the rest in 46c's
# distance to the baseline (ROADMAP.md §C, "Suspects"). The batch,
# COMPOSE_BATCH x TRAIN_SEQ, gives every rank 2 micro-batches under 1F1B:
# the sharding axis splits the rows (1 a micro-batch), sep the sequence (2
# rows of TRAIN_SEQ / 2 a micro-batch)
COMPOSE_LAYERS = 2
COMPOSE_BATCH = 4
COMPOSE_MICROBATCHES = 2
COMPOSE_RANKS = 4
COMPOSE_CONFIGS = {
    "pp2_zero3": dict(sharding_degree=2, stage=3, steps=LOCKSTEP_STEPS),
    "pp2_zero3_bf16_recompute": dict(sharding_degree=2, stage=3, steps=2,
                                     bf16=True, recompute=True),
    "pp2_sep2": dict(sep_degree=2, steps=2),
    "pp2_sep2_plain_ring": dict(sep_degree=2, steps=2, plain_ring=True),
}
#: the phase tag of each configuration
COMPOSE_TAGS = {"pp2_zero3": "46a", "pp2_zero3_bf16_recompute": "46b",
                "pp2_sep2": "46c", "pp2_sep2_plain_ring": "46c plain ring"}


@contextlib.contextmanager
def plain_ring():
    """The sequence split's ring through its plain version
    (``ring_flash_attention_plain``) in place of the kernels' route: the
    probe of phase 46c."""
    from paddle_tpu_torch.nn.functional import ring_attention as ra

    saved = ra.ring_flash_attention
    ra.ring_flash_attention = (
        lambda q, k, v, group, causal=False, scale=None, mask=None:
        ra.ring_flash_attention_plain(q, k, v, group, causal, scale, mask))
    try:
        yield
    finally:
        ra.ring_flash_attention = saved


def build_6p7b(spec, **kw):
    """GPT-3 6.7B's widths (vocab 50304, dropout 0) at COMPOSE_LAYERS, or
    ``spec["model"]``'s config in a rehearsal, on ``spec``'s device, its
    weights from SEED."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    if spec.get("model") is None:
        cfg = GPTConfig.gpt3_6p7b(
            vocab_size=50304, num_hidden_layers=COMPOSE_LAYERS,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, **kw)
    else:
        cfg = GPTConfig(**dict(spec["model"],
                               num_hidden_layers=COMPOSE_LAYERS, **kw))
    return GPTForCausalLM(cfg, device=spec["device"], seed=SEED)


def compose_batch(vocab):
    """Next-token batch [COMPOSE_BATCH, TRAIN_SEQ] of ids and labels, made
    with numpy."""
    rng = np.random.default_rng(SEED + 46)
    tok = rng.integers(0, vocab, (COMPOSE_BATCH, TRAIN_SEQ + 1))
    tok = torch.as_tensor(tok, device=DEVICE)
    return tok[:, :-1].contiguous(), tok[:, 1:].contiguous()


def pp_zero3_want(slices, stage, stages, m, steps, recompute):
    """The ZeRO-3 bytes a rank of a pipelined GPT under 1F1B moves in
    ``steps`` steps of ``m`` micro-batches, from ``slices`` (``{name:
    bytes one gather of that slice brings from the other ranks}``).
    Every forward op gathers its blocks and the embeddings (the layers
    before the stack run on every stage); the last stage's also the final
    norm and the tied head (the word embedding again). The backward
    reduce-scatters what reaches the loss (the embeddings on the first
    stage only) and gathers again each weight an op saved (the linear
    weights, the norms' weights and biases, the tied head), or every
    block parameter when the blocks recompute."""
    blocks = sum(b for n, b in slices.items() if ".decoder." in n)
    saved = blocks if recompute else sum(
        b for n, b in slices.items() if ".decoder." in n
        and not (n.endswith(".bias") and ".ln_" not in n))
    emb = sum(b for n, b in slices.items() if ".embeddings." in n)
    head = sum(b for n, b in slices.items() if "final_layernorm" in n) \
        + slices["gpt.embeddings.word_embeddings.weight"]
    first, last = stage == 0, stage == stages - 1
    return dict(gather=steps * m * (blocks + emb + last * head),
                reduce_scatter=steps * m * (blocks + first * emb
                                            + last * head),
                regather=steps * m * (saved + last * head))


def pp_staged_want(r, steps):
    """The bytes a rank of a pp-2 GPT stages through pinned host memory in
    ``steps`` steps: per micro-batch its chunk boundary's activation and
    cotangent (in the parameters' dtype), and at sep > 1 its layers' f32
    ring rotations (``staged_per_step``)."""
    mb, tl, h, d = r["rows"], r["tokens"], r["heads"], r["head_dim"]
    boundary = 2 * _boundary_messages(2, 1, r["stage"]) * mb * tl * h * d \
        * r["elem"]
    ring = (staged_per_step(r["layers_local"], r["sep"], mb, tl, h, d)
            if r["sep"] > 1 else 0)
    return steps * r["microbatches"] * (boundary + ring)


def _rank_pp_compose(out_dir, base_path, spec):
    """One rank of phase 46 (run by ``paddle.distributed.spawn``): each
    configuration of COMPOSE_CONFIGS in turn at pp 2 through ``fleet.init``
    -> ``distributed_model`` -> ``distributed_optimizer`` ->
    ``DistTrainStep``, its results pickled to ``out_dir``; after 46a the
    full state gathered and (rank 0) held against the baseline's final
    parameters at ``base_path``. ``spec``: the device, and for a
    rehearsal a tiny ``GPTConfig`` dict and a ``prepare`` function the
    child runs first."""
    import os
    import pickle

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        pipeline_parallel as pp)
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding_stage3 \
        import zero3_spec
    from paddle_tpu_torch.framework.io_state import gather_full_state
    from paddle_tpu_torch.ops import flash_attention as fa

    device = spec["device"]
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if spec.get("prepare"):
        spec["prepare"]()
    # four ranks' peaks come to ~64 GiB of the card: segments that grow
    # leave no reserved-but-free blocks behind a configuration (read at
    # the process's first CUDA allocation, which comes after this)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")

    def reset_peak():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    out = {"backend": dist.get_backend()}
    for name, c in COMPOSE_CONFIGS.items():
        s = wire_strategy(pp_degree=2, **{k: c[k] for k in (
            "sharding_degree", "sep_degree") if k in c})
        s.sharding_configs["stage"] = c.get("stage", 1)
        s.pipeline_configs.update(schedule="1f1b",
                                  accumulate_steps=COMPOSE_MICROBATCHES)
        fleet.init(is_collective=True, strategy=s)
        hcg = fleet.get_hybrid_communicate_group()
        model = build_6p7b(spec, use_recompute=c.get("recompute", False))
        if c.get("bf16"):
            model.bfloat16()
        pipe = model.gpt.decoder
        if not (isinstance(pipe, pp.SpmdPipeline) and pipe.pipelined):
            raise AssertionError(f"phase 46 {name}: the decoder is not "
                                 "pipelined")
        stage_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        step, opt = dist_trainer(model)
        params = dict(model.named_parameters())
        slices = {n: p.numel() * p.element_size()
                  * (zero3_spec(p).group.nranks - 1)
                  for n, p in params.items() if zero3_spec(p)}
        ids, labels = compose_batch(model.config.vocab_size)
        reset_peak()
        reset_flash(fa)
        collective.reset_counts()
        pp.reset_counts()
        steps = c["steps"]
        with (plain_ring() if c.get("plain_ring")
              else contextlib.nullcontext()):
            losses, step_ms = timed_steps(step, (ids, labels), steps, sync)
        cfg = model.config
        sep = hcg.get_sep_parallel_world_size()
        res = dict(
            losses=losses, step_ms=step_ms, launches=flash_counts(fa),
            peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                      if on_card else 0.0),
            stage=hcg.get_stage_id(), sep=sep,
            sep_rank=hcg.get_sep_parallel_rank(),
            layers_local=len(pipe.blocks),
            microbatches=pp.counts["forward_ops"] // steps,
            rows=ids.shape[0] // hcg.get_data_sharding_parallel_world_size()
            // (pp.counts["forward_ops"] // steps),
            tokens=ids.shape[1] // sep, heads=cfg.num_attention_heads,
            elem=next(model.parameters()).element_size(),
            head_dim=cfg.hidden_size // cfg.num_attention_heads,
            counts={k: collective.counts.get(k, 0) for k in (
                "zero3_gather_bytes", "zero3_regather_bytes",
                "zero3_reduce_scatter_bytes", "p2p_staged_bytes")},
            slices=slices, stage_bytes=stage_bytes,
            held_bytes=sum(p.numel() * p.element_size()
                           for p in params.values()),
            held_params=sum(p.numel() for p in params.values()),
            whole_bytes=sum(p.numel() * p.element_size()
                            for p in params.values() if not zero3_spec(p)),
            moments=sum(v.numel() * v.element_size()
                        for st in opt._inner_opt._accumulators if st
                        for v in st.values()))
        order = list(pipe._layer_order)
        del step, opt, pipe, params
        if name == "pp2_zero3":
            full = gather_full_state(model)
            del model
            reset_peak()
            if rank == 0:
                want = torch.load(base_path, mmap=True)
                res["param_gap"] = param_gap(unstacked(full, order), want)
                del want
            del full
        else:
            del model
        fleet.topology.set_hybrid_communicate_group(None)
        reset_peak()
        out[name] = res
        dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def compose_baseline(spec, path):
    """Phase 46's single-process ``TrainStep`` on the same weights, depth
    and batch, LOCKSTEP_STEPS steps: its losses, step ms and peak; its
    final parameters saved to ``path`` (host memory), its device memory
    freed before the ranks start."""
    on_card = spec["device"] == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    model = build_6p7b(spec)
    step, opt = trainer(model)
    ids, labels = compose_batch(model.config.vocab_size)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms = timed_steps(step, (ids, labels), LOCKSTEP_STEPS, sync)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               path)
    n_params = sum(p.numel() for p in model.parameters())
    del step, opt, model
    if on_card:
        torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=step_ms, peak_gib=peak,
                n_params=n_params)


def phase_pp_compose(smi, timeout=900, spec=None):
    """Phase 46: ZeRO-3 and the sep axis inside the pipeline, GPT-3 6.7B's
    widths at depth COMPOSE_LAYERS, four processes on the one card over
    gloo. First a
    single-process ``TrainStep`` (the baseline, its memory freed); then
    46a pp 2 x sharding 2 at stage 3 in f32 (losses equal on the ranks and
    within TRAIN_LOSS_RTOL of the baseline, the gathered parameters by
    phase 8's rule, K1 / K2a / K2b = local layers x micro-batches x steps,
    the ZeRO-3 bytes gathered, gathered again and reduce-scattered and the
    staged bytes equal to the arithmetic, a rank holding half its stage's
    sliced parameters), 46b with bf16 parameters and block recompute (the
    loss finite and falling, K1 twice a layer, the bytes with one more
    gather of every block parameter), 46c pp 2 x sep 2 in f32 (losses
    within TRAIN_LOSS_RTOL of the baseline, sep rank r launching r + 1
    ring blocks a layer, the staged bytes equal to the boundaries and the
    ring's rotations), and 46c with the plain ring (losses within
    TRAIN_LOSS_RTOL of the baseline, no kernel launch; both distances
    printed side by side). Returns the ``pp_compose`` JSON line's
    numbers."""
    import gc
    import os
    import pickle
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.parallel import join_spawned

    spec = spec or {"device": DEVICE}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pp_compose_")
    t0 = time.perf_counter()
    # the four ranks need the card: earlier phases' tensors held by
    # reference cycles go first
    gc.collect()
    if spec["device"] == "cuda":
        torch.cuda.empty_cache()
    base_path = os.path.join(tmp, "baseline.pt")
    base = compose_baseline(spec, base_path)
    gc.collect()
    if spec["device"] == "cuda":
        torch.cuda.empty_cache()
    t_base = time.perf_counter() - t0
    held = (torch.cuda.memory_allocated() / 2 ** 30
            if spec["device"] == "cuda" else 0.0)
    log(f"# phase 46: the parent holds {held:.2f} GiB on the card while the "
        "ranks run")
    log(f"# phase 46: baseline TrainStep, GPT-3 6.7B widths at depth "
        f"{COMPOSE_LAYERS} ({base['n_params']} parameters), "
        f"{COMPOSE_BATCH} x {TRAIN_SEQ}: losses {base['losses']}, step ms "
        f"{[round(t, 1) for t in base['step_ms']]}, peak "
        f"{base['peak_gib']:.2f} GiB; {t_base:.1f} s  [{smi}]")
    ctx = dist.spawn(_rank_pp_compose, (tmp, base_path, spec),
                     nprocs=COMPOSE_RANKS, join=False, backend="gloo",
                     master=f"file://{tmp}/rendezvous")
    join_spawned(ctx, timeout)
    res = []
    for r in range(COMPOSE_RANKS):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t0
    out = {"seconds": secs, "backend": res[0]["backend"], "card": smi,
           "baseline": base, "parent_gib": held}
    for name, c in COMPOSE_CONFIGS.items():
        rs = [r[name] for r in res]
        a, steps = rs[0], c["steps"]
        tag = COMPOSE_TAGS[name]
        if any(r["losses"] != a["losses"] for r in rs):
            raise AssertionError(f"phase {tag}: the ranks' losses differ")
        rel = None
        if not c.get("bf16"):
            rel = max(abs(x - y) / abs(y) for x, y in zip(
                a["losses"], base["losses"]))
        log(f"# phase {tag}: pp 2 x "
            f"{'sep 2' if c.get('sep_degree') else 'sharding 2 at stage 3'}"
            f"{', bf16 parameters, recompute' if c.get('bf16') else ''}, "
            f"GPT-3 6.7B widths at depth {COMPOSE_LAYERS}, "
            f"{COMPOSE_MICROBATCHES} micro-batches, 1F1B: losses "
            f"{a['losses']}"
            + ("" if rel is None else
               f" vs the baseline {base['losses'][:steps]} (rel {rel:.2e})")
            + (f"; params max |d| {a['param_gap'][0]:.2e}, "
               f"{a['param_gap'][1]}/{a['param_gap'][2]} beyond "
               f"{LOCKSTEP_PARAM_ATOL}" if "param_gap" in a else "")
            + f"  [{smi}]")
        for i, r in enumerate(rs):
            log(f"#   rank {i} (stage {r['stage']}, sep rank "
                f"{r['sep_rank']}): step ms "
                f"{[round(t, 1) for t in r['step_ms']]}; peak "
                f"{r['peak_gib']:.2f} GiB; launches {r['launches']}; "
                f"bytes {r['counts']}; parameters held {r['held_params']} "
                f"({r['held_bytes']} B of its stage's {r['stage_bytes']}), "
                f"moments {r['moments']} B")
        if rel is not None and not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"phase {tag}: losses differ from the "
                                 "baseline's")
        if c.get("bf16") and not (all(np.isfinite(a["losses"]))
                                  and a["losses"][-1] < a["losses"][0]):
            raise AssertionError(f"phase {tag}: the loss is not finite and "
                                 "falling")
        if "param_gap" in a:
            check_param_gap(a["param_gap"], steps, f"phase {tag}")
        for r in rs:
            n = r["layers_local"] * r["microbatches"] * steps
            blocks = r["sep_rank"] + 1 if r["sep"] > 1 else 1
            if c.get("plain_ring"):
                blocks = 0  # no kernel runs; the ring's staging differs
            bf = "_bf16" if c.get("bf16") else ""
            want = {f"fwd{bf}": n * blocks * (2 if c.get("recompute")
                                              else 1),
                    f"dq{bf}": n * blocks, f"dkv{bf}": n * blocks}
            if r["microbatches"] != COMPOSE_MICROBATCHES or any(
                    r["launches"][k] != v for k, v in want.items()):
                raise AssertionError(f"phase {tag}: launches "
                                     f"{r['launches']} != {want}")
            staged = pp_staged_want(r, steps)
            # CPU tensors are not staged (a rehearsal may count them)
            if (spec["device"] == "cuda" or spec.get("staged")) and \
                    not c.get("plain_ring") and \
                    r["counts"]["p2p_staged_bytes"] != staged:
                raise AssertionError(
                    f"phase {tag}: staged {r['counts']['p2p_staged_bytes']}"
                    f" B != {staged} B")
            if c.get("stage") == 3:
                z = pp_zero3_want(r["slices"], r["stage"], 2,
                                  r["microbatches"], steps,
                                  c.get("recompute", False))
                got = {"gather": r["counts"]["zero3_gather_bytes"],
                       "regather": r["counts"]["zero3_regather_bytes"],
                       "reduce_scatter":
                           r["counts"]["zero3_reduce_scatter_bytes"]}
                if got != z:
                    raise AssertionError(f"phase {tag}: ZeRO-3 bytes {got} "
                                         f"!= {z}")
                sliced = r["stage_bytes"] - r["whole_bytes"]
                if r["held_bytes"] != sliced // 2 + r["whole_bytes"]:
                    raise AssertionError(f"phase {tag}: a rank holds more "
                                         "than its slices")
        out[name] = dict(
            {k: a[k] for k in ("losses", "step_ms", "peak_gib", "launches",
                               "counts", "held_params", "held_bytes",
                               "stage_bytes", "moments")},
            rel=rel, param_gap=a.get("param_gap"),
            ranks=[{k: r[k] for k in ("stage", "sep_rank", "step_ms",
                                      "peak_gib", "launches", "counts",
                                      "held_params")} for r in rs])
    peaks = [max(r[n]["peak_gib"] for n in COMPOSE_CONFIGS) for r in res]
    out["peak_gib_sum"] = sum(peaks)
    log(f"# phase 46c probe: loss rel to the single-process baseline, "
        f"kernel ring {out['pp2_sep2']['rel']:.2e}, plain ring "
        f"{out['pp2_sep2_plain_ring']['rel']:.2e} (same weights and batch)")
    log(f"# phase 46: {secs:.1f} s (baseline {t_base:.1f} s; four "
        f"processes, spawn, build and run); the ranks' peaks "
        f"{[round(p, 2) for p in peaks]} GiB, {sum(peaks):.2f} GiB together "
        f"beside four CUDA contexts")
    return out


# -- phase 47: §A.3's optimizers through fleet, and the packed route --------

# fleet's meta-optimizer configs: Lamb as BERT's large-batch recipe (You et
# al. 2020, the LAMB paper: decoupled weight decay 0.01), Lars as ResNet's
# (You et al. 2017: coefficient 0.001, weight decay 5e-4)
A3_LAMB = dict(lamb_weight_decay=0.01)
A3_LARS = dict(lars_coeff=0.001, lars_weight_decay=5e-4)
RESNET_LARS_STEPS = 3
# the card's first update against the port's plain CPU path on the card's
# parameters and gradients of that step, per tensor max|err| / max|CPU|:
# the same f32 operations, the norms summed in other orders
A3_UPDATE_RTOL = 1e-6
# phase 47c: each trust ratio's sums of squares on a rank (after the sum
# over the mp group) against the single-process run's for the whole
# parameter: f32 sums of up to 100 M terms in other orders, on gradients
# that differ by f32 noise; a shard's own sums would be about half
A3_SQ_RTOL = 1e-4
A3_GLOO_CONFIGS = {"mp2_lamb": dict(mp_degree=2, meta="lamb")}
# phase 47d: a packed batch of causal sequences (a packed SFT batch's
# spread of lengths) and a tail of padding tokens, at GPT-3 1.3B's
# attention widths
UNPADDED_SEGMENTS, UNPADDED_TAIL = (2048, 1024, 512, 384, 128), 64
UNPADDED_H, UNPADDED_D = 16, 128


@contextlib.contextmanager
def nccl_world1():
    """The default process group at world size 1 over NCCL (a ``file://``
    store, as phase 38), destroyed on leaving."""
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    tmp = tempfile.mkdtemp(prefix="chip_smoke_a3_")
    with launch_env(PADDLE_TRAINER_ID=0, PADDLE_TRAINERS_NUM=1,
                    PADDLE_MASTER=f"file://{tmp}/rendezvous"):
        dist.init_parallel_env()
    try:
        if dist.get_backend() != "NCCL":
            raise AssertionError(f"init_parallel_env chose "
                                 f"{dist.get_backend()}, not NCCL")
        yield
    finally:
        fleet.topology.set_hybrid_communicate_group(None)
        dist.destroy_process_group()


def record_sq_sums(opt, model):
    """Record, by parameter name, the sums of squares each trust ratio of
    ``opt`` reads (``Optimizer._sq_sums``: after the sum over a split
    parameter's group). Returns the dict and the function that stops the
    recording (it returns None)."""
    names = {id(p): n for n, p in model.named_parameters()}
    sums, real = {}, opt._sq_sums

    def recorded(*xs):
        out = real(*xs)
        sums.setdefault(names[id(opt._updating)], out.detach().cpu().tolist())
        return out

    opt._sq_sums = recorded
    return sums, lambda: opt.__dict__.pop("_sq_sums", None) and None


def capture_first_update(step):
    """Have ``step``'s first optimizer step keep host copies of the
    parameters before and after it and of their gradients (before the
    clip)."""
    opt = step._opt
    params = list(opt._inner_opt._parameter_list)
    got = {}

    def first():
        del opt.step  # the class's step from now on
        got["before"] = [p.detach().cpu().clone() for p in params]
        got["grads"] = [None if p.grad is None else p.grad.detach().cpu()
                        .clone() for p in params]
        opt.step()
        got["after"] = [p.detach().cpu().clone() for p in params]

    opt.step = first
    return got


def check_first_update(got, make_opt, meta, card_keys, what):
    """The card's first update against the port's plain CPU path: CPU
    parameters from the host copies with their gradients, the optimizer
    ``make_opt`` makes over them swapped by fleet's meta-optimizer
    ``meta``, one step. Raises past A3_UPDATE_RTOL or when the state keys
    differ; returns the worst relative difference and the optimizer's
    class name."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn.layer import Parameter

    params = [Parameter(b.clone()) for b in got["before"]]
    for p, g in zip(params, got["grads"]):
        p.grad = g
    opt = fleet._apply_meta_optimizers(make_opt(params), meta_strategy(meta))
    t0 = time.perf_counter()
    opt.step()
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for p, card in zip(params, got["after"]):
        want = p.detach()
        err = (card - want).abs().max().item()
        worst = max(worst, err / max(want.abs().max().item(), 1e-30))
    keys = sorted(opt.state_dict())
    log(f"# {what}: first update, card vs the CPU {type(opt).__name__} on "
        f"its parameters and gradients ({len(params)} tensors, "
        f"{sum(p.numel() for p in params)} values, CPU step {cpu_s:.2f} s): "
        f"max|err|/max|CPU| {worst:.2e} (rtol {A3_UPDATE_RTOL:.0e}); state "
        f"keys equal: {keys == card_keys} ({len(keys)})")
    if not worst <= A3_UPDATE_RTOL:
        raise AssertionError(f"{what}: the first update differs from the "
                             f"CPU path: {worst}")
    if keys != card_keys:
        raise AssertionError(f"{what}: state keys differ from the CPU "
                             f"{type(opt).__name__}'s")
    return worst, type(opt).__name__


def fleet_steps(step, batch, n):
    """``n`` steps of ``step`` on ``batch`` from a reset peak: losses, step
    ms and the peak in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    return losses, step_ms, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_bert_lamb(fa, smi, adamw_f32):
    """Phase 47a: BERT-base MLM (phase 25's model, batch and AdamW + clip)
    with ``strategy.lamb``: ``fleet.distributed_optimizer`` makes it Lamb;
    BERT_STEPS ``DistTrainStep`` s at NCCL world size 1. The loss is finite
    and falls, K1 / K2a / K2b launch 12 x BERT_STEPS times with the padding
    bias, the first update equals the CPU path's, the state keys
    Lamb's."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    def make(params):
        return AdamW(parameters=params, grad_clip=ClipGradByGlobalNorm(1.0),
                     **BERT_ADAMW)

    with nccl_world1():
        fleet_init(meta="lamb")
        model = fleet.distributed_model(build_bert())
        opt = fleet.distributed_optimizer(make(model.parameters()))
        step = fleet.DistTrainStep(
            model, lambda m, ids, types, mask, labels: m(
                ids, types, attention_mask=mask, labels=labels), opt)
        batch, real = mlm_batch(model.config.vocab_size)
        got = capture_first_update(step)
        reset_flash(fa)
        with flash_calls(fa) as calls:
            losses, step_ms, peak = fleet_steps(step, batch, BERT_STEPS)
        launches = flash_counts(fa)
        card_keys = sorted(opt.state_dict())
        inner = type(opt._inner_opt).__name__
        del step, opt, model
        torch.cuda.empty_cache()
    ms = float(np.mean(step_ms[1:]))
    tokens = batch[0].numel()
    log(f"# phase 47a: BERT-base MLM under {inner} (fleet.distributed_"
        f"optimizer, strategy.lamb {A3_LAMB}), {BERT_BATCH} x {BERT_SEQ}, "
        f"DistTrainStep at NCCL world 1: losses "
        f"{[round(x, 6) for x in losses]}, steps 2-{BERT_STEPS} {ms:.2f} ms "
        f"= {tokens / ms * 1e3:.0f} tokens/s (phase 25's AdamW f32 "
        f"{adamw_f32['step_ms']:.2f} ms), peak {peak:.2f} GiB, launches "
        f"{launches}  [{smi}]")
    if inner != "Lamb":
        raise AssertionError(f"BERT: strategy.lamb gave {inner}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"BERT Lamb: loss did not fall: {losses}")
    check_padded_calls(calls, ("fwd", "dq", "dkv"), ERNIE_BLOCKS * BERT_STEPS,
                       (BERT_BATCH, 1, 1, BERT_SEQ), "BERT Lamb")
    worst, _ = check_first_update(got, make, "lamb", card_keys,
                                  "phase 47a BERT")
    return dict(losses=losses, step_ms=step_ms, mean_step_ms=ms,
                tokens_per_s=tokens / ms * 1e3, real_tokens=real,
                peak_gib=peak, launches=launches, first_update_rel=worst,
                adamw_f32_step_ms=adamw_f32["step_ms"], card=smi)


def phase_resnet_lars(smi):
    """Phase 47b: ResNet-50 at RESNET_BATCH x RESNET_HW in f32,
    ``Momentum(RESNET_LR, **RESNET_MOMENTUM)`` made Lars by
    ``strategy.lars``, RESNET_LARS_STEPS ``DistTrainStep`` s at NCCL world
    size 1: the loss finite, the first update equal to the CPU path's."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    def make(params):
        return Momentum(RESNET_LR, parameters=params, **RESNET_MOMENTUM)

    with nccl_world1():
        fleet_init(meta="lars")
        model = fleet.distributed_model(build_resnet())
        opt = fleet.distributed_optimizer(make(model.parameters()))
        step = fleet.DistTrainStep(
            model, lambda m, x, y: F.cross_entropy(m(x), y), opt)
        batch = resnet_batch()
        got = capture_first_update(step)
        losses, step_ms, peak = fleet_steps(step, batch, RESNET_LARS_STEPS)
        card_keys = sorted(opt.state_dict())
        inner = type(opt._inner_opt).__name__
        del step, opt, model, batch
        torch.cuda.empty_cache()
    ms = float(np.mean(step_ms[1:]))
    log(f"# phase 47b: ResNet-50 under {inner} (strategy.lars {A3_LARS}), "
        f"{RESNET_BATCH} x {RESNET_HW}^2 f32, DistTrainStep at NCCL world "
        f"1: losses {[round(x, 5) for x in losses]}, steps "
        f"2-{RESNET_LARS_STEPS} {ms:.2f} ms = "
        f"{RESNET_BATCH / ms * 1e3:.1f} images/s, peak {peak:.2f} GiB, no "
        f"kernel of the repo on this path  [{smi}]")
    if inner != "Lars":
        raise AssertionError(f"ResNet: strategy.lars gave {inner}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ResNet Lars: losses {losses}")
    worst, _ = check_first_update(got, make, "lars", card_keys,
                                  "phase 47b ResNet-50")
    return dict(losses=losses, step_ms=step_ms, mean_step_ms=ms,
                images_per_s=RESNET_BATCH / ms * 1e3, peak_gib=peak,
                first_update_rel=worst, card=smi)


def phase_lamb_gloo(smi, timeout=600):
    """Phase 47c: GPT-3 1.3B's widths at depth 2, mp 2 under Lamb (the
    swap), two processes sharing the card over gloo, LOCKSTEP_STEPS steps
    against a single-process ``TrainStep`` + the same Lamb on the same
    weights and batch: phase 39's gates, and every trust ratio's sums of
    squares in the first step equal on both ranks to the single-process
    run's for the whole parameter (A3_SQ_RTOL)."""
    res, secs = spawn_fleet_ranks(A3_GLOO_CONFIGS, timeout)
    out = {"seconds": secs}
    for name in A3_GLOO_CONFIGS:
        a, b = res[0][name], res[1][name]
        out[name] = check_gloo_config(name, a, b, smi, "47c")
        want = a["ref_sq_sums"]
        worst = 0.0
        for r in (a, b):
            if r["inner"] != "Lamb" or set(r["sq_sums"]) != set(want):
                raise AssertionError(f"{name}: {r['inner']}, the trust "
                                     "ratios of other parameters")
            for n, w in want.items():
                rel = float(np.max(np.abs(np.subtract(r["sq_sums"][n], w))
                                   / np.maximum(np.abs(w), 1e-30)))
                worst = max(worst, rel)
        log(f"# phase 47c: {name}: {len(want)} trust ratios, their sums of "
            f"squares on both ranks vs the single-process run's: max rel "
            f"{worst:.2e} (rtol {A3_SQ_RTOL:.0e}); {secs:.1f} s  [{smi}]")
        if not worst <= A3_SQ_RTOL:
            raise AssertionError(f"{name}: a trust ratio read a part of its "
                                 f"parameter: {worst}")
        out[name]["sq_sums_rel"] = worst
    return out


def unpadded_pairs(segments):
    """The (query, key) pairs the packed causal sequences need."""
    return sum(s * (s + 1) // 2 for s in segments)


def unpadded_run(q, k, v, do, cu):
    """``flash_attn_unpadded`` causal on the packed batch, forward and
    backward: out, dq, dk, dv."""
    from paddle_tpu_torch.nn.functional.flash_attention import (
        flash_attn_unpadded)

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    seq = max(UNPADDED_SEGMENTS)
    out, _ = flash_attn_unpadded(*leaves, cu, cu, seq, seq,
                                 UNPADDED_D ** -0.5, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    return (out.detach(),) + tuple(grads)


def phase_unpadded(fa, smi, peaks):
    """Phase 47d: ``flash_attn_unpadded`` on UNPADDED_SEGMENTS packed (plus
    UNPADDED_TAIL padding tokens) at H=16, D=128, causal, f32 and bf16:
    one K1, K2a and K2b launch a forward and backward, each output and
    gradient against the plain versions' (FLASH_TOL), the tail's rows 0
    and every gradient finite; then K1 and K2a + K2b on the folded
    ``[1, 1, T, T]`` bias timed beside the plain versions, the same
    sequences padded to B=5 x T=2048 (causal, no bias; the kernels as
    ``F.flash_attention(causal=True)`` reaches them), SDPA with the bool
    mask (the library), the bound of the work the square computes and of
    the work the sequences need."""
    from torch.nn.attention import sdpa_kernel

    segs = UNPADDED_SEGMENTS
    t, h, d = sum(segs) + UNPADDED_TAIL, UNPADDED_H, UNPADDED_D
    n_real = sum(segs)
    cu = torch.tensor(np.cumsum((0,) + segs), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 47)
    needed = unpadded_pairs(segs) * h
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt)[6:]
        q, k, v, do = (torch.randn((t, h, d), generator=gen, device=DEVICE)
                       .to(dt) for _ in range(4))
        reset_flash(fa)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = unpadded_run(q, k, v, do, cu)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = flash_counts(fa)
        bf = int(dt == torch.bfloat16)
        if launches != {"fwd": 1, "dq": 1, "dkv": 1, "fwd_bf16": bf,
                        "dq_bf16": bf, "dkv_bf16": bf}:
            raise AssertionError(f"unpadded {tag}: launches {launches}")
        with plain_attention(fa):
            plain = unpadded_run(q, k, v, do, cu)
        errs = {}
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, plain):
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"unpadded {tag}: {name} not finite")
            errs[name] = _rel(a, b)[1]
            if not errs[name] <= FLASH_TOL[dt]:
                raise AssertionError(f"unpadded {tag}: {name} differs from "
                                     f"plain: {errs[name]}")
        if got[0][n_real:].abs().max().item() != 0 or \
                got[1][n_real:].abs().max().item() != 0:
            raise AssertionError(f"unpadded {tag}: a tail row is not 0")
        # the kernels alone on the folded bias, as the route calls them
        from paddle_tpu_torch.nn.functional.flash_attention import _visible

        vis = _visible(cu, cu, t, t, True)
        bias = torch.where(vis, 0.0, fa.NEG_INF)[None, None]
        q4, k4, v4, do4 = (x[None] for x in (q, k, v, do))
        o, lse = fa.flash_attention_forward_cuda(q4, k4, v4, bias)
        delta = fa._delta(o, do4).contiguous()

        def k1():
            return fa.flash_attention_forward_cuda(q4, k4, v4, bias)

        def pair():
            fa.flash_attention_bwd_dq_cuda(q4, k4, v4, bias, do4, lse, delta)
            fa.flash_attention_bwd_dkv_cuda(q4, k4, v4, bias, do4, lse,
                                            delta)

        def plain_pair():
            fa.flash_attention_bwd_dq_plain(q4, k4, v4, bias, do4, lse,
                                            delta)
            fa.flash_attention_bwd_dkv_plain(q4, k4, v4, bias, do4, lse,
                                             delta)

        def call():
            from paddle_tpu_torch.nn.functional.flash_attention import (
                flash_attn_unpadded)

            with torch.no_grad():
                flash_attn_unpadded(q, k, v, cu, cu, max(segs), max(segs),
                                    d ** -0.5, causal=True)

        packed = dict(
            fwd_ms=cuda_ms(k1), pair_ms=cuda_ms(pair), call_fwd_ms=cuda_ms(
                call),
            plain_fwd_ms=cuda_ms(lambda: fa.flash_attention_forward_plain(
                q4, k4, v4, bias), iters=3, warm=1),
            plain_pair_ms=cuda_ms(plain_pair, iters=3, warm=1))
        # the same sequences padded to B = 5 x T = 2048, causal, no bias
        qp, kp, vp, dop = (torch.zeros((len(segs), max(segs), h, d),
                                       dtype=dt, device=DEVICE)
                           for _ in range(4))
        for i, (a, b) in enumerate(zip(cu[:-1].tolist(), cu[1:].tolist())):
            for dst, src in ((qp, q), (kp, k), (vp, v), (dop, do)):
                dst[i, :b - a] = src[a:b]
        op, lsep = fa.flash_attention_forward_cuda(qp, kp, vp, causal=True)
        deltap = fa._delta(op, dop).contiguous()

        def pad_pair():
            fa.flash_attention_bwd_dq_cuda(qp, kp, vp, None, dop, lsep,
                                           deltap, causal=True)
            fa.flash_attention_bwd_dkv_cuda(qp, kp, vp, None, dop, lsep,
                                            deltap, causal=True)

        padded = dict(
            fwd_ms=cuda_ms(lambda: fa.flash_attention_forward_cuda(
                qp, kp, vp, causal=True)),
            pair_ms=cuda_ms(pad_pair))
        # the library: SDPA over [1, H, T, D] with the same bool mask
        label, qh, kh, vh, kw = sdpa_yardsticks(q4, k4, v4)[0]
        mask = vis[None, None]
        be = sdpa_backend(qh, kh, vh, attn_mask=mask)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with sdpa_kernel([be]):
            lib_fwd = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask))
            lib_out = sdpa(qh, kh, vh, attn_mask=mask)
            doh = do4.transpose(1, 2)
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                lib_out, (qh, kh, vh), doh, retain_graph=True))
        library = dict(fwd_ms=lib_fwd, bwd_ms=lib_bwd, backend=be.name)
        square = {kind: flash_bound(kind, q4, k4, False, peaks, bias)
                  for kind in ("fwd", "dq", "dkv")}
        need = {kind: flash_bound(kind, q4, k4, False, peaks,
                                  needed_pairs=needed // h)
                for kind in ("fwd", "dq", "dkv")}
        bound = dict(
            square_fwd_ms=square["fwd"]["bound_ms"],
            square_pair_ms=square["dq"]["bound_ms"]
            + square["dkv"]["bound_ms"],
            needed_fwd_ms=need["fwd"]["bound_ms"],
            needed_pair_ms=need["dq"]["bound_ms"] + need["dkv"]["bound_ms"])
        gflop = dict(square_fwd=4 * d * t * t * h / 1e9,
                     needed_fwd=4 * d * needed / 1e9)
        rows[tag] = dict(launches=launches, rel_err=errs, packed=packed,
                         padded=padded, library=library, bound=bound,
                         gflop=gflop, call_peak_gib=peak)
        log(f"# phase 47d: flash_attn_unpadded {tag}, segments {segs} + "
            f"{UNPADDED_TAIL} tail = T {t}, H={h} D={d} causal: launches "
            f"{launches}, the call's peak {peak:.2f} GiB, rel err vs plain "
            f"{errs} (tol "
            f"{FLASH_TOL[dt]:.2e}), tail rows 0, gradients finite; K1 on the "
            f"[1, 1, T, T] bias {packed['fwd_ms']:.4f} ms (the call "
            f"{packed['call_fwd_ms']:.4f} ms, plain "
            f"{packed['plain_fwd_ms']:.4f} ms), K2a + K2b "
            f"{packed['pair_ms']:.4f} ms (plain {packed['plain_pair_ms']:.4f}"
            f" ms); padded B={len(segs)} T={max(segs)} causal: K1 "
            f"{padded['fwd_ms']:.4f} ms, "
            f"pair {padded['pair_ms']:.4f} ms; SDPA [{be.name}] bool mask: "
            f"forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms; bound of "
            f"the square ({gflop['square_fwd']:.1f} GFLOP forward) "
            f"{bound['square_fwd_ms']:.4f} / {bound['square_pair_ms']:.4f} "
            f"ms, of the needed work ({gflop['needed_fwd']:.1f} GFLOP) "
            f"{bound['needed_fwd_ms']:.4f} / {bound['needed_pair_ms']:.4f} ms"
            f"  [{smi}]")
        del q, k, v, do, got, plain, bias, vis, o, lse, delta, qp, kp, vp
        del dop, op, lsep, deltap, qh, kh, vh, lib_out
        torch.cuda.empty_cache()
    return rows


def phases_a3(fa, smi, peaks, adamw_f32):
    """Phase 47 (47a-d); returns the ``a3`` JSON line's numbers."""
    import gc

    t0 = time.perf_counter()
    out = {"bert_lamb": phase_bert_lamb(fa, smi, adamw_f32)}
    gc.collect()
    torch.cuda.empty_cache()
    out["resnet_lars"] = phase_resnet_lars(smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["gpt_mp2_lamb"] = phase_lamb_gloo(smi)
    out["unpadded"] = phase_unpadded(fa, smi, peaks)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = smi
    log(f"phase 47: {out['seconds']:.1f} s")
    return out


AP_LAYERS = 4
AP_SAVE_AT = 2   # 48b's checkpoint: after this many of 48a's steps
AP_PLAN = {"gpt.decoder.*.attn.qkv_proj": "col",
           "gpt.decoder.*.attn.out_proj": "row",
           "gpt.decoder.*.mlp.fc_in": "col",
           "gpt.decoder.*.mlp.fc_out": "row"}
AP_EMBEDDING = (50304, 2048)
# a move's peak growth a rank against the plan's peak_bytes, and the
# restoring process's growth against the largest leaf it reads
AP_PEAK_SLACK = 1.05


def build_ap(spec, layers=AP_LAYERS):
    """Phase 48's GPT: GPT-3 1.3B's widths at ``layers`` (a rehearsal's
    tiny ``spec["model"]`` config instead), built whole."""
    if not spec.get("model"):
        return build_model(layers)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    return GPTForCausalLM(GPTConfig(**spec["model"]), device=spec["device"],
                          seed=SEED)


def ap_plan(dist):
    make = {"col": dist.ColWiseParallel, "row": dist.RowWiseParallel}
    return {k: make[v]() for k, v in AP_PLAN.items()}


def ap_held_bytes(model, mp):
    """The parameter bytes a rank holds at mp ``mp`` by the arithmetic:
    each weight the plan splits and each split bias (a ColWise bias) an
    ``mp``-th, the rest whole."""
    import fnmatch

    split = 0
    whole = 0
    for name, p in model.named_parameters():
        layer, _, leaf = name.rpartition(".")
        kind = next((v for k, v in AP_PLAN.items()
                     if fnmatch.fnmatchcase(layer, k)), None)
        nbytes = p.numel() * p.element_size()
        if kind is not None and (leaf == "weight" or kind == "col"):
            split += nbytes
        else:
            whole += nbytes
    return split // mp + whole, split, whole


def _rank_auto_parallel(out_dir, spec):
    """One rank of phase 48 (run by ``paddle.distributed.spawn``): 48a the
    whole-built GPT ``parallelize`` d at mp 2 and trained by a plain
    ``TrainStep`` (phase 7's AdamW and clip) for TRAIN_STEPS steps, 48b its
    canonical checkpoint saved after AP_SAVE_AT of them, 48c the three
    moves of ``reshard_array`` on the ``AP_EMBEDDING`` table; the results
    pickled to ``out_dir``."""
    import os
    import pickle

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import reshard as rs
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    device = spec["device"]
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if spec.get("prepare"):
        spec["prepare"]()
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    out = {}
    # 48a: built whole (no topology in force), then split by the plan
    model = build_ap(spec)
    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **ADAMW)
    want_held, _, _ = ap_held_bytes(model, 2)
    mesh = dist.ProcessMesh([0, 1], dim_names=["mp"])
    model, opt = dist.parallelize(model, opt, mesh, {
        "mp_config": {"parallelize_plan": ap_plan(dist)}})
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    step = TrainStep(model, lambda m, ids, lab: m(ids, labels=lab), opt)
    ids, labels = train_batch(model.config.vocab_size)
    reset_flash(fa)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        sync()
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if i + 1 == AP_SAVE_AT:  # 48b: the checkpoint of the split run
            t0 = time.perf_counter()
            ckpt.save_state_dict(ckpt.canonical_state_dict(model, opt),
                                 spec["path"])
            out["save_s"] = time.perf_counter() - t0
            out["written"] = ckpt.saved_bytes(spec["path"], rank)
    out.update(
        losses=losses, step_ms=step_ms, held=held, want_held=want_held,
        heads=model.gpt.decoder[0].attn.num_heads,
        launches={k: getattr(fa, f"launches_{k}") for k in
                  ("fwd", "dq", "dkv")},
        peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                  if on_card else 0.0))
    if rank == 0:
        t0 = time.perf_counter()
        out["verified"] = ckpt.verify_checkpoint(spec["path"], deep=True)
        out["verify_s"] = time.perf_counter() - t0
    del step, opt, model
    # 48c: the embedding table through slice / all-to-all / all-gather
    gen = torch.Generator(device=device).manual_seed(SEED)
    emb = torch.randn(spec.get("embedding", AP_EMBEDDING), generator=gen,
                      device=device)
    x = rs.local_block(emb, mesh, ("mp",)).clone()
    moves = []
    for src, dst in ((("mp",), (None, "mp")), ((None, "mp"), ()),
                     ((), ("mp",))):
        sync()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        collective.reset_counts()
        dist.barrier()  # both ranks start the move together
        t0 = time.perf_counter()
        new, plan = rs.reshard_array(x, mesh, dst, src_spec=src)
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        growth = (torch.cuda.max_memory_allocated() - base) if on_card \
            else 0
        moves.append(dict(
            src=list(src), dst=list(dst), kinds=[s.kind for s in plan.steps],
            equal=bool(torch.equal(new, rs.local_block(emb, mesh, dst))),
            moved=collective.counts["reshard_moved_bytes"],
            plan_moved=plan.moved_bytes, plan_peak=plan.peak_bytes,
            growth=growth, ms=ms))
        x = new
    out["moves"] = moves
    del emb, x, new
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_auto_parallel(smi, timeout=900, spec=None):
    """Phase 48: the auto-parallel API and restore-anywhere checkpoints.
    First a single-process ``TrainStep`` of the same depth (the baseline,
    its memory freed); then two processes sharing the card over gloo: (a)
    GPT-3 1.3B's widths at depth AP_LAYERS built whole and ``parallelize``
    d at mp 2 (ColWise ``qkv_proj`` / ``fc_in``, RowWise ``out_proj`` /
    ``fc_out``), TRAIN_STEPS steps of a plain ``TrainStep``: losses equal on
    the ranks and within TRAIN_LOSS_RTOL of the baseline, K1 / K2a / K2b
    launches a rank = layers x steps at H = 8, the parameter bytes a rank
    holds equal to the arithmetic; (b) after AP_SAVE_AT steps
    ``save_state_dict(canonical_state_dict(...))``, restored here into one
    process, unsplit, for the remaining steps: losses within
    TRAIN_LOSS_RTOL of the uninterrupted run, ``verify_checkpoint(deep=
    True)``, the bytes each rank wrote equal to the arithmetic (parameters
    and two f32 moments, each piece once, the beta powers beside them),
    save / restore seconds, the restoring process's growth within
    AP_PEAK_SLACK of the largest leaf (never a second full copy); (c)
    ``reshard_array`` of the AP_EMBEDDING f32 table Shard(0) -> Shard(1)
    (all-to-all) -> Replicate (all-gather) -> Shard(0) (slice): values
    equal, ``reshard_moved_bytes`` the plan's, each rank's growth within
    AP_PEAK_SLACK of the plan's ``peak_bytes``. Returns the
    ``auto_parallel`` JSON line's numbers."""
    import gc
    import os
    import pickle
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.parallel import join_spawned

    spec = dict(spec or {"device": DEVICE})
    on_card = spec["device"] == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ap_")
    spec["path"] = os.path.join(tmp, "ckpt")
    try:
        # the uninterrupted single-process run of the same depth
        model = build_ap(spec)
        step, opt = trainer(model)
        ids, labels = train_batch(model.config.vocab_size)
        base, base_ms = timed_steps(step, (ids, labels), TRAIN_STEPS, sync)
        n_tensors = len(list(model.parameters()))
        largest = max(p.numel() * p.element_size()
                      for p in model.parameters())
        _, split_bytes, whole_bytes = ap_held_bytes(model, 2)
        whole_bytes += sum(b.numel() * b.element_size()
                           for b in model.buffers())
        del step, opt, model
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ctx = dist.spawn(_rank_auto_parallel, (tmp, spec), nprocs=2,
                         join=False, backend="gloo",
                         master=f"file://{tmp}/rendezvous")
        join_spawned(ctx, timeout)
        secs = time.perf_counter() - t0
        a, b = (pickle.load(open(os.path.join(tmp, f"rank{r}.pkl"), "rb"))
                for r in range(2))
        out = {"seconds_ranks": secs, "card": smi}
        # 48a
        rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], base))
        want = AP_LAYERS * TRAIN_STEPS if not spec.get("model") else \
            spec["model"]["num_hidden_layers"] * TRAIN_STEPS
        log(f"# phase 48a: parallelize mp 2, {AP_LAYERS} layers: losses "
            f"{a['losses']} vs TrainStep {base} (rel {rel:.2e}, rtol "
            f"{TRAIN_LOSS_RTOL}); step ms rank 0 {a['step_ms']} rank 1 "
            f"{b['step_ms']} (TrainStep {base_ms}); launches rank 0 "
            f"{a['launches']} rank 1 {b['launches']} at H={a['heads']}; "
            f"parameter bytes a rank {a['held']} / {b['held']} vs "
            f"{a['want_held']}; peak {a['peak_gib']:.2f} / "
            f"{b['peak_gib']:.2f} GiB  [{smi}]")
        if a["losses"] != b["losses"]:
            raise AssertionError("48a: the ranks' losses differ")
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError("48a: losses differ from TrainStep")
        for r in (a, b):
            if any(n != want for n in r["launches"].values()):
                raise AssertionError(f"48a: launches {r['launches']} != "
                                     f"{want}")
            if r["held"] != r["want_held"]:
                raise AssertionError(f"48a: a rank holds {r['held']} "
                                     f"parameter bytes, not "
                                     f"{r['want_held']}")
        out["mp2"] = {k: a[k] for k in ("losses", "step_ms", "launches",
                                        "heads", "held", "peak_gib")}
        out["mp2"].update(baseline=base, baseline_step_ms=base_ms,
                          rel=rel, rank1_launches=b["launches"],
                          rank1_step_ms=b["step_ms"])
        # 48b: restore into one process, unsplit, and run on
        model = build_ap(spec)
        step, opt = trainer(model)
        ckpt.canonical_state_dict(model, opt)  # the moments, made first
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        ckpt.restore_canonical(spec["path"], model, opt)
        sync()
        restore_s = time.perf_counter() - t0
        growth = (torch.cuda.max_memory_allocated() - before) if on_card \
            else 0
        resumed, _ = timed_steps(step, (ids, labels),
                                 TRAIN_STEPS - AP_SAVE_AT, sync)
        del step, opt, model
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        tail = a["losses"][AP_SAVE_AT:]
        rel_b = max(abs(x - y) / abs(y) for x, y in zip(resumed, tail))
        full_copy = 3 * (split_bytes + whole_bytes)
        want_w = [3 * split_bytes // 2 + 3 * whole_bytes + 8 * n_tensors,
                  3 * split_bytes // 2]
        written = [a["written"], b["written"]]
        log(f"# phase 48b: checkpoint after step {AP_SAVE_AT}: written "
            f"{written} bytes a rank vs {want_w} (parameters + two f32 "
            f"moments once, beta powers 8 bytes a parameter); verify "
            f"{a['verified']} in {a['verify_s']:.2f} s; save "
            f"{a['save_s']:.2f} s; restore into one process "
            f"{restore_s:.2f} s, growth {growth / 2 ** 20:.1f} MiB vs the "
            f"largest leaf {largest / 2 ** 20:.1f} MiB and one full copy "
            f"{full_copy / 2 ** 20:.1f} MiB; resumed losses {resumed} vs "
            f"the uninterrupted {tail} (rel {rel_b:.2e})  [{smi}]")
        if a["verified"] != (True, "ok"):
            raise AssertionError(f"48b: checkpoint {a['verified']}")
        if written != want_w:
            raise AssertionError(f"48b: bytes written {written} != {want_w}")
        if not rel_b <= TRAIN_LOSS_RTOL:
            raise AssertionError("48b: the resumed losses differ")
        if on_card and not growth <= AP_PEAK_SLACK * largest:
            raise AssertionError(f"48b: the restore grew {growth} bytes")
        out["checkpoint"] = dict(
            written=written, save_s=a["save_s"], verify_s=a["verify_s"],
            restore_s=restore_s, restore_growth=growth, largest_leaf=largest,
            full_copy=full_copy, resumed=resumed, rel=rel_b)
        # 48c
        worst = 0.0
        for r, res in enumerate((a, b)):
            for m in res["moves"]:
                ratio = m["growth"] / m["plan_peak"]
                worst = max(worst, ratio)
                log(f"# phase 48c: rank {r} {m['src']} -> {m['dst']} "
                    f"{m['kinds']}: equal {m['equal']}, moved {m['moved']} "
                    f"(plan {m['plan_moved']}), growth {m['growth']} vs "
                    f"plan peak {m['plan_peak']} ({ratio:.3f}), "
                    f"{m['ms']:.1f} ms  [{smi}]")
                if not m["equal"] or m["moved"] != m["plan_moved"]:
                    raise AssertionError(f"48c: {m}")
                if on_card and not ratio <= AP_PEAK_SLACK:
                    raise AssertionError(f"48c: growth {m}")
        out["reshard"] = [dict(m, rank=r) for r, res in enumerate((a, b))
                          for m in res["moves"]]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 48: {out['seconds']:.1f} s")
    return out



# -- phase 49: the serving tier ----------------------------------------------

#: slots a serving worker holds (engine_config()'s geometry otherwise)
SERVING_SLOTS = 4
#: prompts at least this long go to the prefill worker in 49b: the 300,
#: 350, 480 and 600-token prompts of make_prompts
SERVING_PREFILL_THRESHOLD = 256
#: a stream may part from its reference only at a near-tie: the decision's
#: top-2 margin (logits, or logits / T + Gumbel noise for a sampled row)
#: below this
NEAR_TIE = 1e-3
#: the int8 KV wire keeps at least this share of the tokens decoded over
#: imported pages (the generated tokens of the disaggregated requests),
#: the reference test's bar
INT8_WIRE_AGREE = 0.75
#: the router's liveness window once 49c's victim is killed
SERVING_GRACE_S = 1.0
#: the worker CLI's model: GPT-3 1.3B at full width and depth (the
#: arguments equal build_model(24)'s config and seed)
SERVING_MODEL = dict(vocab=50304, hidden=2048, layers=24, heads=16,
                     max_positions=2048)


def serving_argv(model):
    """The worker CLI's model and engine arguments (also parsed here, so
    the in-process model is the worker processes' model)."""
    argv = ["--device", DEVICE, "--model-seed", str(SEED)]
    for k, v in model.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    cfg = engine_config()
    return argv + ["--slots", str(SERVING_SLOTS),
                   "--max-length", str(cfg["max_length"]),
                   "--page-size", str(cfg["page_size"]),
                   "--speculate-k", str(cfg["speculate_k"]),
                   "--kv-dtype", "bf16"]


def serving_engine_config():
    return dict(engine_config(), num_slots=SERVING_SLOTS, kv_dtype="bf16")


def submit_serving(router, prompts):
    """make_prompts' requests, every other one sampled."""
    return [router.submit(p, slo="standard", max_new_tokens=NEW_TOKENS,
                          do_sample=(i % 2 == 1), temperature=0.7, top_k=8)
            for i, p in enumerate(prompts)]


def drive_router(router, workers, timeout=600.0):
    """Pump the router and poll every worker in this thread until every
    request resolved; returns the wall seconds."""
    t0 = time.perf_counter()
    while router.pending():
        router.pump()
        for w in workers:
            w.poll_once()
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"router undrained: {router.stats()}")
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def drive_router_threaded(router, workers, timeout=600.0):
    """The router here, each worker polled by its own thread: a prefill
    worker's KV frame (~60 MB a 600-token prompt's K at 1.3B) blocks its
    send until the decode worker reads it, which one thread cannot do."""
    import threading

    stop, errors = threading.Event(), []

    def loop(w):
        try:
            while not stop.is_set():
                if not w.poll_once():
                    time.sleep(0.001)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=loop, args=(w,), daemon=True)
               for w in workers]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        while router.pending() and not errors:
            router.pump()
            # the router's thread holds the interpreter lock while it
            # pumps: a slow cadence leaves it to the engines' threads
            time.sleep(0.005)
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"router undrained: {router.stats()}")
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    if errors:
        raise errors[0]
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def decision_margin(model, stream, j, params, top=False):
    """The top-2 margin of the decision that chose token ``j`` of
    ``stream``, from a full forward over ``stream[:j]``: of the logits for
    a greedy request; of the top-k-filtered logits / T plus the engine's
    Gumbel noise for position ``j`` (``_mix_seed(seed, j)``) for a sampled
    one. ``top``: also the largest of those values, as (margin, largest)."""
    from paddle_tpu_torch.inference.engine import _mix_seed

    ctx = torch.as_tensor(np.asarray(stream[:j])[None], device=DEVICE)
    with torch.no_grad():
        x = model(ctx)[0, -1].float()
    temp, top_k, _, greedy = params.fields()
    if not greedy:
        x = x / temp
        if top_k > 0:
            kth = torch.topk(x, top_k).values[-1]
            x = torch.where(x < kth, torch.tensor(float("-inf"),
                                                  device=x.device), x)
        gen = torch.Generator(device=x.device).manual_seed(
            _mix_seed(int(params.seed), j))
        u = torch.rand(x.shape[-1], generator=gen, device=x.device,
                       dtype=torch.float32)
        x = x - torch.log(-torch.log(u))
    best = torch.topk(x, 2).values
    margin = float(best[0] - best[1])
    return (margin, float(best[0])) if top else margin


def check_serving_streams(fa, model, prompts, params, got, want, what,
                          names):
    """Every stream of ``got`` equal to ``want``'s, or parting at a
    near-tie (:func:`decision_margin` below NEAR_TIE); a parting is
    reported by :func:`report_divergence`. Returns the partings."""
    partings = []
    for i, (a, b) in enumerate(zip(got, want)):
        if np.array_equal(a, b):
            continue
        j = int(np.flatnonzero(np.asarray(a) != np.asarray(b))[0])
        margin = decision_margin(model, b, j, params[i])
        partings.append(dict(request=i, token=j - len(prompts[i]),
                             margin=margin,
                             sampled=bool(params[i].do_sample)))
        log(f"{what}: request {i} parts at generated token "
            f"{j - len(prompts[i])}: decision margin {margin:.3e} "
            f"({'sampled' if params[i].do_sample else 'greedy'})")
    if partings:
        report_divergence(fa, model, prompts, got, want, names=names)
    far = [p for p in partings if not p["margin"] < NEAR_TIE]
    if far:
        raise AssertionError(f"{what}: streams part away from a near-tie: "
                             f"{far}")
    return partings


def k3_expected_sum(pa, workers):
    """:func:`k3_expected` summed over the workers' engines."""
    total = np.zeros(4, np.int64)
    for w in workers:
        eng = w.engine
        ad = eng.adapter
        total += k3_expected(pa, ad.num_layers, eng.stats(), eng,
                             ad.num_heads // ad.num_kv_heads)
    return tuple(int(x) for x in total)


def free_card():
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def reset_k3(pa):
    for n in K3_COUNTERS:
        setattr(pa, n, 0)


def check_k3(pa, workers, what):
    launches, tile, split, decode, verify = k3_counts(pa)
    want = k3_expected_sum(pa, workers)
    if (tile, split, decode, verify) != want or launches != tile + split:
        raise AssertionError(
            f"{what}: K3 launches (tile, split, decode, verify) = "
            f"{(tile, split, decode, verify)} of {launches}, expected "
            f"{want} from the engines' programs")
    return dict(launches=launches, tile=tile, split=split, decode=decode,
                verify=verify)


@contextlib.contextmanager
def disagg_probes(worker_mod, transport_mod, decode_worker):
    """Timings of the disaggregated path by the KV frame's page count:
    ``encode_kv``, the frame's bytes on the socket, its stamp (after the
    encode) to the decode worker's poll that received it, that poll to
    ``decode_kv`` (waiting for a slot), the decode."""
    rec = {}
    saved = (worker_mod.encode_kv, worker_mod.decode_kv,
             transport_mod.encode_frame)
    server = decode_worker._server
    server_poll = server.poll

    def poll():
        got = server_poll()
        now = time.time()
        for _, frame in got:
            if frame.get("t") == "kv":
                n = int(np.asarray(frame["kv"]["k"]).shape[1])
                rec.setdefault(n, {}).update(recv_wall=now)
        return got

    def encode_kv(k, v, wire, *a, **kw):
        t0 = time.perf_counter()
        out = saved[0](k, v, wire, *a, **kw)
        n = int(out["k"].shape[1])
        rec.setdefault(n, {}).update(
            encode_s=time.perf_counter() - t0,
            payload_bytes=sum(int(x.nbytes) for key, x in out.items()
                              if key in ("k", "v", "k_scale", "v_scale")))
        return out

    def decode_kv(payload):
        t0 = time.perf_counter()
        out = saved[1](payload)
        n = int(np.asarray(payload["k"]).shape[1])
        rec.setdefault(n, {}).update(decode_s=time.perf_counter() - t0,
                                     decode_wall=time.time())
        return out

    def encode_frame(frame):
        data = saved[2](frame)
        if frame.get("t") == "kv":
            n = int(np.asarray(frame["kv"]["k"]).shape[1])
            rec.setdefault(n, {}).update(frame_bytes=len(data),
                                         sent_wall=frame["ts"])
        return data

    worker_mod.encode_kv, worker_mod.decode_kv = encode_kv, decode_kv
    transport_mod.encode_frame = encode_frame
    server.poll = poll
    try:
        yield rec
    finally:
        (worker_mod.encode_kv, worker_mod.decode_kv,
         transport_mod.encode_frame) = saved
        server.poll = server_poll


def timed_method(obj, name, out, key_fn=lambda *a: None):
    """Wrap ``obj.name`` so the seconds of each call that returned
    something land in ``out[key_fn(*args)]`` (a list), with the result."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        if res is not None:
            out.setdefault(key_fn(*a), []).append(
                (time.perf_counter() - t0, res))
        return res

    setattr(obj, name, wrapped)


def isolated_handoff(pw, dw, prompt, params, wire):
    """One KV handoff alone, in this thread, timed piece by piece: the
    prefill worker's ``prefill_export`` (its prefill, then the pages to the
    host), ``encode_kv``, the frame's pickling, its crossing of a loopback
    socket to a ``TransportServer`` poll (a sender thread), ``decode_kv``
    and the decode engine's ``try_import_prefill``."""
    import threading

    from paddle_tpu_torch.framework.dtype import from_host
    from paddle_tpu_torch.serving import transport as tr

    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    out = {}
    pw.engine.release_prefix_cache()  # a full prefill, not a prefix hit
    t0 = time.perf_counter()
    payload = pw.engine.prefill_export(prompt, params)
    out["export_s"] = time.perf_counter() - t0
    out["prefill_s"] = payload["prefill_s"]
    t0 = time.perf_counter()
    kv = tr.encode_kv(payload["k"], payload["v"], wire, payload.get("ks"),
                      payload.get("vs"), dtype=payload["dtype"])
    out["encode_s"] = time.perf_counter() - t0
    frame = {"t": "kv", "first_token": payload["first_token"],
             "true_len": payload["true_len"], "kv": kv}
    t0 = time.perf_counter()
    out["frame_bytes"] = len(tr.encode_frame(frame))
    out["pickle_s"] = time.perf_counter() - t0
    server = tr.TransportServer()
    client = tr.TransportClient(server.addr)
    try:
        t0 = time.perf_counter()
        sender = threading.Thread(target=client.send, args=(frame,))
        sender.start()
        got = []
        while not got:
            got = server.poll()
        out["socket_s"] = time.perf_counter() - t0
        sender.join(60)
    finally:
        client.close()
        server.close()
    t0 = time.perf_counter()
    dec = tr.decode_kv(got[0][1]["kv"])
    out["decode_s"] = time.perf_counter() - t0
    kv_in = {"first_token": payload["first_token"],
             "true_len": payload["true_len"], "k": dec["k"], "v": dec["v"],
             "dtype": dec["dtype"]}
    t0 = time.perf_counter()
    rid = dw.engine.try_import_prefill(prompt, params, kv_in)
    sync()
    out["import_s"] = time.perf_counter() - t0
    if rid is None:
        raise AssertionError("the isolated import found no slot")
    out["bytes_per_prompt_token"] = out["frame_bytes"] / len(prompt)
    # the pool's pages after the import against the exported ones: the raw
    # wire bit-equal, the int8 wire within its bound; a control (scales
    # rolled across pages) must break the bound
    pages = dw.engine._requests[rid].page_ids[:payload["k"].shape[1]]
    for name, pool in (("k", dw.engine._kc), ("v", dw.engine._vc)):
        exp = from_host(payload[name], payload["dtype"], pool.device)
        got = pool[:, pages]
        if wire == "raw":
            if not torch.equal(got.view(torch.int16),
                               exp.view(torch.int16)):
                raise AssertionError(f"49b raw: imported {name} pages are "
                                     "not the exported bits")
            continue
        out[f"wire_excess_{name}"] = wire_excess(exp, got)
        if not out[f"wire_excess_{name}"] <= 1.0:
            raise AssertionError(
                f"49b int8: imported {name} pages off by "
                f"{out[f'wire_excess_{name}']} of the wire's bound")
        bad = dict(kv, **{f"{name}_scale": np.roll(kv[f"{name}_scale"], 1,
                                                   axis=1)})
        rolled = torch.from_numpy(tr.decode_kv(bad)[name]).to(pool.device)
        out[f"control_excess_{name}"] = wire_excess(exp, rolled)
        if not out[f"control_excess_{name}"] > 1.0:
            raise AssertionError("49b int8: the control passed the bound")
    return out


def wire_excess(exported, imported):
    """Largest ``|imported - exported|`` over the int8 KV wire's bound: half
    a quantization level (absmax / 127 of the element's [layer, page, head]
    row of the exported pages, + 1e-4 of it for f32 rounding) plus the
    rounding of the dequantized value to the pool's bf16 (2**-8 of it).
    At most 1 when every page came back in its place at its own scale."""
    x = exported.float()
    level = x.abs().amax(dim=(-2, -1), keepdim=True) / 127.0
    bound = (0.5 * level * (1 + 1e-4)
             + 2.0 ** -8 * (x.abs() + 0.5 * level)).clamp_min(
                 torch.finfo(torch.float32).tiny)
    return float(((imported.float() - x).abs() / bound).max())


def kv_payload_bytes(model_cfg, n_pages, wire):
    """The KV payload's bytes for ``n_pages`` content pages of a bf16
    pool at ``model_cfg``'s widths: k and v, 2 bytes an element on the
    raw wire; 1 byte an element plus one f32 scale per [layer, page,
    head] on the int8 wire."""
    cfg = engine_config()
    heads, d = model_cfg["heads"], model_cfg["hidden"] // model_cfg["heads"]
    elems = model_cfg["layers"] * n_pages * heads * cfg["page_size"] * d
    if wire == "raw":
        return 2 * 2 * elems
    return 2 * (elems + 4 * model_cfg["layers"] * n_pages * heads)


def phase_serving_tier(pa, fa, smi, spec=None):
    """Phase 49: the serving tier over the paged-KV engine (K3 on every
    worker). GPT-3 1.3B at full width and depth from the worker CLI's
    arguments, bf16 KV, engine_config()'s geometry at SERVING_SLOTS slots
    a worker, make_prompts' 8 requests (every other one sampled, T 0.7,
    top-k 8, router-assigned seeds).
    (a) two unified workers and a ``Router`` (streaming dataplane) in this
    thread: both workers get work, the prefix pair lands on one worker, K3
    launches by regime equal ``k3_expected`` over both engines, each
    stream equal to one ``DecodeEngine`` of the same per-worker config fed
    the same requests and the router's params, or parting at a near-tie;
    tokens/s through the router beside the single engine's.
    (b) one prefill and one decode worker (threads of this process), the
    prompts from SERVING_PREFILL_THRESHOLD tokens disaggregated: on the
    ``raw`` wire the streams equal (a)'s (near-ties as above); on the
    ``int8`` wire the KV payload's bytes equal the arithmetic (about half
    of raw's), the first token after each prompt equal (a)'s, at least
    INT8_WIRE_AGREE of the tokens decoded over imported pages equal; the
    isolated handoff's pool pages bit-equal to the export (raw) or within
    half a quantization level (int8; a rolled-scale control must not be);
    export, encode, wire, decode and import seconds per request, bytes per
    prompt token.
    (c) two ``python -m paddle_tpu_torch.serving.worker --device cuda``
    processes against this phase's store; the worker that acks the first
    done is SIGKILLed (grace SERVING_GRACE_S): every request completes once
    (``dispatched`` = requests + ``failover_resubmits``), streams equal
    (a)'s (near-ties as above), each worker's status line on the card
    with nonzero K3 launches and this process's float32 matmul settings.
    ``spec`` (a CPU rehearsal) may name a tiny ``model``."""
    import os
    import signal
    import tempfile
    from pathlib import Path

    from paddle_tpu_torch.inference.engine import DecodeEngine
    from paddle_tpu_torch.runtime import TCPStore
    from paddle_tpu_torch.serving import EngineWorker, Router
    from paddle_tpu_torch.serving import transport as transport_mod
    from paddle_tpu_torch.serving import worker as worker_mod

    spec = dict(spec or {})
    model_cfg = spec.get("model", SERVING_MODEL)
    argv = serving_argv(model_cfg)
    t_phase = time.perf_counter()
    model = worker_mod.build_worker_model(
        worker_mod.build_arg_parser().parse_args(argv))
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    sync()
    prompts = make_prompts(model.config.vocab_size)
    cfg = serving_engine_config()
    store = TCPStore("127.0.0.1", 0, is_master=True, timeout=120.0)
    out = {"card": smi, "model": dict(model_cfg), "slots": SERVING_SLOTS,
           "kv_dtype": "bf16"}
    names = ("router", "reference")

    # -- 49a ----------------------------------------------------------------
    workers = [EngineWorker(model, store, namespace="p49a", **cfg)
               for _ in range(2)]
    for w in workers:
        w.engine.warmup()
    router = Router(store, namespace="p49a", queue_limit=64, seed=SEED,
                    page_size=cfg["page_size"])
    steps = {}
    for w in workers:
        timed_method(w.engine, "step", steps)
    reset_k3(pa)
    rids = submit_serving(router, prompts)
    wall = drive_router(router, workers)
    step_s = sum(t for t, _ in steps[None])
    k3a = check_k3(pa, workers, "49a")
    st = router.stats()
    placed = [router._requests[r].engine for r in rids]
    if set(placed) != {w.name for w in workers}:
        raise AssertionError(f"49a: one worker got no work: {placed}")
    if placed[4] != placed[5]:
        raise AssertionError("49a: the prefix pair landed on two workers")
    if st["done"] != len(prompts) or st["affinity_hits"] < 1:
        raise AssertionError(f"49a: {st}")
    streams = [router.result(r) for r in rids]
    params = [router._requests[r].params for r in rids]
    tokens = sum(w.engine.stats()["total_tokens"] for w in workers)
    hits = sum(w.engine.stats()["prefix_hit_tokens"] for w in workers)
    single = DecodeEngine(model, **cfg)
    single.warmup()
    t0 = time.perf_counter()
    srids = [single.submit(p, prm) for p, prm in zip(prompts, params)]
    single.run()
    sync()
    single_wall = time.perf_counter() - t0
    reference = [single.result(r) for r in srids]
    single_tokens = single.stats()["total_tokens"]
    parts_a = check_serving_streams(fa, model, prompts, params, streams,
                                    reference, "49a", names)
    out["router_2workers"] = dict(
        wall_s=wall, engine_step_s=step_s, tokens=tokens,
        tokens_per_s=tokens / wall,
        single_engine_tokens_per_s=single_tokens / single_wall,
        single_engine_wall_s=single_wall, placed=placed,
        prefix_hit_tokens=hits, launches=k3a, partings=parts_a,
        equal_streams=sum(np.array_equal(a, b)
                          for a, b in zip(streams, reference)),
        router=st)
    log(f"# phase 49a: 2 workers x {SERVING_SLOTS} slots behind a router: "
        f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s "
        f"(one engine, {SERVING_SLOTS} slots: "
        f"{single_tokens / single_wall:.1f} tok/s); the engines' step() "
        f"{step_s:.3f} s of it; placed {placed}, "
        f"prefix hits {hits} tokens; K3 {k3a}; streams equal to the single "
        f"engine {out['router_2workers']['equal_streams']}/{len(prompts)}, "
        f"near-tie partings {len(parts_a)}  [{smi}]")
    router.shutdown()
    for w in workers:
        w.close()
    del workers, single, router
    free_card()

    # -- 49b ----------------------------------------------------------------
    disagg = [i for i, p in enumerate(prompts)
              if len(p) >= SERVING_PREFILL_THRESHOLD]
    out["disagg"] = {}
    for wire in ("raw", "int8"):
        ns = f"p49b_{wire}"
        clients = [TCPStore("127.0.0.1", store.port, timeout=120.0)
                   for _ in range(2)]
        pw = EngineWorker(model, clients[0], namespace=ns, role="prefill",
                          kv_wire=wire, **cfg)
        dw = EngineWorker(model, clients[1], namespace=ns, role="decode",
                          **cfg)
        for w in (pw, dw):
            w.engine.warmup()
        router = Router(store, namespace=ns, queue_limit=64, seed=SEED,
                        page_size=cfg["page_size"],
                        prefill_threshold_tokens=SERVING_PREFILL_THRESHOLD)
        export_s, import_s = {}, {}
        timed_method(pw.engine, "prefill_export", export_s,
                     lambda p, *a, **kw: len(p))
        timed_method(dw.engine, "try_import_prefill", import_s,
                     lambda p, *a, **kw: len(p))
        reset_k3(pa)
        with disagg_probes(worker_mod, transport_mod, dw) as probes:
            rids = submit_serving(router, prompts)
            wall = drive_router_threaded(router, [pw, dw])
        k3b = check_k3(pa, [pw, dw], f"49b {wire}")
        iso = isolated_handoff(pw, dw, prompts[-1], params[-1], wire)
        st = router.stats()
        if st["done"] != len(prompts) or \
                st["disagg_dispatches"] != len(disagg):
            raise AssertionError(f"49b {wire}: {st}")
        if pw.engine.stats()["decode_steps"] != 0:
            raise AssertionError("49b: the prefill worker decoded")
        got = [router.result(r) for r in rids]
        per_request = []
        for i in disagg:
            t = len(prompts[i])
            n = -(-t // cfg["page_size"])
            pr = probes[n]
            want_bytes = kv_payload_bytes(model_cfg, n, wire)
            if pr["payload_bytes"] != want_bytes:
                raise AssertionError(
                    f"49b {wire}: prompt {t}: KV payload {pr['payload_bytes']}"
                    f" bytes, the arithmetic {want_bytes}")
            exp, payload = export_s[t][0]
            per_request.append(dict(
                prompt_tokens=t, pages=n, payload_bytes=pr["payload_bytes"],
                frame_bytes=pr["frame_bytes"],
                frame_bytes_per_prompt_token=pr["frame_bytes"] / t,
                export_s=exp, prefill_s=payload["prefill_s"],
                encode_s=pr["encode_s"],
                wire_s=pr["recv_wall"] - pr["sent_wall"],
                slot_wait_s=pr["decode_wall"] - pr["recv_wall"],
                decode_s=pr["decode_s"], import_s=import_s[t][0][0]))
        res = dict(wall_s=wall, launches=k3b, requests=per_request,
                   router=st, isolated=iso)
        if st["engines_lost"]:
            raise AssertionError(f"49b {wire}: a worker was lost: {st}")
        if wire == "raw":
            res["partings"] = check_serving_streams(
                fa, model, prompts, params, got, streams, "49b raw",
                ("disaggregated", "49a"))
        else:
            agree = total = agree_gen = total_gen = agree_w = total_w = 0
            for i in range(len(prompts)):
                a, b, t = np.asarray(got[i]), np.asarray(streams[i]), \
                    len(prompts[i])
                if a.shape != b.shape:
                    raise AssertionError("49b int8: a stream's length")
                if i in disagg and a[t] != b[t]:
                    raise AssertionError(
                        f"49b int8: request {i}'s first token {a[t]} != "
                        f"{b[t]} (computed before the wire)")
                agree += int((a == b).sum())
                total += a.size
                agree_gen += int((a[t:] == b[t:]).sum())
                total_gen += a.size - t
                if i in disagg:
                    agree_w += int((a[t:] == b[t:]).sum())
                    total_w += a.size - t
            res.update(agreement=agree / total,
                       generated_agreement=agree_gen / total_gen,
                       wire_generated_agreement=agree_w / total_w)
            if not res["wire_generated_agreement"] >= INT8_WIRE_AGREE:
                raise AssertionError(f"49b int8: agreement {res}")
        out["disagg"][wire] = res
        mean = {k: float(np.mean([r[k] for r in per_request]))
                for k in ("export_s", "prefill_s", "encode_s", "wire_s",
                          "slot_wait_s", "decode_s", "import_s",
                          "frame_bytes_per_prompt_token")}
        log(f"# phase 49b {wire}: prefill + decode worker, "
            f"{len(disagg)} of {len(prompts)} disaggregated, {wall:.3f} s; "
            f"per request mean: export {1e3 * mean['export_s']:.1f} ms "
            f"(its prefill {1e3 * mean['prefill_s']:.1f} ms), "
            f"encode {1e3 * mean['encode_s']:.1f} ms, stamp to receipt "
            f"{1e3 * mean['wire_s']:.1f} ms, receipt to a decode slot "
            f"{1e3 * mean['slot_wait_s']:.1f} ms, decode "
            f"{1e3 * mean['decode_s']:.1f} ms, import "
            f"{1e3 * mean['import_s']:.1f} ms; "
            f"{mean['frame_bytes_per_prompt_token']:.0f} frame bytes a prompt "
            f"token; K3 {k3b}; "
            + (f"near-tie partings {len(res['partings'])}" if wire == "raw"
               else f"agreement {res['agreement']:.4f} (generated "
                    f"{res['generated_agreement']:.4f}, generated over "
                    f"imported pages {res['wire_generated_agreement']:.4f}"
                    f")") + f"  [{smi}]")
        log(f"# phase 49b {wire}: the {len(prompts[-1])}-token prompt's "
            f"handoff alone: export {1e3 * iso['export_s']:.1f} ms (prefill "
            f"{1e3 * iso['prefill_s']:.1f}), encode "
            f"{1e3 * iso['encode_s']:.1f} ms, pickle "
            f"{1e3 * iso['pickle_s']:.1f} ms, socket "
            f"{1e3 * iso['socket_s']:.1f} ms ({iso['frame_bytes']} bytes), "
            f"decode {1e3 * iso['decode_s']:.1f} ms, import "
            f"{1e3 * iso['import_s']:.1f} ms; "
            f"{iso['bytes_per_prompt_token']:.0f} bytes a prompt token; "
            + ("pool pages bit-equal to the export" if wire == "raw" else
               f"pool pages within {iso['wire_excess_k']:.4f} / "
               f"{iso['wire_excess_v']:.4f} of the bound (k / v; rolled-"
               f"scale control {iso['control_excess_k']:.1f} / "
               f"{iso['control_excess_v']:.1f})") + f"  [{smi}]")
        router.shutdown()
        for w in (pw, dw):
            w.close()
        for c in clients:
            c.close()
        del pw, dw, router, clients
    raw_b = sum(r["frame_bytes"] for r in out["disagg"]["raw"]["requests"])
    int8_b = sum(r["frame_bytes"] for r in out["disagg"]["int8"]["requests"])
    out["disagg"]["int8_over_raw_bytes"] = int8_b / raw_b
    log(f"# phase 49b: int8 frames {int8_b} bytes vs raw {raw_b} "
        f"({int8_b / raw_b:.4f})")
    if not int8_b / raw_b < 0.6:
        raise AssertionError("49b: the int8 wire is not about half of raw")
    free_card()

    # -- 49c ----------------------------------------------------------------
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serving_"))
    env = dict(os.environ, PYTHONPATH=str(root))
    env.pop("PADDLE_TPU_TELEMETRY_DIR", None)
    prep = spec.get("worker_env")
    if prep:
        env.update(prep)
    procs, logs = {}, {}
    t_start = time.perf_counter()
    for name in ("w0", "w1"):
        logs[name] = open(tmp / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
             "--master", f"127.0.0.1:{store.port}", "--namespace", "p49c",
             "--name", name, *argv], cwd=root, env=env,
            stdout=subprocess.DEVNULL, stderr=logs[name])

    def alive():
        for n, p in procs.items():
            if p.poll() is not None and n != victim:
                raise AssertionError(
                    f"49c: worker {n} exited {p.returncode}: "
                    + (tmp / f"{n}.log").read_text()[-3000:])

    def lines(n):
        # whole lines only: the worker may be writing one as we read
        return [json.loads(x)["serving_worker"]
                for x in (tmp / f"{n}.log").read_text().splitlines(True)
                if x.startswith('{"serving_worker"') and x.endswith("\n")]

    victim = None
    try:
        router = Router(store, namespace="p49c", queue_limit=64, seed=SEED,
                        page_size=cfg["page_size"], engine_grace_s=120.0)
        while router.stats()["engines_alive"] < 2 or any(
                e.beat < 1 for e in router._engines.values()):
            alive()
            router.pump()
            time.sleep(0.01)
            if time.perf_counter() - t_start > 300:
                raise AssertionError("49c: workers did not register")
        ready_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        rids = submit_serving(router, prompts)
        while router.pending():
            alive()
            router.pump()
            if victim is None:
                done = [router._requests[r].engine for r in rids
                        if router.status(r) == "done"]
                if done:
                    victim = done[0]
                    while not lines(victim):
                        alive()
                        time.sleep(0.01)
                    procs[victim].send_signal(signal.SIGKILL)
                    procs[victim].wait(30)
                    kill_s = time.perf_counter() - t0
                    router.config.engine_grace_s = SERVING_GRACE_S
            time.sleep(0.001)
            if time.perf_counter() - t0 > 600:
                raise AssertionError(f"49c undrained: {router.stats()}")
        wall = time.perf_counter() - t0
        st = router.stats()
        router.shutdown()
        survivor = next(n for n in procs if n != victim)
        if procs[survivor].wait(120) != 0:
            raise AssertionError("49c: the survivor exited "
                                 f"{procs[survivor].returncode}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for f in logs.values():
            f.close()
    if not (st["done"] == len(prompts) and st["failed"] == 0
            and st["engines_lost"] == 1 and st["failover_resubmits"] >= 1
            and st["dispatched"] == len(prompts) + st["failover_resubmits"]):
        raise AssertionError(f"49c: not every request exactly once: {st}")
    got = [router.result(r) for r in rids]
    parts_c = check_serving_streams(fa, model, prompts, params, got, streams,
                                    "49c", ("worker processes", "49a"))
    records = {}
    for n in procs:
        recs = lines(n)
        want = ["first_done"] if n == victim else ["first_done", "stop"]
        if [r["event"] for r in recs] != want:
            raise AssertionError(f"49c: worker {n} printed {recs}")
        rec = recs[-1]
        if rec["device_type"] != DEVICE or (
                DEVICE == "cuda" and rec["k3"]["launches"] <= 0):
            raise AssertionError(f"49c: worker {n}: {rec}")
        if (rec["allow_tf32"], rec["float32_matmul_precision"]) != (
                torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision()):
            raise AssertionError(f"49c: worker {n}'s float32 matmul "
                                 f"settings differ from this process's")
        records[n] = rec
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    out["processes"] = dict(
        ready_s=ready_s, wall_s=wall, kill_after_s=kill_s, victim=victim,
        router=st, partings=parts_c, workers=records,
        equal_streams=sum(np.array_equal(a, b)
                          for a, b in zip(got, streams)))
    log(f"# phase 49c: 2 worker processes ready in {ready_s:.1f} s; "
        f"{victim} SIGKILLed {kill_s:.3f} s in after its first done; "
        f"{st['done']} done, {st['failover_resubmits']} resubmitted, "
        f"{st['dispatched']} dispatched in {wall:.3f} s; streams equal to "
        f"49a {out['processes']['equal_streams']}/{len(prompts)}; workers: "
        + "; ".join(f"{n} {r['device']} K3 {r['k3']['launches']} "
                    f"({r['event']})" for n, r in records.items())
        + f"  [{smi}]")
    store.close()
    del model
    free_card()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 49: {out['seconds']:.1f} s")
    return out


# -- phase 50: the MPMD pipeline -----------------------------------------------

MPMD_LAYERS = 4
MPMD_BATCH, MPMD_SEQ = 8, 1024
MPMD_MICROBATCHES = 4
MPMD_STEPS = 3
# losses against the fold: the reference's own gate between its MPMD and
# SPMD paths (tests/test_mpmd.py: the same sums, reassociated)
MPMD_LOSS_RTOL = 1e-5


def build_mpmd(spec):
    """Phase 50's stack: MPMD_LAYERS GPT-3 1.3B decoder blocks (a
    rehearsal's tiny ``spec["model"]`` instead) in a 2-stage
    ``SpmdPipeline`` (unpipelined: every block here), and a final
    LayerNorm + untied ``Linear(hidden, vocab)`` head, f32, from SEED."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import SpmdPipeline
    from paddle_tpu_torch.text.models.gpt import (GPTConfig,
                                                  GPTDecoderLayer, _init_kw)

    device = torch.device(spec["device"])
    cfg = (GPTConfig(**spec["model"]) if spec.get("model") else
           GPTConfig.gpt3_1p3b(num_hidden_layers=MPMD_LAYERS,
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0))
    gen = torch.Generator(device=device).manual_seed(SEED)
    kw = _init_kw(cfg, device, gen, torch.float32)
    pipe = SpmdPipeline([GPTDecoderLayer(cfg, **kw)
                         for _ in range(cfg.num_hidden_layers)],
                        num_stages=2, num_microbatches=MPMD_MICROBATCHES,
                        num_virtual_stages=1)
    head = nn.Sequential(
        nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon, device=device),
        nn.Linear(cfg.hidden_size, cfg.vocab_size, bias_attr=False,
                  device=device, generator=gen,
                  init_std=cfg.initializer_range))
    return cfg, pipe, head


def mpmd_expected(mp, rows, steps):
    """K1 / K2a / K2b launches of ``steps`` MPMD steps: per micro-batch,
    each layer of a stage launches once per row chunk (its width when the
    width divides the ``rows`` of a micro-batch, else 1), K1 twice on a
    stage that is not the last (``bwd`` recomputes its forward)."""
    k1 = k2 = 0
    for st in mp.stages:
        chunks = st.dp if rows % st.dp == 0 else 1
        last = st.stage_id == mp.num_stages - 1
        k1 += chunks * len(st.blocks) * (1 if last else 2)
        k2 += chunks * len(st.blocks)
    n = steps * mp.num_microbatches
    return {"fwd": n * k1, "dq": n * k2, "dkv": n * k2}


def phase_mpmd(fa, smi, spec=None):
    """Phase 50: the MPMD pipeline (``distributed.mpmd``) at GPT-3 1.3B's
    widths: MPMD_LAYERS decoder blocks of an ``SpmdPipeline`` under a final
    LayerNorm and an untied ``Linear(2048, 50304)`` head with cross entropy,
    on hidden states [MPMD_BATCH, MPMD_SEQ, 2048] from the seed, 2 stages,
    M = MPMD_MICROBATCHES, MPMD_STEPS steps of phase 7's AdamW and clip,
    each run from the same initial weights: the unpipelined fold (the
    reference gate's counterpart); 1F1B over a local boundary (shard
    checkpoint after step 1); 1F1B over a TCP boundary on the ``raw`` wire;
    gpipe; widths (2, 1) on a device list that repeats the card (stage 0
    splits each micro-batch's rows), then ``resize_stage(1, 2)`` and one
    more step; the shards restored into fresh state for steps 2-3. Gates:
    losses within MPMD_LOSS_RTOL of the fold's at every step; local and TCP
    bit-equal in losses and parameters; the restored steps bit-equal to the
    uninterrupted ones; the resize leaves stage 0's build count; K1 / K2a /
    K2b launches equal ``mpmd_expected``. Reports each run's parameters'
    max |d| against the fold, step ms and boundary bytes a step."""
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed.mpmd import MpmdPipeline
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    spec = dict(spec or {"device": DEVICE})
    device = torch.device(spec["device"])
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    cfg, pipe, head = build_mpmd(spec)
    vocab, hidden = cfg.vocab_size, cfg.hidden_size
    batch, seq = spec.get("batch", (MPMD_BATCH, MPMD_SEQ))
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    x = torch.randn((batch, seq, hidden), generator=gen, device=device)
    labels = torch.randint(0, vocab, (batch, seq), generator=gen,
                           device=device)
    rows = batch // MPMD_MICROBATCHES
    params = list(pipe.parameters()) + list(head.parameters())
    init = [p.detach().clone() for p in params]

    def loss_fn(h, y):
        return F.cross_entropy(h.reshape(-1, vocab), y.reshape(-1))

    def fresh():
        with torch.no_grad():
            for p, v in zip(params, init):
                p.copy_(v)
                p.grad = None
        return AdamW(parameters=params, grad_clip=ClipGradByGlobalNorm(1.0),
                     **ADAMW)

    def fold_step():
        loss = loss_fn(head(pipe(x)), labels)
        loss.backward()
        return float(loss.detach())

    def run(name, opt, step, steps=MPMD_STEPS, after=None):
        reset_flash(fa)
        losses, step_ms = [], []
        for i in range(steps):
            sync()
            t0 = time.perf_counter()
            losses.append(step())
            opt.step()
            opt.clear_grad()
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if after is not None:
                after(i)
        launches = {k: getattr(fa, f"launches_{k}")
                    for k in ("fwd", "dq", "dkv")}
        return dict(name=name, losses=losses, step_ms=step_ms,
                    launches=launches)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mpmd_")
    out = {"card": smi, "layers": cfg.num_hidden_layers,
           "batch": [batch, seq, hidden],
           "microbatches": MPMD_MICROBATCHES, "steps": MPMD_STEPS}
    try:
        fold = run("fold", fresh(), fold_step)
        fold["expected"] = {k: MPMD_STEPS * cfg.num_hidden_layers
                            for k in ("fwd", "dq", "dkv")}
        fold_params = [p.detach().clone() for p in params]
        runs = [fold]
        kept = {}
        for name, kw in (
                ("1f1b_local", dict(schedule="1f1b", transport="local")),
                ("1f1b_tcp_raw", dict(schedule="1f1b", transport="tcp")),
                ("gpipe_local", dict(schedule="gpipe", transport="local")),
                ("widths_2_1", dict(schedule="1f1b", transport="local",
                                    widths=[2, 1]))):
            widths = kw.pop("widths", [1, 1])
            opt = fresh()
            mp = MpmdPipeline(pipe, widths, head=head, loss_fn=loss_fn,
                              num_microbatches=MPMD_MICROBATCHES, wire="raw",
                              devices=[device] * sum(widths), **kw)
            save = None
            if name == "1f1b_local":
                def save(i, mp=mp, opt=opt):
                    if i == 0:
                        mp.save_shards(tmp, opt)
            r = run(name, opt, lambda mp=mp: mp.train_batch(x, labels),
                    after=save)
            r["expected"] = mpmd_expected(mp, rows, MPMD_STEPS)
            r["boundary_bytes_per_step"] = mp.boundary_bytes() / MPMD_STEPS
            r["compile_counts"] = mp.compile_counts()
            r["param_max"] = max((p.detach() - q).abs().max().item()
                                 for p, q in zip(params, fold_params))
            if name in ("1f1b_local", "1f1b_tcp_raw"):
                kept[name] = [p.detach().clone() for p in params]
            if name == "widths_2_1":
                # a stage-local resize: stage 1 to width 2 on the card
                before = mp.compile_counts()
                mp.resize_stage(1, 2, devices=[device, device])
                mp.train_batch(x, labels)
                opt.clear_grad()
                after = mp.compile_counts()
                r["resize"] = dict(before=before, after=after)
                if after[0] != before[0] or not after[1] > before[1]:
                    raise AssertionError(f"50: resize_stage(1) moved the "
                                         f"build counts {before} -> {after}")
            mp.close()
            runs.append(r)
        # the shards of 1f1b_local's step 1, restored into fresh state
        opt = fresh()
        mp = MpmdPipeline(pipe, [1, 1], head=head, loss_fn=loss_fn,
                          num_microbatches=MPMD_MICROBATCHES, wire="raw",
                          devices=[device] * 2)
        t0 = time.perf_counter()
        restored_at = mp.restore_shards(tmp, opt)
        restore_s = time.perf_counter() - t0
        r = run("restored", opt, lambda: mp.train_batch(x, labels),
                steps=MPMD_STEPS - 1)
        r.update(restored_at=restored_at, restore_s=restore_s,
                 expected=mpmd_expected(mp, rows, MPMD_STEPS - 1),
                 param_max=max((p.detach() - q).abs().max().item()
                               for p, q in zip(params, fold_params)))
        restored_equal = all(torch.equal(p.detach(), q) for p, q in
                             zip(params, kept["1f1b_local"]))
        tcp_equal = all(torch.equal(a, b) for a, b in
                        zip(kept["1f1b_local"], kept["1f1b_tcp_raw"]))
        mp.close()
        runs.append(r)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by = {r["name"]: r for r in runs}
    for r in runs:
        want = fold["losses"][-len(r["losses"]):]
        r["rel"] = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], want))
        log(f"# phase 50 {r['name']}: losses {r['losses']} (fold "
            f"{want}, rel {r['rel']:.2e}); params max |d| vs the fold "
            f"{r.get('param_max', 0.0):.2e}; step ms "
            f"{[round(t, 1) for t in r['step_ms']]}; boundary bytes a step "
            f"{r.get('boundary_bytes_per_step', 0)}; launches "
            f"{r['launches']} (expected {r['expected']})  [{smi}]")
    log(f"# phase 50: 1F1B local vs TCP raw: losses equal "
        f"{by['1f1b_local']['losses'] == by['1f1b_tcp_raw']['losses']}, "
        f"parameters equal {tcp_equal}; restored at step "
        f"{by['restored']['restored_at']} in "
        f"{by['restored']['restore_s']:.2f} s: losses equal "
        f"{by['restored']['losses'] == by['1f1b_local']['losses'][1:]}, "
        f"parameters equal {restored_equal}; resize "
        f"{by['widths_2_1']['resize']}  [{smi}]")
    for r in runs:
        if not r["rel"] <= MPMD_LOSS_RTOL:
            raise AssertionError(f"50 {r['name']}: losses differ from the "
                                 f"fold's (rel {r['rel']})")
        if r["launches"] != r["expected"]:
            raise AssertionError(f"50 {r['name']}: launches "
                                 f"{r['launches']} != {r['expected']}")
    if by["1f1b_local"]["losses"] != by["1f1b_tcp_raw"]["losses"] \
            or not tcp_equal:
        raise AssertionError("50: the TCP raw wire is not bit-equal to the "
                             "local boundary")
    if by["restored"]["restored_at"] != 1 or not restored_equal or \
            by["restored"]["losses"] != by["1f1b_local"]["losses"][1:]:
        raise AssertionError("50: the restored run is not bit-equal to the "
                             "uninterrupted one")
    out["runs"] = {r["name"]: {k: v for k, v in r.items() if k != "name"}
                   for r in runs}
    del pipe, head, params, init, fold_params, kept
    if on_card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 50: {out['seconds']:.1f} s")
    return out


# -- phase 51: the launcher and elastic resume ---------------------------------

ELASTIC_LAYERS = 2
# 3 steps (4 until phase 56 needed the room)
ELASTIC_STEPS = 3
# the killed run saves every ELASTIC_SAVE_INTERVAL steps (step 1: 2.5 GB);
# the clean run, the bit-equal yardstick, saves nothing
ELASTIC_SAVE_INTERVAL = 2
# rank 1 is SIGKILLed by chaos.step_fence at this step of launch attempt 0;
# the newest committed checkpoint is then step 1's, so the ranks resume at
# step 2 (the reference's rule: the step after the newest committed save)
ELASTIC_KILL_STEP = 2
ELASTIC_RESUME_AT = 2


def elastic_worker(spec_path):
    """One rank of phase 51, run by the launcher as ``chip_smoke.py
    --elastic-worker <spec.json>``: GPT-3 1.3B's widths at ELASTIC_LAYERS
    (a rehearsal's tiny ``model``), dp 2 over gloo through ``fleet``,
    phase 7's AdamW and clip, ``ElasticManager(save_interval=
    spec["save_interval"])`` resuming, ``chaos.step_fence`` on rank 1
    before each step; every event appended to ``log<rank>.jsonl``, the end
    in ``done<rank>.json`` (losses, each parameter's sha1, launches, the
    watchdog's beats and stalls)."""
    import hashlib
    import importlib
    import os

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import saved_bytes
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.runtime import watchdog
    from paddle_tpu_torch.testing import chaos

    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("prepare"):
        mod, fn = spec["prepare"].split(":")
        getattr(importlib.import_module(mod), fn)()
    work = spec["work"]
    attempt = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    on_card = spec["device"] == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def note(**kw):
        with open(os.path.join(work, f"log{rank}.jsonl"), "a") as f:
            f.write(json.dumps(dict(kw, t=time.time(), attempt=attempt))
                    + "\n")

    note(event="start")
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    fleet_init(dp_degree=2)
    if spec.get("model"):
        from paddle_tpu_torch.text.models.gpt import (GPTConfig,
                                                      GPTForCausalLM)

        model = GPTForCausalLM(GPTConfig(**spec["model"]),
                               device=spec["device"], seed=SEED)
    else:
        model = build_model(ELASTIC_LAYERS)
    step, opt = dist_trainer(model)
    ids, labels = train_batch(model.config.vocab_size)
    mgr = ElasticManager(os.path.join(work, "ckpt"),
                         save_interval=spec["save_interval"], max_to_keep=1)
    t0 = time.perf_counter()
    start = mgr.resume(model, opt)
    sync()
    resume_s = time.perf_counter() - t0
    note(event="resumed", start=start, seconds=resume_s,
         bytes=(saved_bytes(os.path.join(mgr.ckpt_dir, f"step_{start - 1}"))
                if start else 0))
    reset_flash(fa)
    losses = []
    for s in range(start, spec["steps"]):
        if rank == 1:
            chaos.step_fence(s)
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))
        sync()
        note(event="step", step=s, loss=losses[-1],
             seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        if mgr.maybe_save(s, model, opt):
            path = os.path.join(mgr.ckpt_dir, f"step_{s}")
            note(event="save", step=s, seconds=time.perf_counter() - t0,
                 bytes=saved_bytes(path, 0))
    launches = {k: getattr(fa, f"launches_{k}") for k in ("fwd", "dq", "dkv")}
    sha = {n: hashlib.sha1(p.detach().cpu().numpy().tobytes()).hexdigest()
           for n, p in model.named_parameters()}
    wd = watchdog.active()
    with open(os.path.join(work, f"done{rank}.json"), "w") as f:
        json.dump(dict(attempt=attempt, start=start, losses=losses,
                       sha=sha, launches=launches,
                       heads=model.gpt.decoder[0].attn.num_heads,
                       watchdog_beats=wd.beats if wd else 0,
                       stalled=wd.stalled if wd else None,
                       peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                                 if on_card else 0.0)), f)
    dist.destroy_process_group()


def phase_launch_elastic(smi, spec=None, timeout=900):
    """Phase 51: ``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node 2 --max_restarts 1 --heartbeat_interval 1`` runs
    ``elastic_worker`` (this script) twice on two gloo ranks that share the
    card, ELASTIC_STEPS steps: once clean (no checkpoint), once saving
    every ELASTIC_SAVE_INTERVAL steps with
    ``PADDLE_CHAOS_KILL_STEP=ELASTIC_KILL_STEP`` killing rank 1 on launch
    attempt 0. Gates: both launches exit 0; the faulty one relaunches once,
    its ranks (attempt 1) resume at ELASTIC_RESUME_AT; its final losses and
    every parameter (sha1) equal the clean run's; the watchdog beat on both
    ranks of both runs and declared no stall; K1 / K2a / K2b launches a
    rank equal layers x the steps it ran. Reports each save's and resume's
    seconds and bytes and the time from the kill to the relaunched ranks'
    resume."""
    import os
    import shutil
    import subprocess
    import tempfile

    spec = dict(spec or {"device": DEVICE})
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    layers = (spec["model"]["num_hidden_layers"] if spec.get("model")
              else ELASTIC_LAYERS)
    out = {"card": smi, "layers": layers, "steps": ELASTIC_STEPS}
    try:
        results = {}
        for name, interval, chaos_env in (
                ("clean", ELASTIC_STEPS + 1, {}),
                ("killed", ELASTIC_SAVE_INTERVAL,
                 {"PADDLE_CHAOS": "1",
                  "PADDLE_CHAOS_KILL_STEP": str(ELASTIC_KILL_STEP)})):
            work = os.path.join(tmp, name)
            os.makedirs(work)
            spec_path = os.path.join(work, "spec.json")
            with open(spec_path, "w") as f:
                json.dump(dict(spec, work=work, steps=ELASTIC_STEPS,
                               save_interval=interval), f)
            env = dict(os.environ, **chaos_env)
            env["PYTHONPATH"] = os.pathsep.join(
                [here] + [p for p in [os.environ.get("PYTHONPATH")] if p])
            for k in ("PADDLE_MASTER", "PADDLE_TRAINER_ID",
                      "PADDLE_TRAINERS_NUM"):
                env.pop(k, None)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                 "--nproc_per_node", "2", "--max_restarts", "1",
                 "--restart_backoff", "1", "--heartbeat_interval", "1",
                 os.path.join(here, "chip_smoke.py"), "--elastic-worker",
                 spec_path], env=env, cwd=here, capture_output=True,
                text=True, timeout=timeout)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                log(proc.stdout[-4000:])
                log(proc.stderr[-4000:])
                raise AssertionError(f"51 {name}: the launcher exited "
                                     f"{proc.returncode}")
            done = []
            for r in range(2):
                with open(os.path.join(work, f"done{r}.json")) as f:
                    done.append(json.load(f))
            events = []
            for r in range(2):
                with open(os.path.join(work, f"log{r}.jsonl")) as f:
                    events += [dict(json.loads(line), rank=r) for line in f]
            results[name] = dict(done=done, events=events, wall=wall,
                                 relaunched="relaunching (1/1)" in
                                 proc.stderr)
        clean, killed = results["clean"], results["killed"]
        for name, res in results.items():
            saves = [e for e in res["events"] if e["event"] == "save"
                     and e["rank"] == 0]
            resumes = [e for e in res["events"] if e["event"] == "resumed"]
            res["saves"] = [dict(step=e["step"], seconds=e["seconds"],
                                 bytes=e["bytes"]) for e in saves]
            res["resumes"] = [dict(rank=e["rank"], attempt=e["attempt"],
                                   start=e["start"], seconds=e["seconds"],
                                   bytes=e["bytes"]) for e in resumes]
            res["step_s"] = [e["seconds"] for e in res["events"]
                             if e["event"] == "step" and e["rank"] == 0]
        # the kill: rank 1's last event of attempt 0, then the resume of the
        # relaunched rank 1
        last0 = max(e["t"] for e in killed["events"]
                    if e["rank"] == 1 and e["attempt"] == 0)
        resumed1 = min(e["t"] for e in killed["events"]
                       if e["event"] == "resumed" and e["attempt"] == 1)
        relaunch_s = resumed1 - last0
        for name, res in results.items():
            d0, d1 = res["done"]
            log(f"# phase 51 {name}: launcher {res['wall']:.1f} s, relaunched "
                f"{res['relaunched']}; attempt {d0['attempt']} resumed at "
                f"step {d0['start']} / {d1['start']}; losses rank 0 "
                f"{d0['losses']}; step s rank 0 "
                f"{[round(t, 3) for t in res['step_s']]}; saves "
                f"{res['saves']}; resumes "
                f"{res['resumes']}; launches {d0['launches']} / "
                f"{d1['launches']} at H={d0['heads']}; watchdog beats "
                f"{d0['watchdog_beats']} / {d1['watchdog_beats']}, stalled "
                f"{d0['stalled']} / {d1['stalled']}; peak "
                f"{d0['peak_gib']:.2f} GiB  [{smi}]")
        log(f"# phase 51: the kill of rank 1 at step {ELASTIC_KILL_STEP} "
            f"to the relaunched rank's resume: {relaunch_s:.2f} s; final "
            f"loss {killed['done'][0]['losses'][-1]} vs clean "
            f"{clean['done'][0]['losses'][-1]}  [{smi}]")
        if not killed["relaunched"] or clean["relaunched"]:
            raise AssertionError("51: the killed launch did not relaunch "
                                 "once, or the clean one did")
        for res, start, attempt in ((clean, 0, 0),
                                    (killed, ELASTIC_RESUME_AT, 1)):
            for d in res["done"]:
                if (d["attempt"], d["start"]) != (attempt, start):
                    raise AssertionError(f"51: a rank ended on attempt "
                                         f"{d['attempt']} from step "
                                         f"{d['start']}")
                if d["watchdog_beats"] <= 0 or d["stalled"]:
                    raise AssertionError(f"51: watchdog {d}")
                want = (ELASTIC_STEPS - start) * layers
                if any(n != want for n in d["launches"].values()):
                    raise AssertionError(f"51: launches {d['launches']} != "
                                         f"{want}")
        for r in range(2):
            k, c = killed["done"][r], clean["done"][r]
            if k["losses"] != c["losses"][ELASTIC_RESUME_AT:]:
                raise AssertionError("51: the resumed losses differ from the "
                                     "clean run's")
            if k["sha"] != c["sha"]:
                raise AssertionError("51: the resumed parameters differ from "
                                     "the clean run's")
        out.update(
            relaunch_s=relaunch_s,
            **{name: dict(wall=res["wall"], saves=res["saves"],
                          resumes=res["resumes"], step_s=res["step_s"],
                          losses=res["done"][0]["losses"],
                          launches=[d["launches"] for d in res["done"]],
                          watchdog_beats=[d["watchdog_beats"]
                                          for d in res["done"]],
                          peak_gib=[d["peak_gib"] for d in res["done"]])
               for name, res in results.items()})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 51: {out['seconds']:.1f} s")
    return out


# -- phase 52: the parameter server's split table ------------------------------

PS_ROWS, PS_DIM = 1 << 20, 128
PS_IDS = (8, 4096)
PS_LR = 0.1


def _rank_table(out_dir, spec):
    """One rank of phase 52 (run by ``paddle.distributed.spawn``): the
    table split over the ``dp`` axis of a global mesh of the two ranks,
    drawn from the parent's seed, the parent's ids and output weights
    (``ref.pt``); forward, backward and one SGD step timed; the output and
    this rank's updated rows held against the parent's unsplit run."""
    import os
    import pickle

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.optimizer import SGD

    device = torch.device(spec["device"])
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if spec.get("prepare"):
        spec["prepare"]()
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    dist.set_global_mesh(dist.ProcessMesh([0, 1], dim_names=["dp"]))
    rows, dim = spec.get("table", (PS_ROWS, PS_DIM))
    gen = torch.Generator(device=device).manual_seed(SEED + 52)
    table = ps.ShardedEmbeddingTable(rows, dim, device=device,
                                     generator=gen)
    ref = torch.load(os.path.join(out_dir, "ref.pt"), mmap=True)
    ids, w_out = ref["ids"].to(device), ref["w_out"].to(device)
    opt = SGD(learning_rate=PS_LR, parameters=table.parameters())
    dist.barrier()
    ms = {}
    sync()
    t0 = time.perf_counter()
    out = table(ids)
    sync()
    ms["forward"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    (out * w_out).sum().backward()
    sync()
    ms["backward"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    opt.step()
    sync()
    ms["step"] = 1e3 * (time.perf_counter() - t0)
    lo, n = table.vocab_start, table.weight.shape[0]
    res = dict(
        rank=rank, lo=lo, rows=n, ms=ms, info=table.shard_info(),
        out_equal=bool(torch.equal(out.detach().cpu(), ref["out"])),
        rows_equal=bool(torch.equal(table.weight.detach().cpu(),
                                    ref["rows"][lo:lo + n])),
        touched=int((table.weight.grad.abs().sum(1) > 0).sum()),
        peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                  if on_card else 0.0))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.set_global_mesh(None)
    dist.destroy_process_group()


def phase_sharded_table(smi, spec=None, timeout=600):
    """Phase 52: a ``ShardedEmbeddingTable`` of PS_ROWS x PS_DIM f32 (512
    MB), first whole on the card in this process, then split over two gloo
    ranks sharing the card (256 MB a rank): PS_IDS ids from numpy, the
    loss ``sum(out * w)``, its backward and one SGD step at PS_LR. Gates:
    each rank's output and updated rows bit-equal to the whole table's.
    Reports forward / backward / step ms whole and a rank."""
    import gc
    import os
    import pickle
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.parallel import join_spawned
    from paddle_tpu_torch.optimizer import SGD

    spec = dict(spec or {"device": DEVICE})
    device = torch.device(spec["device"])
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    rows, dim = spec.get("table", (PS_ROWS, PS_DIM))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ps_")
    try:
        gen = torch.Generator(device=device).manual_seed(SEED + 52)
        table = ps.ShardedEmbeddingTable(rows, dim, device=device,
                                         generator=gen)
        ids = torch.as_tensor(np.random.default_rng(SEED + 52).integers(
            0, rows, spec.get("ids", PS_IDS)), device=device)
        w_out = torch.randn(tuple(ids.shape) + (dim,), generator=gen,
                            device=device)
        opt = SGD(learning_rate=PS_LR, parameters=table.parameters())
        ms = {}
        sync()
        t0 = time.perf_counter()
        out = table(ids)
        sync()
        ms["forward"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        (out * w_out).sum().backward()
        sync()
        ms["backward"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        opt.step()
        sync()
        ms["step"] = 1e3 * (time.perf_counter() - t0)
        unique = int(torch.unique(ids).numel())
        torch.save({"ids": ids.cpu(), "w_out": w_out.cpu(),
                    "out": out.detach().cpu(),
                    "rows": table.weight.detach().cpu()},
                   os.path.join(tmp, "ref.pt"))
        del table, opt, out, w_out, ids
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ctx = dist.spawn(_rank_table, (tmp, spec), nprocs=2, join=False,
                         backend="gloo", master=f"file://{tmp}/rendezvous")
        join_spawned(ctx, timeout)
        secs = time.perf_counter() - t0
        ranks = [pickle.load(open(os.path.join(tmp, f"rank{r}.pkl"), "rb"))
                 for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in ranks:
        log(f"# phase 52 rank {r['rank']}: rows [{r['lo']}, "
            f"{r['lo'] + r['rows']}) of {rows} x {dim}; output equal "
            f"{r['out_equal']}, updated rows equal {r['rows_equal']} "
            f"({r['touched']} rows touched); ms {r['ms']} (whole {ms}); "
            f"peak {r['peak_gib']:.2f} GiB; {r['info']}  [{smi}]")
    if sum(r["touched"] for r in ranks) != unique:
        raise AssertionError(f"52: {unique} distinct ids, but the ranks' "
                             "gradients touch "
                             f"{[r['touched'] for r in ranks]} rows")
    if not all(r["out_equal"] and r["rows_equal"] for r in ranks):
        raise AssertionError("52: the split table differs from the whole "
                             "one")
    out = {"card": smi, "table": [rows, dim], "ids": list(spec.get(
        "ids", PS_IDS)), "unique_ids": unique, "whole_ms": ms,
        "rank_ms": [r["ms"] for r in ranks], "seconds_ranks": secs,
        "peak_gib": [r["peak_gib"] for r in ranks]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 52: {out['seconds']:.1f} s")
    return out


# -- phase 53: the live plane, the fleet supervisor, the planner on the card --

#: the live aggregator's health-file cadence in phase 53 (the router's
#: default is 2 s; the phase runs for seconds)
LIVE_HEALTH_INTERVAL_S = 0.25
#: 53b's supervisor: short hysteresis and cooldown; a backlog of
#: SUPERVISOR_QUEUE_HIGH undispatched requests is pressure (53b's burst
#: leaves BURST - 2 x SERVING_SLOTS of them queued behind one engine);
#: min_speedup -1 approves every growth the planner prices (on one
#: shared card the host-aggregate model predicts a slower step at a
#: wider training side, which 53b prints)
SUPERVISOR = dict(hysteresis_s=0.2, cooldown_s=0.5, min_serving=1,
                  queue_high=2, high_burn=1.0, low_burn=0.5,
                  drain_timeout_s=120.0, min_speedup=-1.0, plan_stages=2)
SUPERVISOR_BURST = 12
SUPERVISOR_TRAIN_STEPS = 2
#: 53c's weak-scaling sweep at the planner's proxy geometry
#: (``planner.ModelConfig()``, 2 sequences a rank): layouts a spawn
CALIB_LAYOUTS = {2: {"dp2": dict(dp=2), "mp2": dict(mp=2),
                     "pp2": dict(pp=2), "sharding2": dict(sharding=2)},
                 4: {"mp2_pp2": dict(mp=2, pp=2),
                     "dp2_sharding2": dict(dp=2, sharding=2)}}
CALIB_WARMUP, CALIB_STEPS = 2, 5


@contextlib.contextmanager
def live_telemetry(tdir, live=True):
    """Telemetry into ``tdir`` (rank 0's files; tenant accounting with
    it) with the live plane on or off, the registry empty before and
    after."""
    import os

    from paddle_tpu_torch import observability as obs

    keys = ("PADDLE_TPU_TELEMETRY_DIR", "PADDLE_TPU_LIVE_TELEMETRY",
            "PADDLE_TRAINER_ID")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ["PADDLE_TPU_TELEMETRY_DIR"] = tdir
    if live:
        os.environ["PADDLE_TPU_LIVE_TELEMETRY"] = "1"
    else:
        os.environ.pop("PADDLE_TPU_LIVE_TELEMETRY", None)
    os.environ.pop("PADDLE_TRAINER_ID", None)
    obs.reset()
    try:
        yield obs
    finally:
        obs.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def counter_total(obs, name):
    m = obs.registry().get(name)
    return 0.0 if m is None else float(sum(m.snapshot()["values"].values()))


def pump_all(router, workers):
    router.pump()
    for w in workers:
        w.poll_once()


def read_json(path):
    import os

    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def phase_live_plane(pa, fa, smi, model, served_tps, tdir):
    """Phase 53a: phase 49a's configuration (two in-process
    ``EngineWorker`` s, SERVING_SLOTS slots and bf16 KV each, behind one
    ``Router``; make_prompts' 8 requests) with the live plane on: each
    worker ships ``tele`` frames of its span tail on the occupancy beat,
    the router's ``LiveAggregator`` ingests them, keeps the SLO windows
    and writes ``fleet_health.json``. Gates: streams equal one engine
    (near-ties only), K3 launches by regime equal ``k3_expected``, every
    shipped payload ingested exactly once (``live_ingest_total`` = the
    shippers' last seq numbers), the health doc's per-class requests =
    the requests done, its burn rates = ``tracing.summarize_dir`` of the
    same span files (p95 within 5 %, the reference test's bound);
    ``fleet_sync`` writes ``fleet_metrics.json``. Reports tokens/s beside
    a run of the same requests with tracing alone and beside 49a's with
    telemetry off."""
    import os

    from paddle_tpu_torch.inference.engine import DecodeEngine
    from paddle_tpu_torch.observability import live, tracing
    from paddle_tpu_torch.runtime import TCPStore
    from paddle_tpu_torch.serving import EngineWorker, Router
    from paddle_tpu_torch.serving.protocol import SLO_OBJECTIVES

    import shutil
    import tempfile

    cfg = serving_engine_config()
    prompts = make_prompts(model.config.vocab_size)
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    store = TCPStore("127.0.0.1", 0, is_master=True, timeout=120.0)
    # the same requests with tracing alone (the plane off): which share of
    # the overhead is the spans', which the plane's
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with live_telemetry(trace_dir):
            os.environ["PADDLE_TPU_LIVE_TELEMETRY"] = "0"
            workers = [EngineWorker(model, store, namespace="p53a0", **cfg)
                       for _ in range(2)]
            for w in workers:
                w.engine.warmup()
            router = Router(store, namespace="p53a0", queue_limit=64,
                            seed=SEED, page_size=cfg["page_size"])
            rids0 = submit_serving(router, prompts)
            wall0 = drive_router(router, workers)
            tokens0 = sum(w.engine.stats()["total_tokens"] for w in workers)
            streams0 = [router.result(r) for r in rids0]
            if router._live_agg is not None or router.stats()["done"] != \
                    len(prompts):
                raise AssertionError(f"53a (tracing only): {router.stats()}")
            router.shutdown()
            for w in workers:
                w.close()
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    with live_telemetry(tdir) as obs:
        workers = [EngineWorker(model, store, namespace="p53a", **cfg)
                   for _ in range(2)]
        for w in workers:
            w.engine.warmup()
        router = Router(store, namespace="p53a", queue_limit=64, seed=SEED,
                        page_size=cfg["page_size"])
        # a window longer than the phase, the health file at a short
        # cadence (the router would build the default one lazily)
        router._live_agg = live.LiveAggregator(
            window_s=600.0, health_interval_s=LIVE_HEALTH_INTERVAL_S)
        reset_k3(pa)
        rids = submit_serving(router, prompts)
        wall = drive_router(router, workers)
        # the last beats: every shipped payload and every request in the
        # health file
        health_path = os.path.join(tdir, "fleet_health.json")
        deadline = time.perf_counter() + 60.0
        while True:
            pump_all(router, workers)
            doc = read_json(health_path)
            shipped = {w.name: (w._live_shipper._seq if w._live_shipper
                                else 0) for w in workers}
            seen = dict(router._live_agg._seen_seq)
            done = sum(c["requests"] for c in (doc or {}).get(
                "classes", {}).values())
            if done >= len(rids) and all(seen.get(n) == s
                                         for n, s in shipped.items()):
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"53a: the health file never covered "
                                     f"the run: {done} requests, shipped "
                                     f"{shipped}, seen {seen}")
            time.sleep(0.02)
        sync()
        ingested = counter_total(obs, "live_ingest_total")
        dups = counter_total(obs, "live_ingest_dup_total")
        writes = counter_total(obs, "live_health_writes_total")
        k3 = check_k3(pa, workers, "53a")
        st = router.stats()
        streams = [router.result(r) for r in rids]
        params = [router._requests[r].params for r in rids]
        tokens = sum(w.engine.stats()["total_tokens"] for w in workers)
        router.shutdown()
        for w in workers:
            w.close()
        fleet_path = obs.fleet_sync()
    store.close()
    single = DecodeEngine(model, **cfg)
    srids = [single.submit(p, prm) for p, prm in zip(prompts, params)]
    single.run()
    reference = [single.result(r) for r in srids]
    del single
    parts = check_serving_streams(fa, model, prompts, params, streams,
                                  reference, "53a", ("router", "reference"))
    parts += check_serving_streams(fa, model, prompts, params, streams0,
                                   reference, "53a (tracing only)",
                                   ("router", "reference"))
    summary = tracing.summarize_dir(tdir, objectives=SLO_OBJECTIVES)
    burn_keys = ("frac_over_target", "burn_rate_latency",
                 "frac_unavailable", "burn_rate_availability")
    reconcile = {}
    for slo, s_ent in summary["classes"].items():
        h_ent = doc["classes"][slo]
        reconcile[slo] = dict(
            requests=(h_ent["requests"], s_ent["requests"]),
            burn={k: (h_ent["objectives"][k], s_ent["objectives"][k])
                  for k in burn_keys},
            p95=(h_ent["latency_seconds"]["p95"],
                 s_ent["latency_seconds"]["p95"]))
    tps, tps0 = tokens / wall, tokens0 / wall0
    log(f"# phase 53a: the live plane over 2 workers x {SERVING_SLOTS} "
        f"slots: {tokens} tokens in {wall:.3f} s = {tps:.1f} tok/s; "
        f"tracing alone {tokens0} in {wall0:.3f} s = {tps0:.1f} tok/s; "
        f"49a, telemetry off: {served_tps:.1f} tok/s (plane "
        f"{tps / served_tps:.3f}x, tracing alone {tps0 / served_tps:.3f}x); "
        f"payloads shipped {shipped}, ingested {ingested:.0f} (duplicates "
        f"dropped {dups:.0f}), health writes {writes:.0f}; health vs "
        f"post-hoc summary {reconcile}; K3 {k3}; streams equal "
        f"{sum(np.array_equal(a, b) for a, b in zip(streams, reference))}"
        f"/{len(prompts)}, near-tie partings {len(parts)}  [{smi}]")
    if st["done"] != len(prompts):
        raise AssertionError(f"53a: {st}")
    if ingested != sum(shipped.values()) or not ingested > 0:
        raise AssertionError(f"53a: ingested {ingested} payloads, shipped "
                             f"{shipped}")
    if set(summary["classes"]) != set(doc["classes"]) or \
            summary["requests"] != len(rids):
        raise AssertionError(f"53a: classes {sorted(doc['classes'])} vs "
                             f"{sorted(summary['classes'])}")
    for slo, r in reconcile.items():
        if r["requests"][0] != r["requests"][1] or \
                doc["classes"][slo]["admitted"] != r["requests"][0]:
            raise AssertionError(f"53a: {slo} request counts {r}")
        for k, (h, p) in r["burn"].items():
            if not abs(h - p) <= 1e-9 * max(abs(p), 1.0):
                raise AssertionError(f"53a: {slo} {k} live {h} vs "
                                     f"post-hoc {p}")
        if not abs(r["p95"][0] - r["p95"][1]) <= 0.05 * r["p95"][1]:
            raise AssertionError(f"53a: {slo} p95 {r['p95']}")
    if not (fleet_path and os.path.exists(fleet_path)
            and os.path.exists(os.path.join(tdir,
                                            "fleet_trace_summary.json"))):
        raise AssertionError("53a: fleet_sync wrote no fleet_metrics.json")
    return dict(tokens=tokens, wall_s=wall, tokens_per_s=tps,
                tracing_only_tokens_per_s=tps0, tracing_only_wall_s=wall0,
                telemetry_off_tokens_per_s=served_tps, shipped=shipped,
                ingested=ingested, duplicates=dups, health_writes=writes,
                reconcile=reconcile, launches=k3, partings=parts,
                router=st)


def mpmd_loss_fn(vocab):
    from paddle_tpu_torch.nn import functional as F

    def loss_fn(h, y):
        return F.cross_entropy(h.reshape(-1, vocab), y.reshape(-1))
    return loss_fn


def stage_widths(width, stages):
    """The planner's stage widths for a training side of ``width`` cards,
    as the supervisor prices it (``FleetSupervisor.price``)."""
    from paddle_tpu_torch.distributed.auto_parallel import planner

    return list(planner.plan_mpmd_stages(
        topology=planner.Topology(n_devices=width),
        num_stages=max(1, min(stages, width))).best.widths)


def mpmd_model_config(batch, seq):
    """The planner's ``ModelConfig`` of phase 50's model."""
    from paddle_tpu_torch.distributed.auto_parallel import planner

    return planner.ModelConfig(hidden=2048, layers=MPMD_LAYERS, heads=16,
                               vocab=50304, seq_len=seq, global_batch=batch)


def phase_supervisor(pa, fa, smi, model, tdir, spec):
    """Phase 53b: the fleet supervisor flips workers between serving and
    MPMD training on the live plane's own ``fleet_health.json``.
    Four ``EngineWorker`` s of the serving model: p53b-0 and p53b-1 serve,
    p53b-2 and p53b-3 start in the training role (drain orders held), so
    the training side's width is 2: phase 50's stack (MPMD_LAYERS GPT-3
    1.3B blocks and the 50304-way head, MPMD_BATCH x MPMD_SEQ, 2 stages,
    M = MPMD_MICROBATCHES, AdamW) as an ``MpmdPipeline`` whose stage widths
    follow the planner's ``best.widths`` for the journaled width
    (``resize_stage``). A ``StoreFleetExecutor`` drains, evacuates and
    resizes; SUPERVISOR sets the loop. The run: the training side takes
    SUPERVISOR_TRAIN_STEPS steps; the 8 requests of make_prompts served
    by two engines leave headroom in the health file and the supervisor
    flips p53b-1 to training (width 3, the training side's steps again);
    ``min_serving`` 1 then holds the next flip; a burst of
    SUPERVISOR_BURST requests behind one engine is a backlog and the
    supervisor flips p53b-1 back (width 2, the steps again). Gates: every
    request done exactly once, streams equal one engine (near-ties
    only); the MPMD losses within MPMD_LOSS_RTOL of the unflipped fold of
    the same steps; the journal ends with no pending flip and 2 committed,
    each with its price; K1 / K2a / K2b launches = ``mpmd_expected`` at
    each width; K3 launches = ``k3_expected`` summed over the workers.
    Reports each flip's fence seconds and the planner's predicted step
    at both widths beside the MPMD step measured at them."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed.auto_parallel import planner
    from paddle_tpu_torch.distributed.fleet.supervisor import (
        FleetSupervisor, StoreFleetExecutor, SupervisorConfig)
    from paddle_tpu_torch.distributed.mpmd import MpmdPipeline
    from paddle_tpu_torch.inference.engine import DecodeEngine
    from paddle_tpu_torch.observability import live
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.runtime import TCPStore
    from paddle_tpu_torch.serving import EngineWorker, Router

    device = torch.device(spec["device"])
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = serving_engine_config()
    prompts = make_prompts(model.config.vocab_size)
    burst = (prompts + prompts)[:SUPERVISOR_BURST]
    mcfg, pipe, head = build_mpmd(spec)
    vocab = mcfg.vocab_size
    batch, seq = spec.get("batch", (MPMD_BATCH, MPMD_SEQ))
    gen = torch.Generator(device=device).manual_seed(SEED + 53)
    x = torch.randn((batch, seq, mcfg.hidden_size), generator=gen,
                    device=device)
    labels = torch.randint(0, vocab, (batch, seq), generator=gen,
                           device=device)
    rows = batch // MPMD_MICROBATCHES
    params = list(pipe.parameters()) + list(head.parameters())
    init = [p.detach().clone() for p in params]
    loss_fn = mpmd_loss_fn(vocab)

    def fresh():
        with torch.no_grad():
            for p, v in zip(params, init):
                p.copy_(v)
                p.grad = None
        return AdamW(parameters=params, grad_clip=ClipGradByGlobalNorm(1.0),
                     **ADAMW)

    jdir = tempfile.mkdtemp(prefix="chip_smoke_supervisor_")
    store = TCPStore("127.0.0.1", 0, is_master=True, timeout=120.0)
    ns = "p53b"
    roles = {f"{ns}-0": "serving", f"{ns}-1": "serving",
             f"{ns}-2": "training", f"{ns}-3": "training"}
    out = {"card": smi, "supervisor": dict(SUPERVISOR)}
    with live_telemetry(tdir):
        workers = [EngineWorker(model, store, namespace=ns, name=n, **cfg)
                   for n in roles]
        for w in workers:
            w.engine.warmup()
        router = Router(store, namespace=ns, queue_limit=64, seed=SEED,
                        page_size=cfg["page_size"])
        router._live_agg = live.LiveAggregator(
            window_s=600.0, health_interval_s=LIVE_HEALTH_INTERVAL_S)
        resolved = {}
        router.on_resolve = lambda req: resolved.__setitem__(
            req.rid, resolved.get(req.rid, 0) + 1)

        opt = fresh()
        widths0 = stage_widths(2, SUPERVISOR["plan_stages"])
        mp = MpmdPipeline(pipe, widths0, head=head, loss_fn=loss_fn,
                          num_microbatches=MPMD_MICROBATCHES, wire="raw",
                          devices=[device] * sum(widths0))
        resizes = []

        def resize(source_width, target_width):
            widths = stage_widths(target_width, SUPERVISOR["plan_stages"])
            for s, dp in enumerate(widths):
                if mp.stages[s].dp != dp:
                    mp.resize_stage(s, dp, devices=[device] * dp)
            resizes.append(dict(source=source_width, target=target_width,
                                widths=widths))

        executor = StoreFleetExecutor(
            store, namespace=ns, router=router, resize_fn=resize,
            pump=lambda: pump_all(router, workers), poll_s=0.005)
        sup = FleetSupervisor(
            jdir, executor=executor,
            config=SupervisorConfig(namespace=ns, **SUPERVISOR),
            health_path=os.path.join(tdir, "fleet_health.json"),
            roles=roles, training_width=2)
        for n, r in roles.items():
            if r == "training":
                executor.activate(n, "training")
        # the training-role workers' drain orders reach the router
        deadline = time.perf_counter() + 60.0
        while not all(router._engines.get(n) is not None
                      and router._engines[n].draining
                      for n, r in roles.items() if r == "training"):
            pump_all(router, workers)
            if time.perf_counter() > deadline:
                raise AssertionError("53b: the drain orders never reached "
                                     "the router")
            time.sleep(0.01)

        train = []

        def train_steps():
            reset_flash(fa)
            losses, step_ms = [], []
            for _ in range(SUPERVISOR_TRAIN_STEPS):
                sync()
                t0 = time.perf_counter()
                losses.append(mp.train_batch(x, labels))
                opt.step()
                opt.clear_grad()
                sync()
                step_ms.append(1e3 * (time.perf_counter() - t0))
            width = int(sup.roles_doc["training_width"])
            train.append(dict(
                width=width, widths=[st.dp for st in mp.stages],
                losses=losses, step_ms=step_ms,
                launches={k: getattr(fa, f"launches_{k}")
                          for k in ("fwd", "dq", "dkv")},
                expected=mpmd_expected(mp, rows, SUPERVISOR_TRAIN_STEPS),
                predicted_s=planner.plan_mpmd_stages(
                    mpmd_model_config(batch, seq),
                    planner.Topology(n_devices=width), num_stages=2,
                    microbatches=MPMD_MICROBATCHES).best.predicted_step_s))

        def tick_until(what, cond, timeout=120.0):
            t0 = time.perf_counter()
            outcomes = []
            last = 0.0
            while True:
                pump_all(router, workers)
                now = time.perf_counter()
                if now - last >= 0.02:
                    last = now
                    res = sup.tick()
                    if res is not None:
                        outcomes.append(res)
                if cond(outcomes):
                    return outcomes
                if now - t0 > timeout:
                    raise AssertionError(f"53b {what}: timed out; outcomes "
                                         f"{outcomes}, roles "
                                         f"{sup.roles_doc}, router "
                                         f"{router.stats()}")

        reset_k3(pa)
        train_steps()
        # (1) headroom: two engines serve the 8 requests, the live plane
        # shows it, the supervisor flips p53b-1 to training
        rids = submit_serving(router, prompts)
        drive_router(router, workers)
        health_path = os.path.join(tdir, "fleet_health.json")
        deadline = time.perf_counter() + 30.0
        while True:
            pump_all(router, workers)
            doc = read_json(health_path)
            if doc and sum(c["requests"] for c in doc["classes"].values()) \
                    >= len(rids):
                break
            if time.perf_counter() > deadline:
                raise AssertionError("53b: no health file covering the "
                                     "first requests")
        signals = sup._signals(doc)
        if not (signals["max_burn"] <= SUPERVISOR["low_burn"]
                and signals["admission_backlog"] == 0):
            raise AssertionError(f"53b: no headroom in {signals}")
        out["headroom_signals"] = signals
        tick_until("to_training", lambda o: "committed" in o)
        train_steps()
        # (2) min_serving holds the next flip while the plane stays idle
        held = []
        t_hold = time.perf_counter()
        while time.perf_counter() - t_hold < 3 * (
                SUPERVISOR["hysteresis_s"] + SUPERVISOR["cooldown_s"]):
            pump_all(router, workers)
            res = sup.tick()
            if res is not None:
                held.append(res)
            time.sleep(0.02)
        if held or sup.roles_doc["training_width"] != 3:
            raise AssertionError(f"53b: min_serving did not hold: {held}, "
                                 f"{sup.roles_doc}")
        # (3) a burst behind one engine: backlog, the flip back
        rids += submit_serving(router, burst)
        tick_until("to_serving", lambda o: "committed" in o)
        drive_router(router, workers)
        train_steps()
        sync()
        k3 = check_k3(pa, workers, "53b")
        st = router.stats()
        streams = [router.result(r) for r in rids]
        sparams = [router._requests[r].params for r in rids]
        history = sup.journal.history()
        pending = sup.journal.pending()
        roles_end = sup.roles_doc
        router.shutdown()
        for w in workers:
            w.close()
        mp.close()
    store.close()
    shutil.rmtree(jdir, ignore_errors=True)

    # the unflipped fold of the same steps, from the same weights
    opt = fresh()
    fold_losses = []
    for _ in range(len(train) * SUPERVISOR_TRAIN_STEPS):
        loss = loss_fn(head(pipe(x)), labels)
        loss.backward()
        fold_losses.append(float(loss.detach()))
        opt.step()
        opt.clear_grad()
    got = [v for t in train for v in t["losses"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, fold_losses))
    del opt, pipe, head, params, init
    free_card()
    single = DecodeEngine(model, **cfg)
    srids = [single.submit(p, prm)
             for p, prm in zip(prompts + burst, sparams)]
    single.run()
    reference = [single.result(r) for r in srids]
    del single
    parts = check_serving_streams(fa, model, prompts + burst, sparams,
                                  streams, reference, "53b",
                                  ("router", "reference"))
    flips = []
    for h in history:
        fences = sorted(h["fences"].items(), key=lambda kv: kv[1])
        secs = {a: b[1] - a_t for (a, a_t), b in zip(fences, fences[1:])}
        secs[fences[-1][0]] = h["closed_ts"] - fences[-1][1]
        flips.append(dict(direction=h["direction"], engine=h["engine"],
                          outcome=h["outcome"], reason=h["reason"],
                          fence_s=secs, price=h["price"],
                          widths=(h["source_width"], h["target_width"])))
    for f in flips:
        pr = f["price"]
        log(f"# phase 53b: flip {f['direction']} of {f['engine']} "
            f"({f['reason']}): {f['outcome']}; fence seconds "
            + ", ".join(f"{k} {v:.3f}" for k, v in f["fence_s"].items())
            + f"; priced at widths {f['widths']}: predicted step "
            f"{(pr.get('source') or {}).get('predicted_step_s')} -> "
            f"{(pr.get('target') or {}).get('predicted_step_s')} s "
            f"(proxy geometry, speedup {pr.get('speedup')})  [{smi}]")
    for t in train:
        log(f"# phase 53b: training width {t['width']} (stage widths "
            f"{t['widths']}): losses {t['losses']}, step ms "
            f"{[round(v, 1) for v in t['step_ms']]}; planner's predicted "
            f"step at phase 50's geometry {1e3 * t['predicted_s']:.3f} ms; "
            f"launches {t['launches']} (expected {t['expected']})  [{smi}]")
    log(f"# phase 53b: MPMD losses across the resizes vs the unflipped "
        f"fold {fold_losses}: rel {rel:.2e} (tol {MPMD_LOSS_RTOL}); "
        f"resizes {resizes}; requests done {st['done']}/{len(rids)} "
        f"(each once: {sorted(set(resolved.values()))}), resubmits "
        f"{st['failover_resubmits']}; streams equal "
        f"{sum(np.array_equal(a, b) for a, b in zip(streams, reference))}"
        f"/{len(rids)}, near-tie partings {len(parts)}; K3 {k3}; journal "
        f"pending {pending}, committed {roles_end['flips_committed']}  "
        f"[{smi}]")
    if st["done"] != len(rids) or set(resolved) != set(rids) or \
            set(resolved.values()) != {1}:
        raise AssertionError(f"53b: requests not done exactly once: {st}")
    if not rel <= MPMD_LOSS_RTOL:
        raise AssertionError(f"53b: MPMD losses differ from the fold's "
                             f"(rel {rel})")
    if pending is not None or roles_end["flips_committed"] != 2 or \
            [f["direction"] for f in flips] != ["to_training",
                                                "to_serving"] or \
            any(f["outcome"] != "committed" or not f["price"].get("target")
                for f in flips):
        raise AssertionError(f"53b: journal {flips}, pending {pending}")
    if [t["width"] for t in train] != [2, 3, 2]:
        raise AssertionError(f"53b: training widths "
                             f"{[t['width'] for t in train]}")
    for t in train:
        if t["launches"] != t["expected"]:
            raise AssertionError(f"53b: width {t['width']} launches "
                                 f"{t['launches']} != {t['expected']}")
    out.update(flips=flips, train=train, fold_losses=fold_losses, rel=rel,
               resizes=resizes, launches=k3, partings=parts, router=st)
    return out


def _rank_calibrate(out_dir, layouts):
    """One rank of phase 53c (run by ``paddle.distributed.spawn``): each
    layout of ``layouts`` at the planner's proxy geometry
    (``planner.ModelConfig()``: a GPT of hidden 64, 4 layers, 4 heads,
    vocab 256, 32 tokens; its head_dim 16 is below K1's, so the dense
    attention route) through ``fleet.init`` -> ``DistTrainStep``, 2
    sequences a rank, CALIB_WARMUP + CALIB_STEPS AdamW steps; rank 0
    pickles each layout's calibration entry to ``out_dir``."""
    import os
    import pickle

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.auto_parallel import planner
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank, n = dist.get_rank(), dist.get_world_size()
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    mc = planner.ModelConfig()
    batch = 2 * n
    rng = np.random.default_rng(SEED + 53)
    tok = torch.as_tensor(rng.integers(0, mc.vocab, (batch, mc.seq_len + 1)),
                          device=DEVICE)
    ids, labels = tok[:, :-1].contiguous(), tok[:, 1:].contiguous()
    out = {}
    for name, mesh in layouts.items():
        mesh = {k: int(mesh.get(k, 1)) for k in ("dp", "mp", "pp",
                                                  "sharding")}
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=mesh["dp"], mp_degree=mesh["mp"],
                                pp_degree=mesh["pp"],
                                sharding_degree=mesh["sharding"])
        pipe = None
        if mesh["pp"] > 1:
            m = planner._choose_microbatches(
                batch // (mesh["dp"] * mesh["sharding"]), mesh["pp"])
            s.pipeline_configs.update(schedule="1f1b", virtual_pp_degree=1,
                                      accumulate_steps=m)
            pipe = {"schedule": "1f1b", "virtual_pp_degree": 1,
                    "microbatches": m}
        fleet.init(is_collective=True, strategy=s)
        model = GPTForCausalLM(GPTConfig(
            vocab_size=mc.vocab, hidden_size=mc.hidden,
            num_hidden_layers=mc.layers, num_attention_heads=mc.heads,
            max_position_embeddings=mc.seq_len, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, use_flash_attention=False),
            device=DEVICE, seed=SEED)
        step, _ = dist_trainer(model)
        dist.barrier()
        _, ms = timed_steps(step, (ids, labels), CALIB_WARMUP + CALIB_STEPS,
                            sync)
        out[name] = dict(n=n, mesh=mesh, pipeline=pipe, ok=True,
                         step_s=float(np.median(ms[CALIB_WARMUP:])) / 1e3,
                         steps_ms=ms)
        del step, model
        fleet.topology.set_hybrid_communicate_group(None)
        dist.barrier()
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_calibration(smi, mpmd, timed, timeout=600):
    """Phase 53c: the planner's calibration on the card. A weak-scaling
    sweep at the planner's proxy geometry (:func:`_rank_calibrate`) on
    gloo ranks that share the card, two spawns (CALIB_LAYOUTS: 2 ranks,
    then 4), each entry the median of CALIB_STEPS steps after
    CALIB_WARMUP. Prints the fitted ``CostConstants`` and their
    ``max_rel_error``, the committed ``calibration_h100.json``'s
    prediction error on this run's entries, the plan for phase 50's model
    at its layout beside phase 50's fold and 1F1B steps, and
    ``plan_attn_kernel`` at phase 4's serving geometry beside K3's decode
    device time times the layers. Gates: the fitted constants finite and
    non-negative, one above 0; ``apply_auto_plan`` fills a strategy. The
    ranks serialize through the host on one card: a host-aggregate
    calibration, the regime of the reference's one-host proxy."""
    import os
    import pickle
    import subprocess
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.auto_parallel import planner
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.parallel import join_spawned
    from paddle_tpu_torch.inference.engine import EngineConfig

    t0 = time.perf_counter()
    entries = []
    for n, layouts in CALIB_LAYOUTS.items():
        tmp = tempfile.mkdtemp(prefix="chip_smoke_calib_")
        ctx = dist.spawn(_rank_calibrate, (tmp, layouts), nprocs=n,
                         join=False, backend="gloo",
                         master=f"file://{tmp}/rendezvous")
        join_spawned(ctx, timeout)
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            res = pickle.load(f)
        for name in layouts:
            entries.append(dict(res[name], layout=name))
    secs = time.perf_counter() - t0
    fitted = planner.calibrate(entries)
    v = fitted.as_vector()

    def max_err(consts):
        worst = 0.0
        for e in entries:
            pred = planner.score(
                planner._entry_candidate(e),
                planner._entry_model(e, planner.ModelConfig()),
                planner.Topology(n_devices=int(e["n"])), consts)
            worst = max(worst, abs(pred.predicted_step_s - e["step_s"])
                        / e["step_s"])
        return worst

    try:
        committed_doc = planner.read_calibration_doc()
        committed = planner.calibrate(committed_doc["entries"])
        committed_err = max_err(committed)
        committed_card = committed_doc.get("card")
    except (OSError, ValueError, KeyError):
        committed, committed_err, committed_card = None, None, None
    consts = committed or fitted
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"],
                                capture_output=True, text=True,
                                timeout=10).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        commit = None
    mc50 = mpmd_model_config(MPMD_BATCH, MPMD_SEQ)
    plan50 = planner.plan_mpmd_stages(mc50, planner.Topology(n_devices=2),
                                      num_stages=2,
                                      microbatches=MPMD_MICROBATCHES,
                                      constants=consts)
    runs = mpmd["runs"]
    fold_ms = float(np.mean(runs["fold"]["step_ms"][1:]))
    f1b_ms = float(np.mean(runs["1f1b_local"]["step_ms"][1:]))
    ecfg = EngineConfig(**{k: v_ for k, v_ in engine_config().items()
                           if k != "device"})
    attn = planner.plan_attn_kernel(
        num_slots=ecfg.num_slots, max_pages=ecfg.max_pages, kv_heads=16,
        query_heads=16, page_size=ecfg.page_size, head_dim=128, layers=24,
        kv_dtype="bf16", selected="pallas")
    k3_decode_ms = timed["decode"]["ms"] * 24
    strategy = DistributedStrategy.auto()
    applied = planner.apply_auto_plan(strategy, 4)
    hc = strategy.hybrid_configs
    for e in entries:
        log(f"# phase 53c: {e['layout']} at n={e['n']} (mesh {e['mesh']}, "
            f"pipeline {e['pipeline']}): step {1e3 * e['step_s']:.3f} ms "
            f"(median of {CALIB_STEPS} after {CALIB_WARMUP}; "
            f"{[round(t, 3) for t in e['steps_ms']]})  [{smi}]")
    log(f"# phase 53c: fitted {fitted} (max_rel_error "
        f"{fitted.max_rel_error:.4f}); the committed calibration "
        f"({committed_card}) on this run's entries: max rel error "
        f"{committed_err}; phase 50's model at 2 stages, M="
        f"{MPMD_MICROBATCHES}: planned widths {plan50.best.widths}, "
        f"predicted {1e3 * plan50.best.predicted_step_s:.3f} ms vs the "
        f"fold {fold_ms:.1f} ms and 1F1B {f1b_ms:.1f} ms measured in phase "
        f"50; plan_attn_kernel at phase 4's geometry: K3 (pallas) "
        f"{1e3 * attn.pallas_step_s:.4f} ms, plain (einsum) "
        f"{1e3 * attn.einsum_step_s:.4f} ms a decode step at 3.35 TB/s vs "
        f"K3's decode {k3_decode_ms:.4f} ms (24 layers x "
        f"{timed['decode']['ms']:.4f} ms, CUDA graph); apply_auto_plan at "
        f"4 ranks: dp {hc['dp_degree']} mp {hc['mp_degree']} pp "
        f"{hc['pp_degree']} sharding {hc['sharding_degree']}; {secs:.1f} s "
        "(ranks sharing the card over gloo: a host-serialized calibration)"
        f"  [{smi}]")
    if not (np.isfinite(v).all() and (v >= 0).all() and (v > 0).any()):
        raise AssertionError(f"53c: fitted constants {fitted}")
    if applied is None or hc["dp_degree"] * hc["mp_degree"] * \
            hc["pp_degree"] * hc["sharding_degree"] != 4:
        raise AssertionError(f"53c: apply_auto_plan left {dict(hc)}")
    doc = {"card": smi, "commit": commit, "seconds": secs,
           "entries": [{k: e[k] for k in ("n", "mesh", "pipeline",
                                           "step_s", "steps_ms", "ok",
                                           "layout")} for e in entries]}
    return dict(
        calibration=doc, fitted=dict(
            zip(("fixed_s", "sec_per_flop", "sec_per_byte",
                 "sec_per_collective", "sec_per_dp_over_byte"),
                v.tolist()), max_rel_error=fitted.max_rel_error),
        committed_card=committed_card, committed_max_rel_error=committed_err,
        plan_phase50=dict(widths=plan50.best.widths,
                          predicted_ms=1e3 * plan50.best.predicted_step_s,
                          fold_ms=fold_ms, f1b_ms=f1b_ms),
        attn_kernel=dict(attn.to_dict(), k3_decode_ms=k3_decode_ms),
        auto_plan={k: hc[k] for k in ("dp_degree", "mp_degree",
                                      "pp_degree", "sharding_degree")},
        seconds=secs)


def phases_live_supervisor(pa, fa, smi, serving, mpmd, timed, spec=None):
    """Phase 53 (a-c); returns the ``live_supervisor`` JSON line's
    numbers. ``spec`` (a CPU rehearsal) may name a tiny serving ``model``
    and MPMD ``mpmd`` config / ``batch``."""
    import shutil
    import tempfile

    from paddle_tpu_torch.serving import worker as worker_mod

    spec = dict(spec or {"device": DEVICE})
    t0 = time.perf_counter()
    model = worker_mod.build_worker_model(
        worker_mod.build_arg_parser().parse_args(
            serving_argv(spec.get("model", SERVING_MODEL))))
    out = {"card": smi}
    tdir = tempfile.mkdtemp(prefix="chip_smoke_live_")
    try:
        out["live"] = phase_live_plane(
            pa, fa, smi, model, serving["router_2workers"]["tokens_per_s"],
            tdir)
        tdir_b = tempfile.mkdtemp(prefix="chip_smoke_live_b_")
        try:
            mspec = {"device": spec["device"]}
            if spec.get("mpmd"):
                mspec.update(model=spec["mpmd"], batch=spec["batch"])
            out["supervisor"] = phase_supervisor(pa, fa, smi, model, tdir_b,
                                                 mspec)
        finally:
            shutil.rmtree(tdir_b, ignore_errors=True)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    del model
    free_card()
    out["calibration"] = phase_calibration(smi, mpmd, timed)
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 53: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 54: serving at mp 2, the masked ring, the distributed paddle.Model
# ---------------------------------------------------------------------------
#: 54a: GPT at phase 49's widths, cut to this depth (two whole copies and
#: the mp-1 baseline share the card); Llama-3-8B's widths at this depth
MP_SERVING_LAYERS = 4
MP_LLAMA_LAYERS = 2
MP_WIRES = ("f32", "int8")
#: 54b: the masked ring's shape (phase 42's) and the share of each row's
#: keys its padding mask keeps (about 40 % masked)
SEP_MASK_RING = dict(b=2, t=2048, h=16, d=128)
SEP_MASK_KEEP = (0.62, 0.58)
SEP_BERT_STEPS = 3
#: 54c: ERNIE-3.0-base's widths at this depth, fine-tuned through
#: paddle.Model at dp 2 for this many batches of ERNIE_BATCH x ERNIE_SEQ
HAPI_DP_LAYERS = 4
HAPI_DP_STEPS = 4


def mp_gpt(spec):
    """54a's GPT: GPT-3 1.3B (phase 49's widths) at MP_SERVING_LAYERS, a
    rehearsal's tiny ``spec["gpt"]`` config instead; built whole."""
    if not spec.get("gpt"):
        return build_model(MP_SERVING_LAYERS)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    return GPTForCausalLM(GPTConfig(**spec["gpt"]), device=DEVICE, seed=SEED)


def mp_llama(spec):
    if not spec.get("llama"):
        return build_llama(MP_LLAMA_LAYERS)
    from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM)

    return LlamaForCausalLM(LlamaConfig(**spec["llama"]), device=DEVICE,
                            seed=SEED)


def mp_sep_bert(spec):
    """54b's BERT-base masked LM (phase 25's widths and seed) with every
    dropout 0, so the split run and the baseline take the same steps; or
    a rehearsal's tiny ``spec["bert"]`` config."""
    from paddle_tpu_torch.text.models.bert import BertConfig, BertForMaskedLM

    cfg = BertConfig(**dict(spec.get("bert") or {},
                            attention_probs_dropout_prob=0.0,
                            hidden_dropout_prob=0.0))
    return BertForMaskedLM(cfg, device=DEVICE, seed=SEED)


def hapi_ernie(spec):
    """54c's ERNIE-3.0 classifier at HAPI_DP_LAYERS, dropouts 0 (the
    ranks' and the baseline's steps compare), or a rehearsal's."""
    if not spec.get("ernie"):
        return build_ernie(HAPI_DP_LAYERS, dropout=0.0)
    from paddle_tpu_torch.text.models.ernie import (
        ErnieConfig, ErnieForSequenceClassification)

    return ErnieForSequenceClassification(ErnieConfig(**spec["ernie"]),
                                          num_classes=2, device=DEVICE,
                                          seed=SEED)


def hapi_data(vocab, spec):
    n, seq = spec.get("ernie_data", (HAPI_DP_STEPS * ERNIE_BATCH, ERNIE_SEQ))
    return PairData(n, vocab, seq, SEED + 54), n // HAPI_DP_STEPS


def bert_sep_trainer(model, dist_step):
    """Phase 25's AdamW and clip on ``model``, its loss, through a
    ``DistTrainStep`` (``dist_step``) or a ``TrainStep``."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **BERT_ADAMW)

    def loss_fn(m, ids, types, mask, labels):
        return m(ids, types, attention_mask=mask, labels=labels)

    cls = fleet.DistTrainStep if dist_step else TrainStep
    return cls(model, loss_fn, opt)


def sep_mask_batch(model, spec):
    if spec.get("bert_batch"):
        b, t = spec["bert_batch"]
        rng = np.random.default_rng(SEED + 23)
        v = model.config.vocab_size
        ids = rng.integers(3, v, (b, t))
        mask = np.ones((b, t), np.int64)
        mask[1:, t // 3:] = 0
        labels = np.where(rng.random((b, t)) < 0.3, ids, -100)
        return [torch.as_tensor(x, device=DEVICE) for x in
                (ids * mask, np.zeros_like(ids), mask, labels * mask
                 - 100 * (1 - mask))]
    return mlm_batch(model.config.vocab_size)[0]


def fit_losses(model, data, batch):
    """``Model.fit`` over ``data`` (one epoch, in order), the per-step
    losses."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    rec = Losses()
    model.fit(data, batch_size=batch, epochs=1, shuffle=False, verbose=0,
              num_workers=0, callbacks=[rec])
    return rec.losses


def masked_oracle(full, mask, causal):
    """The whole sequence's attention in float64 torch under ``mask`` (a
    [B, T] keep mask or an additive [B, 1, T, T] bias) and its q / k / v
    gradients under dO."""
    q, k, v, do = (x.detach().double() for x in full)
    for x in (q, k, v):
        x.requires_grad_()
    d, t = q.shape[-1], q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    if mask.dtype == torch.bool:
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    else:
        s = s + mask.double()
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    o.backward(do)
    return [o.detach(), q.grad, k.grad, v.grad]


def _rank_mp_sep_hapi(out_dir, spec):
    """One rank of phase 54 (run by ``paddle.distributed.spawn``, two
    gloo ranks sharing the card): 54a the mp-2 engines, 54b the masked
    ring and BERT at sep 2, 54c ERNIE's ``Model.fit`` at dp 2; the results
    pickled to ``out_dir``."""
    import os
    import pickle

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.inference.engine import DecodeEngine
    from paddle_tpu_torch.nn.functional import ring_attention as ra
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    if spec.get("prepare"):
        spec["prepare"]()
    on_card = DEVICE == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    out = {}
    # 54a: whole models served through an mp 2 mesh
    mesh = dist.ProcessMesh([[0, 1]], dim_names=["dp", "mp"])
    for name, build, wires in (("gpt", mp_gpt, MP_WIRES),
                               ("llama", mp_llama, ("f32",))):
        model = build(spec)
        prompts = make_prompts(model.config.vocab_size)
        for wire in wires:
            eng = DecodeEngine(model, **engine_config(
                kv_dtype="f32", logit_wire=wire, mesh=mesh))
            ad = eng.adapter
            reset_k3(pa)
            C.counts["logit_wire_bytes"] = 0
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            streams = serve(eng, prompts)
            sync()
            secs = time.perf_counter() - t0
            st = eng.stats()
            launches, tile, split, decode, verify = k3_counts(pa)
            out[f"{name}_{wire}"] = dict(
                streams=streams, seconds=secs, tokens=st["total_tokens"],
                pool=list(eng._kc.shape), kv_heads=st["kv_heads"],
                wire_bytes=C.counts["logit_wire_bytes"],
                prefills=st["prefill_calls"], steps=st["decode_steps"],
                verify_steps=st["verify_steps"],
                prefix_hit_tokens=st["prefix_hit_tokens"],
                vocab=model.config.vocab_size,
                k3=dict(launches=launches, tile=tile, split=split,
                        decode=decode, verify=verify),
                k3_want=k3_expected(pa, ad.num_layers, st, eng,
                                    ad.num_heads // ad.num_kv_heads))
            del eng
        del model
        free_card()
    # 54b: the masked ring at sep 2, then BERT with its padding mask
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=1, sep_degree=2)
    fleet.init(is_collective=True, strategy=s)
    group = fleet.get_hybrid_communicate_group().get_sep_parallel_group()
    shape = spec.get("ring", SEP_MASK_RING)
    full, blocks = ring_blocks(shape, torch.float32, DEVICE, 2, group.rank)
    b, t = shape["b"], shape["t"]
    tl = t // 2
    keep = torch.zeros(b, t, dtype=torch.bool, device=DEVICE)
    for i, share in enumerate(SEP_MASK_KEEP[:b]):
        keep[i, :int(share * t)] = True
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 54)
    bias = torch.randn((b, 1, t, t), generator=gen, device=DEVICE)
    blk = slice(group.rank * tl, (group.rank + 1) * tl)
    ring = {}
    for name, mask, local, causal in (
            ("key_padding", keep, keep[:, blk].contiguous(), False),
            ("bias_rows", bias, bias[:, :, blk].contiguous(), True)):
        res = {}
        for route, fn in (("plain", ra.ring_flash_attention_plain),
                          ("kernels", ra.ring_flash_attention)):
            q, k, v = (x.detach().clone().requires_grad_()
                       for x in blocks[:3])
            reset_flash(fa)
            o = fn(q, k, v, group, causal=causal, mask=local)
            o.backward(blocks[3])
            sync()
            res[route] = [o.detach(), q.grad, k.grad, v.grad]
            res[f"{route}_launches"] = flash_counts(fa)
        oracle = masked_oracle(full, mask, causal)
        pairs = (("kernels_vs_oracle", res["kernels"],
                  [x[:, blk] for x in oracle]),
                 ("plain_vs_oracle", res["plain"],
                  [x[:, blk] for x in oracle]),
                 ("kernels_vs_plain", res["kernels"], res["plain"]))
        ring[name] = dict(
            launches=res["kernels_launches"],
            plain_launches=res["plain_launches"],
            masked_share=1.0 - keep.float().mean().item()
            if mask is keep else 0.0,
            **{key: {n: _rel(x.double(), y.double()) for n, x, y in
                     zip(("o", "dq", "dk", "dv"), got, want)}
               for key, got, want in pairs})
        del res, oracle
    out["ring"] = ring
    del full, blocks, bias
    model = mp_sep_bert(spec)
    step = bert_sep_trainer(model, True)
    batch = sep_mask_batch(model, spec)
    reset_flash(fa)
    C.reset_counts()
    sync()
    t0 = time.perf_counter()
    losses = [float(step(*batch)) for _ in range(SEP_BERT_STEPS)]
    sync()
    out["bert"] = dict(losses=losses, launches=flash_counts(fa),
                       p2p=C.counts["batch_isend_irecv"],
                       seconds=time.perf_counter() - t0,
                       layers=model.config.num_hidden_layers)
    del step, model
    fleet.topology.set_hybrid_communicate_group(None)
    free_card()
    # 54c: paddle.Model at dp 2, then its comm_traffic report
    s = fleet.DistributedStrategy()
    s.hybrid_configs["dp_degree"] = 2
    fleet.init(is_collective=True, strategy=s)
    net = hapi_ernie(spec)
    model = ernie_model(net)
    data, batch_size = hapi_data(net.config.vocab_size, spec)
    reset_flash(fa)
    sync()
    t0 = time.perf_counter()
    losses = fit_losses(model, data, batch_size)
    sync()
    fit_s = time.perf_counter() - t0
    launches = flash_counts(fa)
    first = [torch.as_tensor(np.stack([data[i][j] for i in range(
        batch_size)]), device=DEVICE) for j in range(4)]
    traffic = {}
    for wire in ("f32", "bf16"):
        os.environ["PADDLE_TPU_GRAD_COMM"] = wire
        try:
            rep = model.comm_traffic(*first)
        finally:
            del os.environ["PADDLE_TPU_GRAD_COMM"]
        ex = rep["grad_exchange"]
        traffic[wire] = dict(
            n_buckets=ex["n_buckets"], payload=ex["payload_bytes"],
            payload_f32=ex["payload_bytes_f32"],
            quantized_fraction=ex["quantized_fraction"],
            grad_payload=sum(c["payload_bytes"] for c in ex["buckets"]
                             if c["bucket"] is not None),
            per_axis=rep["per_axis"], collectives=len(rep["collectives"]))
    out["hapi"] = dict(
        losses=losses, fit_s=fit_s, launches=launches, traffic=traffic,
        step=type(model._train_step).__name__,
        grad_bytes=sum(4 * p.numel() for p in net.parameters()
                       if p.requires_grad))
    fleet.topology.set_hybrid_communicate_group(None)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def mp_baselines(spec):
    """Phase 54's single-process baselines, each from the ranks' seeds:
    the mp-1 engines' streams and tokens/s (f32 KV), three BERT steps at
    sep 1, ERNIE's ``Model.fit``. The serving models are returned for the
    near-tie check."""
    from paddle_tpu_torch.inference.engine import DecodeEngine

    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    out, models = {}, {}
    for name, build in (("gpt", mp_gpt), ("llama", mp_llama)):
        model = build(spec)
        prompts = make_prompts(model.config.vocab_size)
        eng = DecodeEngine(model, **engine_config(kv_dtype="f32"))
        sync()
        t0 = time.perf_counter()
        streams = serve(eng, prompts)
        sync()
        out[name] = dict(streams=streams, prompts=prompts,
                         seconds=time.perf_counter() - t0,
                         tokens=eng.stats()["total_tokens"])
        models[name] = model
        del eng
    model = mp_sep_bert(spec)
    step = bert_sep_trainer(model, False)
    batch = sep_mask_batch(model, spec)
    out["bert"] = [float(step(*batch)) for _ in range(SEP_BERT_STEPS)]
    del step, model
    net = hapi_ernie(spec)
    data, batch_size = hapi_data(net.config.vocab_size, spec)
    out["hapi"] = fit_losses(ernie_model(net), data, batch_size)
    del net
    free_card()
    return out, models


def phase_mp_sep_hapi(pa, fa, smi, timeout=900, spec=None):
    """Phase 54: the rest of §A.7, part 1, on two gloo ranks sharing the
    card after single-process baselines (:func:`mp_baselines`).

    (a) GPT-3 1.3B's widths at MP_SERVING_LAYERS and Llama-3-8B's at
    MP_LLAMA_LAYERS, built whole, served through ``EngineConfig(mesh=)``
    at mp 2 (f32 KV; GPT on the f32 and the int8 logit wire): make_prompts'
    8 requests with prefix sharing and speculation, greedy streams equal
    to the mp-1 engine's (or parting at a near-tie), equal on both ranks,
    the pool at ``Hkv / 2`` heads, K3's launches a rank by regime equal to
    ``k3_expected``, the logit wire's bytes equal to ``logit_wire_bytes``
    over the programs run, the int8 tokens' share equal to f32's, tokens/s
    beside mp 1 (gloo through the host: not a speed claim).
    (b) The ring at sep 2 on SEP_MASK_RING under a key padding mask (about
    40 % masked, non-causal) and a causal [B, 1, T, T] bias: the kernel
    ring against the plain ring and both against a float64 oracle on the
    whole sequence, rel o / dq / dk / dv a rank within FLASH_TOL (f32),
    K1 / K2a / K2b launched; BERT-base with its padding mask for
    SEP_BERT_STEPS steps through ``DistTrainStep`` at sep 2: losses
    within TRAIN_LOSS_RTOL of the ``TrainStep``, K1 / K2 a rank =
    layers x 2 blocks x steps.
    (c) ERNIE at HAPI_DP_LAYERS through ``paddle.Model`` at dp 2
    (``prepare`` routes to ``DistTrainStep``): ``fit``'s losses within
    TRAIN_LOSS_RTOL of one process's, K1 / K2 launched; ``comm_traffic``:
    the gradient buckets' payload equal to the parameters' f32 bytes,
    their ``quantized_fraction`` under the bf16 wire about 0.5.
    Returns the ``mp_sep_hapi`` JSON line's numbers."""
    import os
    import pickle
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import mp_comm
    from paddle_tpu_torch.distributed.parallel import join_spawned
    from paddle_tpu_torch.inference.engine import SamplingParams

    spec = dict(spec or {})
    t_phase = time.perf_counter()
    base, models = mp_baselines(spec)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        t0 = time.perf_counter()
        ctx = dist.spawn(_rank_mp_sep_hapi, (tmp, spec), nprocs=2,
                         join=False, backend="gloo",
                         master=f"file://{tmp}/rendezvous")
        join_spawned(ctx, timeout)
        secs = time.perf_counter() - t0
        ranks = [pickle.load(open(os.path.join(tmp, f"rank{r}.pkl"), "rb"))
                 for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"card": smi, "seconds_ranks": secs}
    # 54a
    k = engine_config()["speculate_k"]
    slots = engine_config()["num_slots"]
    serving = {}
    for name in ("gpt", "llama"):
        b = base[name]
        params = [SamplingParams(max_new_tokens=NEW_TOKENS)] * len(
            b["prompts"])
        for wire in (MP_WIRES if name == "gpt" else ("f32",)):
            a0, a1 = (r[f"{name}_{wire}"] for r in ranks)
            for x, y in zip(a0["streams"], a1["streams"]):
                if not np.array_equal(x, y):
                    raise AssertionError(f"54a {name} {wire}: the ranks' "
                                         "streams differ")
            partings = check_serving_streams(
                fa, models[name], b["prompts"], params, a0["streams"],
                b["streams"], f"54a {name} mp 2 {wire} wire",
                (f"mp 2 {wire} wire", "mp 1"))
            v = a0["vocab"]
            want_bytes = sum(
                n * mp_comm.logit_wire_bytes(rows, v, 2, wire)[1]
                for n, rows in ((a0["prefills"], 1),
                                (a0["steps"] - a0["verify_steps"], slots),
                                (a0["verify_steps"], slots * (k + 1))))
            steps = a0["prefills"] + a0["steps"]
            for r, a in enumerate((a0, a1)):
                got = tuple(a["k3"][x] for x in
                            ("tile", "split", "decode", "verify"))
                if got != tuple(a["k3_want"]) or a["k3"]["launches"] != \
                        a["k3"]["tile"] + a["k3"]["split"] or \
                        a["k3"]["launches"] == 0:
                    raise AssertionError(
                        f"54a {name} {wire} rank {r}: K3 launches {a['k3']}"
                        f", expected {a['k3_want']}")
                if a["wire_bytes"] != want_bytes:
                    raise AssertionError(
                        f"54a {name} {wire} rank {r}: logit wire bytes "
                        f"{a['wire_bytes']}, logit_wire_bytes "
                        f"{want_bytes}")
            heads = models[name].decode_adapter().num_kv_heads
            if a0["kv_heads"] != heads // 2 or a0["pool"][2] != heads // 2:
                raise AssertionError(f"54a {name}: the pool holds "
                                     f"{a0['pool']}, not {heads // 2} heads")
            if a0["prefix_hit_tokens"] < SHARED_PREFIX - 16 or \
                    not a0["verify_steps"]:
                raise AssertionError(f"54a {name}: no prefix hit or no "
                                     "verify step")
            tps = a0["tokens"] / a0["seconds"]
            serving[f"{name}_{wire}"] = dict(
                tokens_per_s=tps, tokens_per_s_mp1=b["tokens"] / b["seconds"],
                partings=partings, wire_bytes=a0["wire_bytes"],
                wire_bytes_per_step=a0["wire_bytes"] / steps,
                want_bytes=want_bytes, pool=a0["pool"],
                launches_rank0=a0["k3"], launches_rank1=a1["k3"])
            log(f"# phase 54a: {name} at mp 2, {wire} logit wire: {tps:.1f} "
                f"tokens/s (mp 1: {b['tokens'] / b['seconds']:.1f}, gloo "
                f"through the host), pool {a0['pool']}, K3 rank 0 "
                f"{a0['k3']} rank 1 {a1['k3']}, logit wire "
                f"{a0['wire_bytes']} B ({a0['wire_bytes'] / steps:.0f} B a "
                f"step) = logit_wire_bytes, partings {len(partings)}  "
                f"[{smi}]")
        if name == "gpt":
            f32s, int8s = (ranks[0][f"gpt_{w}"]["streams"] for w in MP_WIRES)
            gen = [(np.asarray(a[len(p):]), np.asarray(c[len(p):]))
                   for a, c, p in zip(f32s, int8s, b["prompts"])]
            same = sum(int((x == y).sum()) for x, y in gen)
            total = sum(x.size for x, _ in gen)
            serving["int8_equal_share"] = same / total
            log(f"# phase 54a: int8 logit wire tokens equal to the f32 "
                f"wire's: {same} / {total}")
    out["serving"] = serving
    del models
    free_card()
    # 54b
    tol = FLASH_TOL[torch.float32]
    for r, rk in enumerate(ranks):
        for name, res in rk["ring"].items():
            worst = max(e[1] for key in ("kernels_vs_oracle",
                                         "plain_vs_oracle",
                                         "kernels_vs_plain")
                        for e in res[key].values())
            log(f"# phase 54b: ring {name} rank {r}: rel kernels vs oracle "
                f"{ {n: e[1] for n, e in res['kernels_vs_oracle'].items()} }"
                f", plain vs oracle "
                f"{ {n: e[1] for n, e in res['plain_vs_oracle'].items()} }"
                f", kernels vs plain "
                f"{ {n: e[1] for n, e in res['kernels_vs_plain'].items()} }"
                f"; launches {res['launches']}")
            if not worst <= tol:
                raise AssertionError(f"54b ring {name} rank {r}: rel "
                                     f"{worst:.2e} > {tol}")
            if min(res["launches"][x] for x in ("fwd", "dq", "dkv")) == 0:
                raise AssertionError(f"54b ring {name} rank {r}: a kernel "
                                     "never launched")
    a0, a1 = (rk["bert"] for rk in ranks)
    rel = max(abs(x - y) / abs(y) for x, y in zip(a0["losses"],
                                                  base["bert"]))
    want = a0["layers"] * 2 * SEP_BERT_STEPS
    log(f"# phase 54b: BERT-base with its padding mask at sep 2: losses "
        f"{a0['losses']} vs TrainStep {base['bert']} (rel {rel:.2e}); "
        f"launches rank 0 {a0['launches']} rank 1 {a1['launches']} "
        f"(want {want} each); {a0['seconds']:.1f} s  [{smi}]")
    if a0["losses"] != a1["losses"] or not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("54b: BERT's losses at sep 2 differ")
    for r in (a0, a1):
        if any(r["launches"][x] != want for x in ("fwd", "dq", "dkv")):
            raise AssertionError(f"54b: BERT's launches {r['launches']}, "
                                 f"want {want}")
    out["ring"] = {f"rank{r}": rk["ring"] for r, rk in enumerate(ranks)}
    out["bert"] = dict(loss_rel=rel, losses=a0["losses"],
                       baseline=base["bert"], seconds=a0["seconds"],
                       launches_rank0=a0["launches"],
                       launches_rank1=a1["launches"])
    # 54c
    h0, h1 = (rk["hapi"] for rk in ranks)
    rel = max(abs(x - y) / abs(y) for x, y in zip(h0["losses"],
                                                  base["hapi"]))
    f32, bf16 = h0["traffic"]["f32"], h0["traffic"]["bf16"]
    log(f"# phase 54c: paddle.Model at dp 2 ({h0['step']}): losses "
        f"{h0['losses']} vs one process {base['hapi']} (rel {rel:.2e}); "
        f"launches {h0['launches']}; comm_traffic f32: {f32['n_buckets']} "
        f"dp reductions, gradient payload {f32['grad_payload']} B vs "
        f"parameters {h0['grad_bytes']} B; bf16 wire: quantized fraction "
        f"{bf16['quantized_fraction']:.4f}  [{smi}]")
    if h0["step"] != "DistTrainStep" or h0["losses"] != h1["losses"] or \
            not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError("54c: Model.fit at dp 2 differs")
    if f32["grad_payload"] != h0["grad_bytes"] or \
            bf16["grad_payload"] * 2 != h0["grad_bytes"] or \
            not 0.45 < bf16["quantized_fraction"] <= 0.5 or \
            f32["quantized_fraction"] != 0.0:
        raise AssertionError(f"54c: comm_traffic {h0['traffic']}")
    if min(h0["launches"][x] for x in ("fwd", "dq", "dkv")) == 0:
        raise AssertionError("54c: a flash kernel never launched in fit")
    out["hapi"] = dict(loss_rel=rel, losses=h0["losses"],
                       baseline=base["hapi"], fit_s=h0["fit_s"],
                       launches_rank0=h0["launches"],
                       launches_rank1=h1["launches"], traffic=h0["traffic"],
                       grad_bytes=h0["grad_bytes"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 54: {out['seconds']:.1f} s ({secs:.1f} s of ranks)")
    return out


# -- phase 55: the mp worker, EP over replicated rows, the vision zoo and
# -- nn.Transformer's caches ---------------------------------------------------
#: 55a: the worker CLI's model, GPT-3 1.3B's widths at phase 54a's depth
MP_WORKER_MODEL = dict(SERVING_MODEL, layers=MP_SERVING_LAYERS)
#: 55b: rows of each batch, which the data degree 2 does not divide
EP_ROWS = 3
EP_STEPS = 3
EP_VOCAB = 64
EP_SEQ = 16
EP_LOSS_RTOL = 1e-5
#: 55c: ViT-B/16 at its published input, FakeData of 10 classes
VIT_BATCH = 32
VIT_HW = 224
VIT_CLASSES = 10
VIT_STEPS = 3
VIT_EVAL_BATCHES = 2
VIT_LR = 1e-4
#: the flash route's f32 losses against the dense route's: K1 / K2's
#: 3xTF32 products part from the dense einsums by ~1e-6 a logit
VIT_LOSS_RTOL = 1e-4
#: 55d: one builder a family at its published input (in_channels, side)
ZOO_FAMILIES = (("LeNet", 1, 28), ("alexnet", 3, 224), ("vgg16", 3, 224),
                ("squeezenet1_1", 3, 224), ("mobilenet_v1", 3, 224),
                ("mobilenet_v2", 3, 224), ("mobilenet_v3_large", 3, 224),
                ("mobilenet_v3_small", 3, 224),
                ("shufflenet_v2_x1_0", 3, 224), ("densenet121", 3, 224),
                ("googlenet", 3, 224), ("inception_v3", 3, 299))
ZOO_BATCH = 8
ZOO_CPU_ROWS = 2
#: card against CPU with TF32 off (the allow_tf32 line): f32 convolutions
#: on both, cuDNN's algorithms summing in other orders
ZOO_RTOL = CARD_CPU_RTOL
ZOO_FIT_STEPS = 3
ZOO_FIT_HW = 224
#: 55e: Transformer-base (Vaswani et al. 2017, Table 3)
TRANSFORMER_BASE = dict(d_model=512, nhead=8, num_encoder_layers=6,
                        num_decoder_layers=6, dim_feedforward=2048,
                        dropout=0.0)
T_SOURCES = 4
T_SRC_LEN = 64
T_PREFIX = 4
T_NEW = 32
T_VOCAB = 32000
T_PAGE = 16


def _worker_records(text, key):
    return [json.loads(x)[key] for x in text.splitlines(True)
            if x.startswith("{" + json.dumps(key)) and x.endswith("\n")]


def phase_mp_worker(pa, fa, smi, spec=None):
    """Phase 55a: ``python -m paddle_tpu_torch.serving.worker --mp 2``
    behind the port's ``Router`` (its two ranks share the card over gloo)
    beside an ``--mp 1`` worker, each in its own namespace, on make_prompts'
    8 greedy requests (f32 KV); then an ``--mp 2`` prefill worker handing
    off to an ``--mp 1`` decode worker. Gates: the streams equal (or part
    at a near-tie), each rank's K3 launches equal ``k3_expected`` of its
    engine's programs, every process exits 0. Returns the numbers."""
    import os
    import shutil
    import socket
    import tempfile
    from pathlib import Path
    from types import SimpleNamespace

    from paddle_tpu_torch.inference.engine import EngineConfig, SamplingParams
    from paddle_tpu_torch.runtime import TCPStore
    from paddle_tpu_torch.serving import Router
    from paddle_tpu_torch.serving.worker import (build_arg_parser,
                                                 build_worker_model)

    spec = dict(spec or {})
    t_phase = time.perf_counter()
    model_cfg = spec.get("model", MP_WORKER_MODEL)
    argv = serving_argv(model_cfg) + ["--kv-dtype", "f32"]
    args = build_arg_parser().parse_args(argv)
    model = build_worker_model(args)
    prompts = make_prompts(model_cfg["vocab"])
    params = [SamplingParams(max_new_tokens=NEW_TOKENS)] * len(prompts)
    cfg = engine_config()
    shim = SimpleNamespace(
        buckets=EngineConfig(max_length=cfg["max_length"]).resolved_buckets(),
        config=SimpleNamespace(speculate_k=cfg["speculate_k"]))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    store = TCPStore("127.0.0.1", port, is_master=True, timeout=120.0)
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mp_worker_"))
    env = dict(os.environ, PYTHONPATH=str(root))
    env.pop("PADDLE_TPU_TELEMETRY_DIR", None)
    env.update(spec.get("worker_env", {}))
    workers = {"mp2": ("p55_mp2", "--mp", "2"),
               "mp1": ("p55_mp1", "--mp", "1"),
               "pd_prefill": ("p55_pd", "--mp", "2", "--role", "prefill"),
               "pd_decode": ("p55_pd", "--mp", "1", "--role", "decode")}
    procs, logs = {}, {}
    for name, (ns, *extra) in workers.items():
        logs[name] = open(tmp / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
             "--master", f"127.0.0.1:{port}", "--namespace", ns,
             "--name", name, *argv, *extra], cwd=root, env=env,
            stdout=subprocess.DEVNULL, stderr=logs[name])

    def alive():
        for n, p in procs.items():
            if p.poll() is not None:
                raise AssertionError(
                    f"55a: worker {n} exited {p.returncode}: "
                    + (tmp / f"{n}.log").read_text()[-3000:])

    routers = {
        ns: Router(store, namespace=ns, queue_limit=64, seed=SEED,
                   page_size=cfg["page_size"], engine_grace_s=300.0,
                   **({"prefill_threshold_tokens": SERVING_PREFILL_THRESHOLD}
                      if ns == "p55_pd" else {}))
        for ns in ("p55_mp2", "p55_mp1", "p55_pd")}
    out = {"card": smi}
    try:
        t0 = time.perf_counter()
        want_alive = {"p55_mp2": 1, "p55_mp1": 1, "p55_pd": 2}
        while any(r.stats()["engines_alive"] < want_alive[ns] or any(
                e.beat < 1 for e in r._engines.values())
                for ns, r in routers.items()):
            alive()
            for r in routers.values():
                r.pump()
            time.sleep(0.01)
            if time.perf_counter() - t0 > 300:
                raise AssertionError("55a: workers did not register")
        out["ready_s"] = time.perf_counter() - t0
        streams = {}
        for ns, r in routers.items():
            t1 = time.perf_counter()
            rids = [r.submit(p, slo="standard", max_new_tokens=NEW_TOKENS)
                    for p in prompts]
            while r.pending():
                alive()
                r.pump()
                time.sleep(0.001)
                if time.perf_counter() - t1 > 600:
                    raise AssertionError(f"55a {ns} undrained: {r.stats()}")
            wall = time.perf_counter() - t1
            got = [r.result(i) for i in rids]
            streams[ns] = got
            new = sum(len(g) - len(p) for g, p in zip(got, prompts))
            out[ns] = dict(seconds=wall, tokens=new,
                           tokens_per_s=new / wall, stats=r.stats())
        for r in routers.values():
            r.shutdown()
        codes = {n: p.wait(120) for n, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for f in logs.values():
            f.close()
        store.close()
    if any(codes.values()):
        raise AssertionError(f"55a: worker exit codes {codes}")
    out["partings_mp2"] = check_serving_streams(
        fa, model, prompts, params, streams["p55_mp2"], streams["p55_mp1"],
        "55a mp 2 worker", ("--mp 2 worker", "--mp 1 worker"))
    out["partings_pd"] = check_serving_streams(
        fa, model, prompts, params, streams["p55_pd"], streams["p55_mp1"],
        "55a mp 2 prefill -> mp 1 decode", ("disaggregated", "unified"))
    if out["p55_pd"]["stats"]["disagg_dispatches"] != sum(
            len(p) >= SERVING_PREFILL_THRESHOLD for p in prompts):
        raise AssertionError(f"55a: disaggregated {out['p55_pd']['stats']}")
    layers = model_cfg["layers"]
    launches = {}
    for name in workers:
        text = (tmp / f"{name}.log").read_text()
        (rank0,) = [r for r in _worker_records(text, "serving_worker")
                    if r["event"] == "stop"]
        ranks = [rank0] + _worker_records(text, "serving_worker_follower")
        if len(ranks) != int(workers[name][2]):
            raise AssertionError(f"55a {name}: records {ranks}")
        want = k3_expected(pa, layers, rank0["engine"], shim, 1)
        for i, rec in enumerate(ranks):
            k3 = rec["k3"]
            got = tuple(k3[f"launches_{x}"]
                        for x in ("tile", "split", "decode", "verify"))
            if rec["engine"] != rank0["engine"] or (
                    DEVICE == "cuda" and (got != want or k3["launches"] !=
                                          got[0] + got[1]
                                          or k3["launches"] == 0)):
                raise AssertionError(
                    f"55a {name} rank {i}: K3 {k3}, engine {rec['engine']}"
                    f", expected {want} of rank 0's {rank0['engine']}")
            launches[f"{name}_rank{i}"] = dict(
                tile=got[0], split=got[1], decode=got[2], verify=got[3],
                launches=k3["launches"])
    out["launches"] = launches
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 55a: GPT-3 1.3B widths at depth {layers}: --mp 2 worker "
        f"{out['p55_mp2']['tokens_per_s']:.1f} tokens/s, --mp 1 worker "
        f"{out['p55_mp1']['tokens_per_s']:.1f} tokens/s (8 greedy requests, "
        f"f32 KV, the mp ranks over gloo through the host: not a speed "
        f"claim); mp 2 prefill -> mp 1 decode "
        f"{out['p55_pd']['tokens_per_s']:.1f} tokens/s; partings "
        f"{len(out['partings_mp2'])} / {len(out['partings_pd'])}; K3 "
        f"{launches}; workers ready in {out['ready_s']:.1f} s; phase "
        f"{out['seconds']:.1f} s  [{smi}]")
    del model
    free_card()
    return out


def ep_moe_net(paddle):
    """``tests/torch_port_utils.moe_net``'s network (the reference's
    ``_run_moe`` net: an embedding, a capacity MoELayer of 8 experts,
    top-2, a linear head; cross entropy plus the aux loss)."""
    nn, F = paddle.nn, paddle.nn.functional
    moe = paddle.incubate.MoELayer(d_model=32, d_hidden=64, num_experts=8,
                                   top_k=2)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(EP_VOCAB, 32)
            self.moe = moe
            self.head = nn.Linear(32, EP_VOCAB)

        def forward(self, ids, labels=None):
            logits = self.head(self.moe(self.emb(ids)))
            ce = F.cross_entropy(paddle.reshape(logits, [-1, EP_VOCAB]),
                                 paddle.reshape(labels, [-1]))
            return ce + self.moe.last_aux_loss

    return Net()


def ep_rows_run(dist_step):
    """EP_STEPS AdamW steps of :func:`ep_moe_net` (eval mode: the gate
    draws no noise) on EP_ROWS-row batches, through ``TrainStep`` or, at
    data degree 2, ``DistTrainStep``; returns the losses and, distributed,
    the exchange's bytes and the experts this rank holds."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.jit import TrainStep

    torch.manual_seed(SEED)
    model = ep_moe_net(paddle)
    model.eval()
    opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters())

    def loss_fn(m, ids, labels):
        return m(ids, labels=labels)

    if dist_step:
        model = fleet.distributed_model(model)
        step = fleet.DistTrainStep(model, loss_fn,
                                   fleet.distributed_optimizer(opt))
    else:
        step = TrainStep(model, loss_fn, opt)
    rng = np.random.default_rng(SEED)
    collective.reset_counts()
    losses = []
    for _ in range(EP_STEPS):
        ids = torch.as_tensor(rng.integers(0, EP_VOCAB, (EP_ROWS, EP_SEQ)),
                              device=DEVICE)
        losses.append(float(step(ids, ids)))
    return dict(losses=losses,
                exchange_bytes=collective.counts.get(
                    "global_scatter_bytes", 0),
                experts=int(dict(model.named_parameters())[
                    "moe.w_in"].shape[0]))


def _rank_ep_rows(out_dir, spec):
    """One rank of phase 55b: ``fleet.init`` at dp 2 (the expert axis the
    data axis), then :func:`ep_rows_run` through ``DistTrainStep``."""
    import os
    import pickle

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    if spec.get("prepare"):
        spec["prepare"]()
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=2)
    fleet.init(is_collective=True, strategy=s)
    out = ep_rows_run(True)
    out["expert_axis"] = \
        fleet.get_hybrid_communicate_group().get_expert_parallel_axis()
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


def phase_ep_rows(smi, timeout=600, spec=None):
    """Phase 55b: the MoE net of ``tests/test_torch_moe_ep.py`` at data
    degree 2 on two gloo ranks sharing the card, at EP_ROWS rows a batch,
    which 2 does not divide: ``DistTrainStep`` leaves the rows whole, the
    expert axis (data) holds the same tokens on both ranks, each computes
    its 4 experts and no exchange runs. Gate: every rank's losses within
    EP_LOSS_RTOL of one process's ``TrainStep``."""
    import os
    import pickle
    import shutil
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.parallel import join_spawned

    spec = dict(spec or {})
    t0 = time.perf_counter()
    base = ep_rows_run(False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ep_rows_")
    try:
        ctx = dist.spawn(_rank_ep_rows, (tmp, spec), nprocs=2, join=False,
                         backend="gloo", master=f"file://{tmp}/rendezvous")
        join_spawned(ctx, timeout)
        ranks = [pickle.load(open(os.path.join(tmp, f"rank{r}.pkl"), "rb"))
                 for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], base["losses"],
                                   rtol=EP_LOSS_RTOL,
                                   err_msg=f"55b rank {r}")
        if res["exchange_bytes"] or res["experts"] != 4 or \
                res["expert_axis"] != "data":
            raise AssertionError(f"55b rank {r}: {res}")
    out = dict(losses=base["losses"], ranks=[r["losses"] for r in ranks],
               seconds=time.perf_counter() - t0, card=smi)
    log(f"# phase 55b: MoE at dp 2 on {EP_ROWS}-row batches (the expert "
        f"axis over ranks holding the same tokens, 4 experts a rank, no "
        f"exchange): losses {ranks[0]['losses']} / {ranks[1]['losses']} "
        f"against one process's {base['losses']} (rel {EP_LOSS_RTOL}); "
        f"{out['seconds']:.1f} s  [{smi}]")
    return out


def vit_loader(n_batches):
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import FakeData

    data = FakeData(n_batches * VIT_BATCH, (3, VIT_HW, VIT_HW), VIT_CLASSES)
    return DataLoader(data, batch_size=VIT_BATCH, shuffle=False,
                      device=DEVICE)


def vit_fit(net, loader, level=None):
    """``Model.fit`` over ``loader`` (AdamW, cross entropy), under
    ``auto_cast(level)`` when given; returns the model, the losses and
    each step's end time (the loss is read each step: a sync)."""
    from paddle_tpu_torch import Model, amp
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Steps(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.t = [], [time.perf_counter()]

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.t.append(time.perf_counter())

    model = Model(net).prepare(
        topt.AdamW(learning_rate=VIT_LR, parameters=net.parameters()),
        tnn.CrossEntropyLoss())
    steps = Steps()
    with amp.auto_cast(enable=level is not None, level=level or "O1"):
        model.fit(loader, epochs=1, verbose=0, callbacks=[steps])
    return model, steps.losses, np.diff(steps.t)


def vit_flash_timing(fa, peaks):
    """K1, K2a and K2b at ViT-B/16's attention (B=VIT_BATCH, T=197, H=12,
    D=64, non-causal, unmasked), f32: each against its plain version,
    timed beside the plain versions, SDPA's forward and backward and the
    bound."""
    b, t, h, d = VIT_BATCH, (VIT_HW // 16) ** 2 + 1, 12, 64
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 55)
    q, k, v, do = flash_inputs(gen, b, t, t, h, h, d, torch.float32, True)
    worst = {}
    compare_flash(fa, q, k, v, do, None, False, False, worst,
                  f"ViT-B/16 B={b} T={t} H={h} D={d}")
    o, lse = fa.flash_attention_forward_cuda(q, k, v, None)
    delta = fa._delta(o, do).contiguous()
    qh, kh, vh = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    oh = sdpa(qh, kh, vh)
    doh = do.transpose(1, 2).contiguous()
    lib = {"fwd": cuda_ms(lambda: sdpa(qh, kh, vh)),
           "bwd": cuda_ms(lambda: torch.autograd.grad(
               oh, (qh, kh, vh), doh, retain_graph=True))}
    calls = {
        "fwd": (lambda: fa.flash_attention_forward_cuda(q, k, v, None),
                lambda: fa.flash_attention_forward_plain(q, k, v, None)),
        "dq": (lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, None, do,
                                                      lse, delta),
               lambda: fa.flash_attention_bwd_dq_plain(q, k, v, None, do,
                                                       lse, delta)),
        "dkv": (lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, None, do,
                                                        lse, delta),
                lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, None, do,
                                                         lse, delta))}
    rows = {}
    for kind, (kern, plain) in calls.items():
        r = dict(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=5, warm=1),
                 library_ms=lib["fwd" if kind == "fwd" else "bwd"],
                 max_abs_err=worst[kind],
                 **flash_bound(kind, q, k, False, peaks))
        rows[kind] = r
        log(f"{kind:3s} ViT-B/16 B={b} T={t} H={h} D={d} f32: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{'forward' if kind == 'fwd' else 'backward (dq+dk+dv)'} "
            f"{r['library_ms']:.4f} ms, {bound_text(r, r['ms'])}")
    del q, k, v, do, o, lse, delta, qh, kh, vh, oh
    free_card()
    return rows


def phase_vit(fa, smi, peaks):
    """Phase 55c: ViT-B/16 at full width (224 x 224, patch 16, 12 layers,
    hidden 768, 12 heads: T = 197, D = 64) through ``Model.fit`` over the
    port's ``FakeData``: VIT_STEPS steps in f32 on the dense route
    (``_sdpa_reference``) and on the kernels' route from the same weights,
    the losses within VIT_LOSS_RTOL; VIT_STEPS at O1; ``evaluate`` and
    ``predict``. K1 / K2a / K2b launched 12 a step (bf16 at O1), K1 12 an
    eval or predict batch; every parameter on the card."""
    from paddle_tpu_torch.nn.functional import attention as attn
    from paddle_tpu_torch.vision.models import vit_b_16

    t0 = time.perf_counter()
    layers = 12
    loader = vit_loader(VIT_STEPS)
    runs = {}
    for route in ("dense", "flash"):
        net = vit_b_16(num_classes=VIT_CLASSES, device=DEVICE, seed=SEED)
        bad = [n for n, p in net.named_parameters() if p.device.type !=
               torch.device(DEVICE).type]
        if bad:
            raise AssertionError(f"55c: parameters off the card: {bad}")
        reset_flash(fa)
        saved = attn._sdpa
        if route == "dense":
            attn._sdpa = attn._sdpa_dense
        try:
            model, losses, dt = vit_fit(net, loader)
        finally:
            attn._sdpa = saved
        runs[route] = dict(losses=losses, step_ms=1e3 * float(np.mean(
            dt[1:])), launches=flash_counts(fa))
    want = {k: layers * VIT_STEPS for k in ("fwd", "dq", "dkv")}
    got = {k: runs["flash"]["launches"][k] for k in want}
    if got != want or any(runs["dense"]["launches"].values()):
        raise AssertionError(f"55c: launches {runs['flash']['launches']} "
                             f"(dense {runs['dense']['launches']}), "
                             f"expected {want}")
    np.testing.assert_allclose(runs["flash"]["losses"],
                               runs["dense"]["losses"], rtol=VIT_LOSS_RTOL,
                               err_msg="55c f32 losses, flash vs dense")
    reset_flash(fa)
    net16 = vit_b_16(num_classes=VIT_CLASSES, device=DEVICE, seed=SEED)
    _, o1_losses, o1_dt = vit_fit(net16, loader, "O1")
    o1_launches = flash_counts(fa)
    del net16
    want16 = {f"{k}_bf16": layers * VIT_STEPS for k in ("fwd", "dq", "dkv")}
    if {k: o1_launches[k] for k in want16} != want16 or \
            not np.isfinite(o1_losses).all():
        raise AssertionError(f"55c O1: launches {o1_launches}, losses "
                             f"{o1_losses}")
    reset_flash(fa)
    ev_loader = vit_loader(VIT_EVAL_BATCHES)
    result = model.evaluate(ev_loader, verbose=0)
    eval_fwd = fa.launches_fwd
    predicted = model.predict(vit_loader(1))[0]
    predict_fwd = fa.launches_fwd - eval_fwd
    if eval_fwd != layers * VIT_EVAL_BATCHES or predict_fwd != layers or \
            fa.launches_dq or len(predicted) != 1 or \
            predicted[0].shape != (VIT_BATCH, VIT_CLASSES) or \
            not np.isfinite(predicted[0]).all():
        raise AssertionError(f"55c: evaluate {result} K1 {eval_fwd}, "
                             f"predict K1 {predict_fwd}")
    del model, net
    free_card()
    timing = vit_flash_timing(fa, peaks)
    out = dict(card=smi, f32_losses=runs["flash"]["losses"],
               dense_losses=runs["dense"]["losses"], o1_losses=o1_losses,
               step_ms=dict(f32=runs["flash"]["step_ms"],
                            f32_dense=runs["dense"]["step_ms"],
                            o1=1e3 * float(np.mean(o1_dt[1:]))),
               launches=dict(f32=got, o1=want16, eval_fwd=eval_fwd,
                             predict_fwd=predict_fwd),
               eval=result, timing={k: {x: r[x] for x in (
                   "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                   "bound_fma_ms", "max_abs_err")}
                   for k, r in timing.items()},
               seconds=time.perf_counter() - t0)
    log(f"# phase 55c: ViT-B/16 (224^2, batch {VIT_BATCH}, T=197, D=64) "
        f"through Model.fit: f32 losses {runs['flash']['losses']} vs dense "
        f"{runs['dense']['losses']} (rel {VIT_LOSS_RTOL}); step "
        f"{out['step_ms']['f32']:.1f} ms f32 (dense "
        f"{out['step_ms']['f32_dense']:.1f} ms), {out['step_ms']['o1']:.1f} "
        f"ms O1 (losses {o1_losses}); K1/K2a/K2b {got} f32, {want16} O1, "
        f"K1 {eval_fwd} evaluate + {predict_fwd} predict; evaluate "
        f"{result}; {out['seconds']:.1f} s  [{smi}]")
    return out


def phase_zoo(smi):
    """Phase 55d: one builder of each other family at its published input
    (224, 299 for Inception-v3, 28 x 28 x 1 for LeNet), 10 classes: an
    eval forward of ZOO_BATCH images on the card, its first ZOO_CPU_ROWS
    rows against the same weights on the CPU (ZOO_RTOL of the largest
    CPU logit); then MobileNetV3-Large trains ZOO_FIT_STEPS steps through
    ``Model.fit``."""
    import copy

    from paddle_tpu_torch.vision import models as zoo

    t0 = time.perf_counter()
    out = {}
    for name, ch, hw in ZOO_FAMILIES:
        cpu_net = getattr(zoo, name)(num_classes=10, device="cpu", seed=SEED)
        cpu_net.eval()
        net = copy.deepcopy(cpu_net).to(DEVICE)
        x = torch.randn((ZOO_BATCH, ch, hw, hw),
                        generator=torch.Generator().manual_seed(SEED))
        xd = x.to(DEVICE)
        with torch.no_grad():
            got = net(xd).float()
            ms = cuda_ms(lambda: net(xd), iters=5, warm=1)
            want = cpu_net(x[:ZOO_CPU_ROWS]).float()
        err = float((got[:ZOO_CPU_ROWS].cpu() - want).abs().max())
        scale = float(want.abs().max())
        if tuple(got.shape) != (ZOO_BATCH, 10) or \
                not torch.isfinite(got).all() or not err <= ZOO_RTOL * scale:
            raise AssertionError(f"55d {name}: {tuple(got.shape)}, card vs "
                                 f"CPU {err:.3e} of {scale:.3e}")
        out[name] = dict(input=[ch, hw, hw], ms=ms, err=err, scale=scale,
                         params=sum(p.numel() for p in net.parameters()))
        log(f"55d {name} {ch}x{hw}x{hw}: eval batch {ZOO_BATCH} {ms:.2f} ms,"
            f" card vs CPU {err:.2e} of {scale:.3e}")
        del net, cpu_net
    free_card()
    from paddle_tpu_torch import Model
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.datasets import FakeData

    net = zoo.mobilenet_v3_large(num_classes=10, device=DEVICE, seed=SEED)
    model = Model(net).prepare(
        topt.Momentum(0.05, 0.9, parameters=net.parameters()),
        tnn.CrossEntropyLoss())
    data = FakeData(ZOO_FIT_STEPS * ZOO_BATCH, (3, ZOO_FIT_HW, ZOO_FIT_HW),
                    10)
    losses = []

    from paddle_tpu_torch.hapi.callbacks import Callback

    class Losses(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    model.fit(DataLoader(data, batch_size=ZOO_BATCH, shuffle=False,
                         device=DEVICE), epochs=1, verbose=0,
              callbacks=[Losses()])
    if len(losses) != ZOO_FIT_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"55d: MobileNetV3-Large fit losses {losses}")
    out["mobilenet_v3_large_fit"] = losses
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 55d: {len(ZOO_FAMILIES)} families on the card against "
        f"the CPU (rel {ZOO_RTOL}, TF32 off); MobileNetV3-Large fit losses "
        f"{losses}; {out['seconds']:.1f} s  [{smi}]")
    del model, net
    free_card()
    return out


def transformer_decode(tm, route, memory, src_keep, emb, head, prefix):
    """Greedy T_NEW tokens of ``tm``'s decoder after ``prefix`` through
    ``route``'s cache (``concat``: a ``Cache`` growing by concatenation;
    ``static``: one of ``max_length`` positions; ``paged``: a
    ``PagedCache``); returns the tokens and each step's top-2 margin."""
    dec = tm.decoder
    max_len = T_PREFIX + T_NEW
    if route == "concat":
        cache = dec.gen_cache(memory)
    elif route == "static":
        cache = dec.gen_cache(memory, max_length=max_len)
    else:
        cache = dec.gen_cache(memory, max_length=max_len, page_size=T_PAGE)
    toks, margins = [], []
    feed, pos = prefix, 0
    with torch.no_grad():
        for _ in range(T_NEW):
            t = feed.shape[1]
            x = emb[feed]
            if route == "concat":
                causal = torch.ones((t, t), dtype=torch.bool,
                                    device=x.device).tril()
                out, cache = dec(x, memory, causal if t > 1 else None,
                                 src_keep, cache)
            else:
                out, cache = dec(x, memory, None, src_keep, cache,
                                 cache_position=pos)
            pos += t
            logits = out[:, -1] @ head
            top = torch.topk(logits, 2).values
            margins.append((top[:, 0] - top[:, 1]).cpu())
            feed = logits.argmax(-1, keepdim=True)
            toks.append(feed.cpu())
    return torch.cat(toks, 1), torch.stack(margins, 1)


def phase_transformer_caches(pa, fa, smi):
    """Phase 55e: ``nn.Transformer`` at Transformer-base's widths (d_model
    512, 8 heads, FFN 2048, 6 + 6 layers) with a seeded embedding and
    head: T_SOURCES sources of T_SRC_LEN tokens under a padding mask
    (K1 with its bias in the encoder and the cross-attention), greedy
    T_NEW tokens after a T_PREFIX-token prefix through the three caches.
    Gates: the streams equal (or part where the decision's top-2 margin
    is below NEAR_TIE); K1 and K3 launched exactly as the routes call
    them: the concat route's self-attention K1 at every step, the static
    route's K1 (bool mask) for the prefix and ``decode_attention`` after,
    the paged route's K3 at every step; an MHA of head dim 32 raises on
    the card."""
    from paddle_tpu_torch import nn as tnn

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    tm = tnn.Transformer(**TRANSFORMER_BASE, device=DEVICE, generator=gen)
    tm.eval()
    d = TRANSFORMER_BASE["d_model"]
    layers = TRANSFORMER_BASE["num_decoder_layers"]
    emb = torch.randn((T_VOCAB, d), generator=gen, device=DEVICE)
    head = torch.randn((d, T_VOCAB), generator=gen, device=DEVICE) / d ** .5
    src = torch.randint(0, T_VOCAB, (T_SOURCES, T_SRC_LEN), generator=gen,
                        device=DEVICE)
    lengths = torch.tensor([T_SRC_LEN - 8 * i for i in range(T_SOURCES)],
                           device=DEVICE)
    src_keep = (torch.arange(T_SRC_LEN, device=DEVICE)[None, :]
                < lengths[:, None])[:, None, None, :]
    prefix = torch.randint(0, T_VOCAB, (T_SOURCES, T_PREFIX), generator=gen,
                           device=DEVICE)
    reset_flash(fa)
    with torch.no_grad():
        memory = tm.encoder(emb[src], src_keep)
    enc_k1 = fa.launches_fwd
    if enc_k1 != TRANSFORMER_BASE["num_encoder_layers"]:
        raise AssertionError(f"55e: encoder K1 {enc_k1}")
    routes = {}
    for route in ("concat", "static", "paged"):
        reset_flash(fa)
        reset_k3(pa)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, margins = transformer_decode(tm, route, memory, src_keep, emb,
                                           head, prefix)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        launches, tile, split, decode, verify = k3_counts(pa)
        routes[route] = dict(tokens=toks, margins=margins, seconds=secs,
                             k1=fa.launches_fwd, k3=dict(
                                 launches=launches, tile=tile, split=split,
                                 decode=decode, verify=verify))
    # each route's K1 / K3 launches from its calls: T_NEW decoder calls
    want_k1 = {"concat": 2 * layers * T_NEW,
               "static": layers * (T_NEW + 1), "paged": layers * T_NEW}
    for route, r in routes.items():
        k3 = r["k3"]["launches"]
        if r["k1"] != want_k1[route] or k3 != (
                layers * T_NEW if route == "paged" else 0):
            raise AssertionError(f"55e {route}: K1 {r['k1']} (expected "
                                 f"{want_k1[route]}), K3 {r['k3']}")
    ref = routes["concat"]
    partings = []
    for route in ("static", "paged"):
        a, b = routes[route]["tokens"], ref["tokens"]
        for row in range(T_SOURCES):
            diff = torch.nonzero(a[row] != b[row])
            if len(diff):
                j = int(diff[0])
                m = float(ref["margins"][row, j])
                partings.append(dict(route=route, row=row, token=j,
                                     margin=m))
                if not m < NEAR_TIE:
                    raise AssertionError(
                        f"55e {route}: row {row} parts from the concat "
                        f"route at token {j}, margin {m:.3e}")
    # a head dim the kernels do not take raises on the card (no silent
    # plain route)
    mha = tnn.MultiHeadAttention(64, 2, device=DEVICE)
    try:
        with torch.no_grad():
            mha(torch.zeros((1, 4, 64), device=DEVICE))
    except ValueError as e:
        refused = str(e)
    else:
        if DEVICE == "cuda":
            raise AssertionError("55e: MHA at head dim 32 ran on the card")
        refused = None
    out = {"card": smi, "partings": partings, "encoder_k1": enc_k1,
           "head_dim_32_refused": refused,
           "routes": {k: dict(seconds=r["seconds"], k1=r["k1"], k3=r["k3"],
                              tokens_per_s=T_SOURCES * T_NEW / r["seconds"])
                      for k, r in routes.items()},
           "seconds": time.perf_counter() - t0}
    log(f"# phase 55e: Transformer-base, {T_SOURCES} x {T_SRC_LEN} sources, "
        f"greedy {T_NEW} tokens: streams equal across the caches "
        f"(partings {partings}); "
        + "; ".join(f"{k} {v['tokens_per_s']:.1f} tokens/s K1 {v['k1']} K3 "
                    f"{v['k3']['launches']}"
                    for k, v in out["routes"].items())
        + f"; {out['seconds']:.1f} s  [{smi}]")
    del tm, memory, emb, head
    free_card()
    return out


def phase_55(pa, fa, smi, peaks):
    """Phase 55 (a-e); returns the ``phase55`` JSON line's numbers."""
    t0 = time.perf_counter()
    out = dict(mp_worker=phase_mp_worker(pa, fa, smi))
    out["ep_rows"] = phase_ep_rows(smi)
    free_card()
    out["vit"] = phase_vit(fa, smi, peaks)
    out["zoo"] = phase_zoo(smi)
    out["transformer"] = phase_transformer_caches(pa, fa, smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 55: {out['seconds']:.1f} s")
    return out


# -- phase 56: a decorated bf16 model served, MoE under O2, online flips ------

#: 56b: Llama-3-8B decorated O2 (bf16 parameters and activations) at
#: this depth (GPT-3 1.3B at its 24 layers)
P56_LLAMA_LAYERS = 2
#: 56b: a step's logits of the kernel and plain engines at identical
#: contexts within this many bf16 unit roundoffs (2^-8) of the step's
#: largest logit, as the CPU tests hold the two packages' first steps; a
#: stream may part from the plain engine's only at a near tie, a decision
#: whose top-2 margin is at most twice that of its largest logit (both
#: routes within the bound of the same logits)
P56_LOGIT_GAP_U = 8
BF16_U = 2.0 ** -8
#: 56c: per-step losses of the O2 MoE block, K4a / K4b against the plain
#: grouped matmul: both round each bf16 product to bf16 from f32 sums of
#: the same terms in another order, and the loss is a mean over 4096
#: tokens of squared errors of such outputs (4.65e-7 apart on the card);
#: a step moves the loss by 0.6-1.9 %, so this bound also has to fail a
#: K4b that drops one expert's gradient, which the phase shows on a
#: faulty control (:func:`faulty_drhs`)
P56_MOE_LOSS_RTOL = 1e-5
#: 56d: the two decoder layers the online flip changes, and by how much
P56_FLIP_LAYERS = (0, 1)
P56_FLIP_SCALE = 1.0 + 2.0 ** -4


def amp_decorate(model):
    """``model`` decorated O2 bf16 (bf16 parameters and activations)."""
    from paddle_tpu_torch import amp

    return amp.decorate(model, level="O2", dtype="bfloat16")


def phase_k3_bf16_query(pa, peaks, contexts, llama_contexts):
    """Phase 56a: K3 on a bf16 query against ``paged_attention_plain`` on
    the card, the bf16 output held to :func:`k3_bf16_tol`: GPT-3 1.3B's
    serving shapes (H = Hkv = 16: decode S=8 T=1, verify T=5, prefill
    T=1024) and Llama-3-8B's (Hkv = 8, G = 4: verify and prefill in the
    tile regime), D = 128, each pool dtype; then both timed as phase 4
    times the f32 query (bf16 pool, CUDA graph and host loop, SDPA in
    bf16, the bound with 2-byte q and out)."""
    rng = np.random.default_rng(SEED + 56)
    worst = {"tile": 0.0, "split": 0.0}
    for label, hkv, group, ctx in (("GPT-3 1.3B", 16, 1, contexts),
                                   ("Llama-3-8B", 8, 4, llama_contexts)):
        shapes = (("decode", dict(s=8, t=1, ctx=ctx)),
                  ("verify", dict(s=8, t=5, ctx=np.asarray(ctx) + 4)),
                  ("prefill", dict(s=1, t=1024, ctx=[1024])))
        for kv in ("f32", "bf16", "int8"):
            for name, sh in shapes:
                c = make_case(rng, hkv=hkv, group=group, d=128, kv=kv, **sh)
                c["q"] = c["q"].bfloat16()
                args, kw = case_args(c)
                expect = pa._k3_regime(sh["t"], group)
                tag = (f"56a {label} {name} kv={kv} q=bf16 [{expect}]")
                got = checked_call(pa, args, kw, expect, tag)
                ref = pa.paged_attention_plain(*args, **kw)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                tol = k3_bf16_tol(ref)
                worst[expect] = max(worst[expect], err)
                log(f"{tag} max_abs_err={err:.3e} (tol {tol:.3e})")
                if got.dtype != torch.bfloat16 or not err <= tol:
                    raise AssertionError(f"{tag}: kernel disagrees with "
                                         f"plain: {err} ({got.dtype})")
    timed = dict(
        gpt=time_main_shapes(pa, peaks, contexts, q_dtype=torch.bfloat16),
        llama=time_main_shapes(pa, peaks, llama_contexts, hkv=8, group=4,
                               q_dtype=torch.bfloat16))
    return dict(worst=worst, timed=timed)


def stream_agreement(got, want, prompts):
    """(tokens of ``got`` before its first parting from ``want``, the
    tokens equal position by position), each as a share of the new
    tokens."""
    prefix = same = total = 0
    for g, w, p in zip(got, want, prompts):
        g, w = np.asarray(g)[len(p):], np.asarray(w)[len(p):]
        eq = g == w
        prefix += int(np.argmin(eq)) if not eq.all() else len(eq)
        same += int(eq.sum())
        total += len(eq)
    return prefix / total, same / total


def checked_attend(pa, eng):
    """Wrap ``eng._attend`` so that each K3 call of the engine is held
    against ``paged_attention_plain`` on the same inputs (the layer's
    stored pool, its scales, the page tables, the start positions) within
    :func:`k3_bf16_tol`; returns the running numbers (calls, worst error
    and its share of the tolerance)."""
    seen = dict(calls=0, worst_err=0.0, worst_share=0.0)
    kernel_attend = eng._attend

    def attend(q, layer, tables, start):
        out = kernel_attend(q, layer, tables, start)
        ref = pa.paged_attention_plain(
            q.contiguous(), eng._kc[layer], eng._vc[layer], tables, start,
            k_scales=None if eng._ksc is None else eng._ksc[layer],
            v_scales=None if eng._vsc is None else eng._vsc[layer])
        err = (out.float() - ref.float()).abs().max().item()
        share = err / k3_bf16_tol(ref)
        seen["calls"] += 1
        seen["worst_err"] = max(seen["worst_err"], err)
        seen["worst_share"] = max(seen["worst_share"], share)
        if out.dtype != q.dtype or not share <= 1.0:
            raise AssertionError(f"K3 on the engine's inputs (layer "
                                 f"{layer}, q {tuple(q.shape)} {q.dtype}): "
                                 f"{err} against the plain version")
        return out

    eng._attend = attend
    return seen


def serve_decorated(pa, fa, model, prompts, kv, label, group, f32=None):
    """Phase 56b on one model and KV dtype: the timed kernel run (K3
    launches by regime against ``k3_expected``, tokens, a verify step,
    finite f32 logits); a run with every K3 call held against the plain
    version on its inputs (:func:`checked_attend`); the plain engine's
    free-running streams, each parting reported with the decision's top-2
    margin and largest logit (a full forward over the common context);
    the two in :func:`lockstep` (speculation off: teacher forcing needs
    one token a slot a step), every K3 call of the kernel engine held
    against the plain version there too, for each step's logit gap at
    identical contexts (prefills included) against P56_LOGIT_GAP_U."""
    from paddle_tpu_torch.inference.engine import DecodeEngine, SamplingParams

    eng = DecodeEngine(model, kv_dtype=kv, **engine_config())
    eng.warmup()
    for n in K3_COUNTERS:
        setattr(pa, n, 0)
    t0 = time.perf_counter()
    outs = serve(eng, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tile, split, decode, verify = k3_counts(pa)
    st = eng.stats()
    ad = eng.adapter
    want = k3_expected(pa, ad.num_layers, st, eng, group)
    if (tile, split, decode, verify) != want or launches != tile + split:
        raise AssertionError(f"56b {label} kv {kv}: K3 (tile, split, "
                             f"decode, verify) {(tile, split, decode, verify)}"
                             f", expected {want}")
    if st["verify_steps"] <= 0:
        raise AssertionError(f"56b {label}: no verify step")
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + NEW_TOKENS:
            raise AssertionError(f"56b {label}: a request's length")
    _, last = eng.last_step
    if last.dtype != torch.float32 or not torch.isfinite(last).all():
        raise AssertionError(f"56b {label}: logits {last.dtype}, finite "
                             f"{bool(torch.isfinite(last).all())}")
    pool_bytes = 2 * eng._kc.numel() * eng._kc.element_size() + (
        0 if eng._ksc is None else 2 * eng._ksc.numel() * 4)
    del eng
    t1 = time.perf_counter()
    eng = DecodeEngine(model, kv_dtype=kv, **engine_config())
    checked = checked_attend(pa, eng)
    serve(eng, prompts)
    del eng
    checked["seconds"] = time.perf_counter() - t1
    ref = serve(DecodeEngine(model, kv_dtype=kv, attn_kernel="plain",
                             **engine_config()), prompts)
    greedy = SamplingParams(max_new_tokens=NEW_TOKENS)
    partings = []
    for i, (a, b) in enumerate(zip(outs, ref)):
        if not np.array_equal(a, b):
            j = int(np.flatnonzero(np.asarray(a) != np.asarray(b))[0])
            margin, top = decision_margin(model, b, j, greedy, top=True)
            partings.append(dict(request=i, token=j - len(prompts[i]),
                                 margin=margin, top=top))
    if partings:
        report_divergence(fa, model, prompts, outs, ref)
    out = dict(kv=kv, tokens_per_s=st["total_tokens"] / wall, seconds=wall,
               pool_bytes=pool_bytes, partings=partings, checked=checked,
               streams_equal_plain=len(prompts) - len(partings),
               launches=dict(tile=tile, split=split, decode=decode,
                             verify=verify, launches=launches))
    one = dict(engine_config(), speculate_k=0)
    step_gaps = []
    t1 = time.perf_counter()
    kernel_eng = DecodeEngine(model, kv_dtype=kv, **one)
    lock_checked = checked_attend(pa, kernel_eng)
    _, mismatches, steps = lockstep(
        kernel_eng,
        DecodeEngine(model, kv_dtype=kv, attn_kernel="plain", **one),
        prompts, step_gaps)
    del kernel_eng
    gap = [g for g, _ in step_gaps]
    share = [g / (P56_LOGIT_GAP_U * BF16_U * top) for g, top in step_gaps]
    out.update(gap_first=gap[0], gap_median=float(np.median(gap)),
               gap_max=max(gap), gap_share_max=max(share),
               gap_share_step=int(np.argmax(share)),
               largest_logit=max(top for _, top in step_gaps),
               lockstep_checked=lock_checked,
               lockstep_mismatches=mismatches, lockstep_steps=steps,
               lockstep_seconds=time.perf_counter() - t1)
    if f32 is not None:
        out["agree_f32_prefix"], out["agree_f32_tokens"] = \
            stream_agreement(outs, f32["streams"], prompts)
    tokens = st["total_tokens"]
    parted = [(p["request"], p["token"], round(p["margin"], 5), p["top"])
              for p in partings]
    log(f"# phase 56b {label}, bf16 model, kv {kv}: {tokens} tokens in "
        f"{wall:.3f} s = {tokens / wall:.1f} tok/s"
        + (f" (phase 4's f32 model, bf16 KV: {f32['tokens_per_s']:.1f}; "
           f"tokens agreeing with it: {out['agree_f32_prefix']:.3f} before "
           f"the first parting, {out['agree_f32_tokens']:.3f} position by "
           f"position)" if f32 is not None else "")
        + f"; pool {pool_bytes / 2 ** 30:.3f} GiB"
        + (f" (f32 model's {f32['pool_bytes'] / 2 ** 30:.3f})"
           if f32 is not None else "")
        + f"; K3 {out['launches']} = k3_expected; {checked['calls']} K3 "
        f"calls on the engine's inputs within {checked['worst_share']:.2f} "
        f"of k3_bf16_tol (worst {checked['worst_err']:.3e}, "
        f"{checked['seconds']:.1f} s); streams equal to the plain engine "
        f"{out['streams_equal_plain']}/{len(prompts)}, partings "
        f"{parted}"
        + f"; lockstep {out['lockstep_steps']} steps: logit gap at "
        f"identical contexts first {out['gap_first']:.3e}, median "
        f"{out['gap_median']:.3e}, max {out['gap_max']:.3e} (largest "
        f"logit {out['largest_logit']:.3e}; worst step "
        f"{out['gap_share_step']} at {out['gap_share_max']:.3f} of "
        f"{P56_LOGIT_GAP_U} bf16 unit roundoffs of its largest logit), "
        f"{lock_checked['calls']} K3 calls within "
        f"{lock_checked['worst_share']:.2f} of k3_bf16_tol, token "
        f"mismatches {out['lockstep_mismatches']} "
        f"({out['lockstep_seconds']:.1f} s)")
    return out, outs


def phase_decorated_serving(pa, fa, smi, served_f32):
    """Phase 56b: GPT-3 1.3B (24 layers, phase 4's weights) decorated O2
    bf16 served through ``DecodeEngine`` (phase 4's geometry, speculation
    on) with bf16 and int8 KV; Llama-3-8B decorated at depth
    P56_LLAMA_LAYERS (GQA: K3's verify in the tile regime), bf16 KV. Gates:
    K3 launches = ``k3_expected``, every K3 call within
    :func:`k3_bf16_tol` of the plain version on the engine's own inputs,
    each step's logit gap at identical contexts (:func:`lockstep`)
    within P56_LOGIT_GAP_U bf16 unit roundoffs of its largest logit, each
    parting from the plain engine's stream at a near tie (a top-2 margin
    within twice that of the decision's largest logit). Reported:
    tokens/s and pool bytes beside phase 4's f32 model, the share of
    tokens agreeing with it."""
    t0 = time.perf_counter()
    model = amp_decorate(build_model(24))  # phase 4's weights
    if {p.dtype for p in model.parameters()} != {torch.bfloat16}:
        raise AssertionError("56b: the decorated model is not bf16")
    prompts = make_prompts(model.config.vocab_size)
    out = {"card": smi}
    for kv in ("bf16", "int8"):
        out[f"gpt_{kv}"], _ = serve_decorated(
            pa, fa, model, prompts, kv, "GPT-3 1.3B", 1, served_f32)
    del model
    free_card()
    llama = amp_decorate(build_llama(P56_LLAMA_LAYERS))
    lp = make_prompts(llama.config.vocab_size)
    g = LLAMA3_8B["num_attention_heads"] // LLAMA3_8B["num_key_value_heads"]
    out["llama_bf16"], _ = serve_decorated(
        pa, fa, llama, lp, "bf16", f"Llama-3-8B depth {P56_LLAMA_LAYERS}", g)
    del llama
    free_card()
    for k in ("gpt_bf16", "gpt_int8", "llama_bf16"):
        if not out[k]["gap_share_max"] <= 1.0:
            raise AssertionError(
                f"56b {k}: per-step logits K3 vs plain {out[k]['gap_max']} "
                f"(step {out[k]['gap_share_step']}) above {P56_LOGIT_GAP_U} "
                f"bf16 unit roundoffs of the step's largest logit")
        far = [p for p in out[k]["partings"] if not p["margin"]
               <= 2 * P56_LOGIT_GAP_U * BF16_U * abs(p["top"])]
        if far:
            raise AssertionError(f"56b {k}: streams part away from a near "
                                 f"tie: {far}")
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 56b: {out['seconds']:.1f} s  [{smi}]")
    return out


@contextlib.contextmanager
def faulty_drhs(gm):
    """A control for 56c's bound: K4b with its largest expert group's
    weight gradient zeroed."""
    saved = gm.grouped_matmul_drhs_cuda

    def drhs(lhs, dout, group_sizes):
        out = saved(lhs, dout, group_sizes)
        out[int(torch.argmax(group_sizes))] = 0
        return out

    try:
        gm.grouped_matmul_drhs_cuda = drhs
        yield
    finally:
        gm.grouped_matmul_drhs_cuda = saved


def phase_moe_o2(gm, smi, moe_f32):
    """Phase 56c: phase 11's Mixtral 8x7B block (dim MOE_DIM, hidden
    MOE_HIDDEN, 8 experts, top-2, dropless) decorated O2 with its AdamW
    (f32 masters and moments), three steps under ``auto_cast("O2")``: K4a
    / K4b launched in bf16 on the model path, (3, 2) a step, all bf16;
    the losses against the same steps with the plain grouped matmul on a
    twin (P56_MOE_LOSS_RTOL), which a twin on a faulty K4b
    (:func:`faulty_drhs`) must exceed; step ms beside phase 11's f32."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    t0 = time.perf_counter()

    def build():
        model = build_moe(MOE_DIM, MOE_HIDDEN)
        opt = AdamW(parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0), **MOE_ADAMW)
        amp.decorate(model, opt, level="O2")

        def loss_fn(m, x, y):
            with amp.auto_cast(level="O2"):
                return moe_loss(m, x, y)

        return model, TrainStep(model, loss_fn, opt)

    steps = 3
    x, y = moe_batch(MOE_DIM)
    model, step = build()
    for n in ("launches_fwd", "launches_drhs", "launches_fwd_bf16",
              "launches_drhs_bf16"):
        setattr(gm, n, 0)
    losses, step_ms = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(step(x, y)))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
    launches = {"fwd": gm.launches_fwd, "drhs": gm.launches_drhs,
                "fwd_bf16": gm.launches_fwd_bf16,
                "drhs_bf16": gm.launches_drhs_bf16}
    dtypes = {str(p.dtype) for p in model.parameters()}
    del model, step
    free_card()
    model, step = build()
    with plain_grouped_matmul(gm):
        plain = [float(step(x, y)) for _ in range(steps)]
    del model, step
    model, step = build()
    with faulty_drhs(gm):
        faulty = [float(step(x, y)) for _ in range(steps)]
    del model, step, x, y
    free_card()
    want = {"fwd": 3 * steps, "drhs": 2 * steps, "fwd_bf16": 3 * steps,
            "drhs_bf16": 2 * steps}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    control = max(abs(a - b) / abs(b) for a, b in zip(faulty, plain))
    f32_ms = float(np.mean(moe_f32["step_ms"][1:])) if moe_f32 else None
    ms = float(np.mean(step_ms[1:]))
    out = dict(losses=losses, plain_losses=plain, rel=rel,
               faulty_losses=faulty, faulty_rel=control, step_ms=step_ms,
               mean_ms=ms, f32_mean_ms=f32_ms, launches=launches,
               param_dtypes=sorted(dtypes),
               seconds=time.perf_counter() - t0)
    log(f"# phase 56c: Mixtral 8x7B MoE block decorated O2: losses {losses} "
        f"vs the plain grouped matmul {plain} (max rel {rel:.2e}, rtol "
        f"{P56_MOE_LOSS_RTOL:.2e}; a K4b dropping one expert's gradient: "
        f"{faulty}, max rel {control:.2e}); step ms "
        f"{[round(v, 1) for v in step_ms]}"
        f", steps 1-2 mean {ms:.1f}"
        + (f" (phase 11 f32: {f32_ms:.1f})" if f32_ms else "")
        + f"; K4 launches {launches} (want {want}); parameters {dtypes}; "
        f"{out['seconds']:.1f} s  [{smi}]")
    if launches != want:
        raise AssertionError(f"56c: K4 launches {launches} != {want}")
    if dtypes != {"torch.bfloat16"} or not all(np.isfinite(losses)):
        raise AssertionError(f"56c: parameters {dtypes}, losses {losses}")
    if not rel <= P56_MOE_LOSS_RTOL:
        raise AssertionError(f"56c: losses differ from the plain grouped "
                             f"matmul: rel {rel}")
    if not control > P56_MOE_LOSS_RTOL:
        raise AssertionError(f"56c: the bound passes a faulty K4b: rel "
                             f"{control}")
    return out


def phase_online_flip(smi, model_cfg):
    """Phase 56d: an ``OnlineCoordinator`` publishes epoch 1 (decoder
    layers P56_FLIP_LAYERS scaled by P56_FLIP_SCALE, in bf16) of the
    decorated GPT-3 1.3B (``--amp-dtype bfloat16``, speculation off so
    every step runs the one decode program) to an in-process
    ``EngineSink`` and over a ``WireEngineSink`` to an ``EngineWorker``
    subprocess, while requests decode on both. Gates: the requests in
    flight at the flip finish equal to a no-flip run (epoch 0), the ones
    admitted after it equal to a fresh engine on the epoch-1 weights, on
    both engines, one of them (prompt 5) sharing a 256-token prefix with
    one in flight (prompt 4) and attaching none of its epoch-0 blocks (no
    prefix hit on either engine); the subprocess serves epoch 1 at its
    stop; the bytes streamed are the two layers' bf16 bytes, once for
    each engine."""
    import os
    import shutil
    import socket
    import tempfile
    from pathlib import Path

    from paddle_tpu_torch.distributed.fleet.supervisor import FlipJournal
    from paddle_tpu_torch.inference.engine import DecodeEngine
    from paddle_tpu_torch.runtime import TCPStore
    from paddle_tpu_torch.serving import Router
    from paddle_tpu_torch.serving.online import (EngineSink,
                                                 OnlineCoordinator,
                                                 WireEngineSink)
    from paddle_tpu_torch.serving.protocol import k_engine, unpack
    from paddle_tpu_torch.serving.worker import (build_arg_parser,
                                                 build_worker_model)

    t_phase = time.perf_counter()
    argv = serving_argv(model_cfg) + ["--speculate-k", "0", "--amp-dtype",
                                      "bfloat16"]
    args = build_arg_parser().parse_args(argv)
    model = build_worker_model(args)
    if {p.dtype for p in model.parameters()} != {torch.bfloat16}:
        raise AssertionError("56d: the worker model is not bf16")
    cfg = dict(serving_engine_config(), speculate_k=0)
    prompts = make_prompts(model_cfg["vocab"])
    # prompts 4 and 5 share a 256-token prefix: 4 is admitted before the
    # flip, 5 after it, so the epoch-0 blocks of 4 must not serve 5
    old = prompts[:3] + prompts[4:5]
    new = prompts[3:4] + prompts[5:]
    names = [f"gpt.decoder.{i}." for i in P56_FLIP_LAYERS]
    epoch1 = {n: (p.detach() * P56_FLIP_SCALE).to(p.dtype)
              for n, p in model.named_parameters()
              if any(n.startswith(k) for k in names)}
    layer_bytes = sum(v.numel() * v.element_size() for v in epoch1.values())

    def run(eng, ps):
        return [list(map(int, o)) for o in serve(eng, ps)]

    ref0 = run(DecodeEngine(model, **cfg), old)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    store = TCPStore("127.0.0.1", port, is_master=True, timeout=120.0)
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_online_"))
    env = dict(os.environ, PYTHONPATH=str(root))
    env.pop("PADDLE_TPU_TELEMETRY_DIR", None)
    log_f = open(tmp / "worker.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
         "--master", f"127.0.0.1:{port}", "--namespace", "p56",
         "--name", "p56w", *argv], cwd=root, env=env,
        stdout=subprocess.DEVNULL, stderr=log_f)
    out = {"card": smi}
    try:
        router = Router(store, namespace="p56", queue_limit=64, seed=SEED,
                        page_size=cfg["page_size"], engine_grace_s=300.0)
        t0 = time.perf_counter()
        while router.stats()["engines_alive"] < 1 or any(
                e.beat < 1 for e in router._engines.values()):
            if proc.poll() is not None:
                raise AssertionError("56d: worker exited: " + (
                    tmp / "worker.log").read_text()[-3000:])
            router.pump()
            time.sleep(0.01)
            if time.perf_counter() - t0 > 300:
                raise AssertionError("56d: the worker did not register")
        out["worker_ready_s"] = time.perf_counter() - t0
        addr = unpack(store.get(k_engine("p56", 0)))["addr"]
        eng = DecodeEngine(model, **cfg)
        coord = OnlineCoordinator(
            FlipJournal(str(tmp / "journal")),
            {"inproc": EngineSink(eng), "p56w": WireEngineSink(addr, "p56w")},
            ack_timeout_s=120.0)
        # epoch 0 in flight on both: the in-process slots mid-decode, the
        # worker's requests admitted (its beat reports them running)
        rid_old = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in old]
        for _ in range(3):
            eng.step()
        wid_old = [router.submit(p, slo="standard", max_new_tokens=NEW_TOKENS)
                   for p in old]
        t0 = time.perf_counter()
        while not any(e.occ.get("running", 0) >= len(old)
                      for e in router._engines.values()):
            router.pump()
            time.sleep(0.002)
            if time.perf_counter() - t0 > 120:
                raise AssertionError("56d: the worker did not admit")
        t0 = time.perf_counter()
        entry = coord.publish_epoch(1, epoch1)
        flip_s = time.perf_counter() - t0
        if eng.weight_epoch != 1:
            raise AssertionError("56d: the in-process engine did not flip")
        rid_new = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in new]
        wid_new = [router.submit(p, slo="standard", max_new_tokens=NEW_TOKENS)
                   for p in new]
        eng.run()
        t0 = time.perf_counter()
        while router.pending():
            router.pump()
            time.sleep(0.001)
            if time.perf_counter() - t0 > 300:
                raise AssertionError(f"56d undrained: {router.stats()}")
        got = dict(inproc_old=[list(map(int, eng.result(r)))
                               for r in rid_old],
                   inproc_new=[list(map(int, eng.result(r)))
                               for r in rid_new],
                   worker_old=[list(map(int, router.result(r)))
                               for r in wid_old],
                   worker_new=[list(map(int, router.result(r)))
                               for r in wid_new])
        pinned = eng.stats()["pinned_epochs"]
        hits = eng.stats()["prefix_hit_tokens"]
        router.shutdown()
        code = proc.wait(120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        log_f.close()
        store.close()
    text = (tmp / "worker.log").read_text()
    stop = [r for r in _worker_records(text, "serving_worker")
            if r["event"] == "stop"]
    shutil.rmtree(tmp, ignore_errors=True)
    # the epoch-1 yardstick: a fresh engine on the model, which holds the
    # epoch-1 values since the flip
    ref1 = run(DecodeEngine(model, **cfg), new)
    worker_hits = stop[0]["engine"].get("prefix_hit_tokens") if stop else None
    checks = dict(inproc_old=ref0, worker_old=ref0, inproc_new=ref1,
                  worker_new=ref1)
    equal = {k: sum(a == b for a, b in zip(got[k], checks[k]))
             for k in checks}
    out.update(flip_s=flip_s, entry_seconds=entry["seconds"],
               leaves=entry["leaves"], bytes=entry["bytes"],
               layer_bytes=layer_bytes, equal=equal, pinned_after=pinned,
               prefix_hits=dict(inproc=hits, worker=worker_hits),
               worker_exit=code,
               worker_epoch=stop[0]["engine"].get("weight_epoch")
               if stop else None)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 56d: online flip of decoder layers {P56_FLIP_LAYERS} "
        f"({len(epoch1)} leaves, {layer_bytes} bf16 bytes an engine) to an "
        f"in-process engine and a worker process (ready in "
        f"{out['worker_ready_s']:.1f} s) while {len(old)} requests decode "
        f"on each: flip {flip_s:.3f} s; journal {entry['leaves']} leaves, "
        f"{entry['bytes']} bytes; streams equal (in flight -> epoch 0, "
        f"admitted after -> epoch 1): {equal}; worker exit {code}, epoch "
        f"{out['worker_epoch']}; pinned epochs after {pinned}; prefix "
        f"hit tokens across the flip {out['prefix_hits']}; "
        f"{out['seconds']:.1f} s  [{smi}]")
    if code != 0 or out["worker_epoch"] != 1:
        raise AssertionError(f"56d: worker exit {code}, epoch "
                             f"{out['worker_epoch']}")
    if hits != 0 or worker_hits != 0:
        raise AssertionError(f"56d: a request admitted after the flip "
                             f"attached epoch-0 prefix blocks: "
                             f"{out['prefix_hits']}")
    if entry["bytes"] != 2 * layer_bytes or entry["leaves"] != 2 * len(
            epoch1):
        raise AssertionError(f"56d: streamed {entry['bytes']} bytes in "
                             f"{entry['leaves']} leaves, expected "
                             f"{2 * layer_bytes} in {2 * len(epoch1)}")
    if any(equal[k] != len(checks[k]) for k in checks) or pinned:
        for k in checks:
            for i, (a, b) in enumerate(zip(got[k], checks[k])):
                if a != b:
                    j = next(x for x in range(len(a)) if a[x] != b[x])
                    log(f"56d {k} request {i} parts at token {j}: {a[j]} "
                        f"vs {b[j]}")
        raise AssertionError(f"56d: streams {equal}, pinned {pinned}")
    del model
    free_card()
    return out


def phase_amp_debugging(smi):
    """Phase 56e: ``amp.debugging`` on the card: the operator stats of one
    O2 step of GPT-3 1.3B's widths at depth 2 (decorated, AdamW), then the
    tensor checker in ``CHECK_NAN_INF_AND_ABORT`` catching an ``inf``
    written into a layer norm's gain (restored after)."""
    from paddle_tpu_torch.amp import debugging as dbg

    t0 = time.perf_counter()
    model = build_model(2)
    step, _, _ = amp_trainer(model, ADAMW, "O2", False, decorate=True)
    ids, labels = train_batch(model.config.vocab_size)
    dbg.enable_operator_stats_collection()
    try:
        loss = float(step(ids, labels))
        torch.cuda.synchronize()
    finally:
        stats = dbg.disable_operator_stats_collection()
    by_dtype = {}
    for (_, dt), n in stats.items():
        by_dtype[dt] = by_dtype.get(dt, 0) + n
    if not (stats.get(("linear", "bfloat16"), 0) > 0
            and stats.get(("layer_norm_op", "float32"), 0) > 0
            and np.isfinite(loss)):
        raise AssertionError(f"56e: stats {stats}, loss {loss}")
    gain = model.gpt.decoder[1].ln_1.weight
    saved = gain.detach().clone()
    with torch.no_grad():
        gain[0] = float("inf")
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        debug_mode=dbg.DebugMode.CHECK_NAN_INF_AND_ABORT))
    caught = None
    try:
        from paddle_tpu_torch.amp import auto_cast

        with auto_cast(level="O2"), torch.no_grad():
            model(ids[:1, :64])
    except FloatingPointError as e:
        caught = str(e)
    finally:
        dbg.disable_tensor_checker()
        with torch.no_grad():
            gain.copy_(saved)
    out = dict(ops=len(stats), calls_by_dtype=by_dtype, loss=loss,
               caught=caught, seconds=time.perf_counter() - t0)
    log(f"# phase 56e: one O2 step of GPT-3 1.3B widths at depth 2 (loss "
        f"{loss:.5f}): {len(stats)} (op, dtype) entries, calls by dtype "
        f"{by_dtype}; checker on an inf in decoder.1.ln_1.weight: "
        f"{caught!r}; {out['seconds']:.1f} s  [{smi}]")
    if caught is None or "layer_norm_op" not in caught:
        raise AssertionError(f"56e: the checker did not abort at the norm: "
                             f"{caught}")
    del model, step
    free_card()
    return out


def phase_56(pa, fa, gm, smi, peaks, served, llama_served, moe_trained):
    """Phase 56 (a-e); returns the ``phase56`` JSON line's numbers. The
    f32 runs of phases 4, 13 and 11 (None in a run of phase 56 alone) give
    the contexts and the numbers beside."""
    t0 = time.perf_counter()
    ctx = served["contexts"] if served else [
        n + NEW_TOKENS // 2 for n in PROMPT_LENGTHS]
    lctx = llama_served["contexts"] if llama_served else ctx
    out = dict(k3_bf16=phase_k3_bf16_query(pa, peaks, ctx, lctx))
    free_card()
    out["serving"] = phase_decorated_serving(pa, fa, smi, served)
    out["moe_o2"] = phase_moe_o2(gm, smi, moe_trained)
    out["online"] = phase_online_flip(smi, SERVING_MODEL)
    out["debugging"] = phase_amp_debugging(smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 56: {out['seconds']:.1f} s")
    return out


# -- phase 57 -----------------------------------------------------------------

#: 57a's capped tenant: a bucket of 1 token a second (burst 1), which no
#: request (prompt + 32 new tokens) can pass
P57_CAPPED = "tenant_capped"
#: 57b: make_spec's "mixed" stream (20,000 requests/s) with an abusive
#: tenant at 20,000 requests/s from 0.25 s of virtual time; every tenant
#: under a bucket of 400,000 tokens/s (burst 100,000), above the Zipf
#: head's demand (~240,000 tokens/s) and below the abuser's (1.28 M)
P57_REQUESTS = 20_000
P57_ABUSE_RPS, P57_ABUSE_START_S = 20_000.0, 0.25
P57_QUOTA = dict(quota_rate_tokens_per_s=400_000.0,
                 quota_burst_tokens=100_000.0)
#: 57b: the stub tier's store keys left after a replay: the registrations
#: and beats, and at most one unreaped batch (4096) of done keys
P57_STORE_KEYS = 4096 + 64
#: 57c: profiled engine steps, after one closed and one ready step; each
#: request asks for enough tokens that no slot drains inside the window
#: (speculation emits up to k + 1 = 5 tokens a step)
P57_RECORD, P57_NEW_TOKENS = 8, 128
#: K3's kernels on the device timeline, by their names in
#: ops/cuda/paged_attention.cu: tile, or split then merge
K3_KERNELS = ("paged_tile_kernel", "paged_split_kernel",
              "paged_merge_kernel")
#: 57d: stack_samples against np.stack, repeats of phase 23's batch
P57_STACK_REPEATS = 200


def submit_frontier(frontier, prompts):
    """make_prompts' requests under tenants ``tenant{i % 3}``, every other
    one sampled (T 0.7, top-k 8), as :func:`submit_serving`."""
    return [frontier.submit(p, slo="standard", tenant=f"tenant{i % 3}",
                            max_new_tokens=NEW_TOKENS, do_sample=(i % 2 == 1),
                            temperature=0.7, top_k=8)
            for i, p in enumerate(prompts)]


def phase_frontier(pa, fa, smi, model, store, tdir, served_tps=None):
    """Phase 57a: the front tier at full width. GPT-3 1.3B (phase 49's
    model), phase 49's engine config a worker (SERVING_SLOTS slots, bf16
    KV). Two tiers, each ``FrontierRouter(seed=9)`` over store-dataplane
    leaves: one leaf over two ``EngineWorker`` s, then two leaves over one
    each. Gates: each request on ``rendezvous_rank(tenant, leaves, 9)[0]``;
    the two tiers' streams equal or parting at a near-tie (phase 49's
    rule); each tier's K3 launches by regime equal ``k3_expected_sum``; a
    ninth request, from a tenant whose bucket cannot cover it, shed at the
    front: in the frontier's counter and the tenant's ``shed_requests``
    (accounting on for that request only, so the timed run is phase 49a's
    untraced one), in no leaf's ``submitted`` or ``dispatched``. Reports
    tokens/s through each tier beside phase 49a's router."""
    from paddle_tpu_torch.serving import (EngineWorker, FrontierRouter,
                                          Router, rendezvous_rank)

    cfg = serving_engine_config()
    prompts = make_prompts(model.config.vocab_size)
    tiers = {"one_leaf": ["p57_one"], "two_leaves": ["p57_a", "p57_b"]}
    out, streams, params = {"card": smi}, {}, {}
    for tier, names in tiers.items():
        leaves = [Router(store, namespace=ns, queue_limit=64,
                         dataplane="store", page_size=cfg["page_size"])
                  for ns in names]
        workers = [EngineWorker(model, store, namespace=ns,
                                name=f"{ns}-e{j}", **cfg)
                   for ns in names for j in range(2 // len(names))]
        for w in workers:
            w.engine.warmup()
        frontier = FrontierRouter(leaves, seed=9,
                                  tenant_quotas={P57_CAPPED: (1.0, 1.0)})
        reset_k3(pa)
        gids = submit_frontier(frontier, prompts)
        wall = drive_router(frontier, workers)
        k3 = check_k3(pa, workers, f"57a {tier}")
        placed = [frontier.leaf_of(g) for g in gids]
        want = [rendezvous_rank(f"tenant{i % 3}", names, 9)[0]
                for i in range(len(prompts))]
        if placed != want:
            raise AssertionError(f"57a {tier}: placed {placed}, rendezvous "
                                 f"ranks first {want}")
        streams[tier] = [frontier.result(g) for g in gids]
        params[tier] = [frontier._leaves[n]._requests[r].params
                        for n, r in (frontier._placed[g] for g in gids)]
        tokens = sum(w.engine.stats()["total_tokens"] for w in workers)
        with live_telemetry(tdir, live=False):
            shed = frontier.submit(prompts[0], slo="standard",
                                   tenant=P57_CAPPED,
                                   max_new_tokens=NEW_TOKENS)
            charged = frontier._acct.per_tenant().get(P57_CAPPED, {})
        view = frontier.fleet_view()
        dispatched = sum(v["dispatched"] for v in view["leaves"].values())
        submitted = sum(leaf.counters["submitted"] for leaf in leaves)
        if (frontier.status(shed) != "shed"
                or frontier.counters["quota_shed"] != 1
                or charged.get("shed_requests") != 1
                or dispatched != len(prompts) or submitted != len(prompts)):
            raise AssertionError(
                f"57a {tier}: the capped tenant's request: status "
                f"{frontier.status(shed)}, frontier {frontier.counters}, "
                f"ledger {charged}, leaves dispatched {dispatched} / "
                f"submitted {submitted} of {len(prompts)}")
        out[tier] = dict(
            leaves=names, workers=[w.name for w in workers], wall_s=wall,
            tokens=tokens, tokens_per_s=tokens / wall, placed=placed,
            launches=k3, frontier=dict(frontier.counters),
            quota=view["quota"], leaf_dispatched={
                n: v["dispatched"] for n, v in view["leaves"].items()},
            shed_charged=charged.get("shed_requests"))
        log(f"# phase 57a {tier}: FrontierRouter(seed=9) over {names}, "
            f"{len(workers)} workers x {SERVING_SLOTS} slots: {tokens} "
            f"tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s (phase "
            f"49a's router: {served_tps if served_tps is None else round(served_tps, 1)} "
            f"tok/s); placed {placed}; K3 {k3}; the capped tenant's request "
            f"shed at the front (quota {view['quota']}, ledger "
            f"shed_requests {charged.get('shed_requests')}, leaves "
            f"dispatched {out[tier]['leaf_dispatched']})  [{smi}]")
        for leaf in leaves:
            leaf.shutdown()
        for w in workers:
            w.close()
        del workers, leaves, frontier
        free_card()
    if [p.seed for p in params["one_leaf"]] != [
            p.seed for p in params["two_leaves"]]:
        raise AssertionError("57a: the tiers stamped other seeds")
    out["partings"] = check_serving_streams(
        fa, model, prompts, params["one_leaf"], streams["two_leaves"],
        streams["one_leaf"], "57a", ("two leaves", "one leaf"))
    out["equal_streams"] = sum(
        np.array_equal(a, b)
        for a, b in zip(streams["one_leaf"], streams["two_leaves"]))
    out["router_49a_tokens_per_s"] = served_tps
    log(f"# phase 57a: streams equal across the tiers "
        f"{out['equal_streams']}/{len(prompts)}, near-tie partings "
        f"{len(out['partings'])}")
    return out


def phase_replay(smi):
    """Phase 57b: the control plane that 57a drives, on the card's host
    (no kernel runs). ``run_stub_replay`` of P57_REQUESTS requests of the
    ``mixed`` stream with an abusive tenant under quotas, through two
    leaves of four stub workers; then the same tier built and replayed by
    hand. Gates: the two digests equal, every request resolved, the
    MemStores reaped; two ``python -m paddle_tpu_torch.serving.replay``
    shard processes, started together, serve exactly the requests
    rendezvous hashing gives their leaves, and together the stream one
    leaf serves (every request resolved). Reports ``dispatch_rps``."""
    import itertools
    import os
    from collections import Counter
    from pathlib import Path

    from paddle_tpu_torch.serving import replay
    from paddle_tpu_torch.serving.frontier import rendezvous_rank

    t0 = time.perf_counter()
    spec = replay.make_spec("mixed", seed=0, abuse_rps=P57_ABUSE_RPS)
    spec["abuse"]["start_s"] = P57_ABUSE_START_S
    first = replay.run_stub_replay(spec, P57_REQUESTS, n_leaves=2,
                                   engines_per_leaf=4, **P57_QUOTA)
    clock = replay.VirtualClock()
    frontier, stubs, stores = replay.build_stub_tier(2, 4, clock,
                                                     **P57_QUOTA)
    second = replay.replay(frontier, stubs, clock, spec, P57_REQUESTS)
    kept = [len(s) for s in stores]
    abuser = first["tenants"].get("abuser", {})
    if (first["digest"] != second["digest"]
            or first["resolved"] != P57_REQUESTS
            or second["resolved"] != P57_REQUESTS
            or sum(kept) > P57_STORE_KEYS
            or not abuser.get("shed_quota")):
        raise AssertionError(
            f"57b: digests {first['digest']} / {second['digest']}, resolved "
            f"{first['resolved']} / {second['resolved']} of {P57_REQUESTS}, "
            f"store keys {kept}, the abuser {abuser}")

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    names = ["leaf0", "leaf1"]
    shard_spec = replay.make_spec("mixed", seed=0)  # the shard CLI's spec
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.replay", "--shard",
         me, "--leaves", ",".join(names), "--requests", str(P57_REQUESTS),
         "--seed", "0"], cwd=str(root), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for me in names]
    shards = {}
    try:
        whole = replay.run_leaf_shard(shard_spec, P57_REQUESTS, ["leaf0"],
                                      "leaf0")
        share = Counter(
            rendezvous_rank(replay._shard_key(ev["tenant"], ev["prompt"]),
                            names, 0)[0]
            for ev in itertools.islice(replay.arrivals(shard_spec),
                                       P57_REQUESTS))
        for me, p in zip(names, procs):
            so, se = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"57b: shard {me} exited "
                                     f"{p.returncode}: {se[-2000:]}")
            shards[me] = json.loads(so.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    served = sum(s["done"] + s["shed"] for s in shards.values())
    if (any(shards[me]["requests"] != share[me] for me in names)
            or sum(s["requests"] for s in shards.values()) != P57_REQUESTS
            or whole["requests"] != P57_REQUESTS or served != P57_REQUESTS
            or whole["done"] + whole["shed"] != P57_REQUESTS):
        raise AssertionError(f"57b: shards {shards}, rendezvous shares "
                             f"{dict(share)}, one leaf {whole}")
    out = dict(
        card=smi, requests=P57_REQUESTS, spec=spec, quota=P57_QUOTA,
        digest=first["digest"], store_keys=kept,
        runs=[{k: r[k] for k in ("wall_s", "virtual_s", "ticks",
                                 "dispatched", "dispatch_rps",
                                 "throughput_rps", "frontier")}
              for r in (first, second)],
        abuser=abuser, classes=first["classes"],
        shards={me: {k: s[k] for k in ("requests", "wall_s", "gen_s",
                                       "dispatched", "done", "shed")}
                for me, s in shards.items()},
        shard_dispatch_rps=sum(s["dispatched"] / s["wall_s"]
                               for s in shards.values()),
        one_leaf=dict(wall_s=whole["wall_s"], dispatched=whole["dispatched"],
                      dispatch_rps=whole["dispatched"] / whole["wall_s"]),
        seconds=time.perf_counter() - t0)
    log(f"# phase 57b: {P57_REQUESTS} replayed requests (mixed, abuser at "
        f"{P57_ABUSE_RPS:.0f} rps, quotas {P57_QUOTA}) through 2 leaves x 4 "
        f"stubs, twice: digest {first['digest'][:16]} both, dispatch_rps "
        f"{first['dispatch_rps']} / {second['dispatch_rps']} (virtual "
        f"{first['virtual_s']} s, {first['frontier']['quota_shed']} quota "
        f"sheds, the abuser's {abuser.get('shed_quota')}), store keys left "
        f"{kept}; shard processes {[shards[n]['requests'] for n in names]} "
        f"requests = rendezvous shares, {out['shard_dispatch_rps']:.1f} "
        f"dispatched/s summed vs one leaf "
        f"{out['one_leaf']['dispatch_rps']:.1f}; {out['seconds']:.1f} s  "
        f"[{smi}]")
    return out


def trace_k3(events):
    """K3's kernels on a torch.profiler chrome trace, by name."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {k: sum(1 for e in kernels if k in e.get("name", ""))
            for k in K3_KERNELS}, kernels


def busy_share(kernels, lo, hi):
    """The share of [lo, hi] (us) covered by the union of the kernels'
    intervals."""
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e.get("dur", 0), hi))
                   for e in kernels)
    busy, end = 0.0, lo
    for a, b in spans:
        if b <= a or b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / (hi - lo)


def phase_profiled_engine(pa, smi, model, tdir):
    """Phase 57c: ``paddle.profiler`` over phase 4's engine (GPT-3 1.3B,
    bf16 KV, engine_config()) serving make_prompts' 8 requests
    (P57_NEW_TOKENS new tokens each):
    ``Profiler(targets=[CPU, GPU], scheduler=make_scheduler(closed=1,
    ready=1, record=P57_RECORD))`` with a ``RecordEvent`` around each
    ``step()``. Gates: the device timeline holds K3's kernels, tile and
    split each as many as the wrapper's counters moved over the RECORD
    window (a merge after each split); P57_RECORD spans in the device
    trace, in the host export and through ``load_profiler_result``;
    ``summary()`` lists them with every call. Reports the device's busy
    and idle share of the window (the union of all kernels' intervals
    between the first span's start and the last span's end)."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference.engine import DecodeEngine

    eng = DecodeEngine(model, kv_dtype="bf16", **engine_config())
    eng.warmup()
    for p in make_prompts(model.config.vocab_size):
        eng.submit(p, max_new_tokens=P57_NEW_TOKENS)
    profiler.reset_host_events()
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=profiler.make_scheduler(closed=1, ready=1,
                                          record=P57_RECORD),
        on_trace_ready=profiler.export_chrome_tracing(tdir))
    marks = {}
    prof.start()
    for s in range(P57_RECORD + 2):
        if s == 2:
            marks["begin"] = k3_counts(pa)
        with profiler.RecordEvent("engine_step"):
            if not eng.step():
                raise AssertionError("57c: the engine ran out of work")
        prof.step()
    marks["end"] = k3_counts(pa)  # the window closed in the last step()
    prof.stop()
    moved = dict(zip(K3_COUNTERS, (b - a for a, b in zip(marks["begin"],
                                                         marks["end"]))))
    with open(prof.device_trace_path) as f:
        events = json.load(f)["traceEvents"]
    on_trace, kernels = trace_k3(events)
    spans = [e for e in events if e.get("name") == "engine_step"
             and e.get("cat") == "user_annotation"]
    host = profiler.load_profiler_result(tdir)
    with open(host.path) as f:
        host_raw = json.load(f)["traceEvents"]
    summary = prof.summary(sorted_by="calls")
    row = next((line for line in summary.splitlines()
                if line.startswith("engine_step")), "")
    log(f"57c: device trace {prof.device_trace_path}: {len(events)} events, "
        f"{len(kernels)} kernels, K3 on the trace {on_trace}, the wrapper's "
        f"counters moved {moved}; spans: device {len(spans)}, host "
        f"{host.count('engine_step')}")
    if not kernels:
        raise AssertionError("57c: the device trace holds no kernel")
    if (moved["launches"] <= 0
            or on_trace[K3_KERNELS[0]] != moved["launches_tile"]
            or on_trace[K3_KERNELS[1]] != moved["launches_split"]
            or on_trace[K3_KERNELS[2]] != moved["launches_split"]):
        raise AssertionError(f"57c: K3's kernels on the trace {on_trace}, "
                             f"the wrapper counted {moved}")
    if (len(spans) != P57_RECORD or host.count("engine_step") != P57_RECORD
            or sum(e["name"] == "engine_step" for e in host_raw)
            != P57_RECORD or row.split()[1:2] != [str(P57_RECORD + 2)]):
        raise AssertionError(
            f"57c: RecordEvent spans: device {len(spans)}, host "
            f"{host.count('engine_step')} of {P57_RECORD}; summary row "
            f"{row!r}")
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    busy = busy_share(kernels, lo, hi)
    k3_us = sum(e.get("dur", 0) for e in kernels
                if any(k in e.get("name", "") for k in K3_KERNELS))
    out = dict(card=smi, record_steps=P57_RECORD, window_ms=(hi - lo) / 1e3,
               kernels=len(kernels), k3_on_trace=on_trace, launches=moved,
               busy_share=busy, idle_share=1.0 - busy,
               k3_kernel_ms=k3_us / 1e3, summary_row=row.strip(),
               device_trace=prof.device_trace_path)
    log(f"# phase 57c: paddle.profiler over {P57_RECORD} engine steps of "
        f"GPT-3 1.3B (phase 4's engine): window {out['window_ms']:.1f} ms, "
        f"{len(kernels)} kernels on the device timeline, K3 {on_trace} = the "
        f"wrapper's {moved}; device busy {100 * busy:.1f} %, idle "
        f"{100 * (1 - busy):.1f} % of the window; K3 kernels "
        f"{out['k3_kernel_ms']:.2f} ms of it; summary row "
        f"{row.split()[:2]}  [{smi}]")
    del eng
    free_card()
    return out


def phase_host_runtime(smi, tdir):
    """Phase 57d: the host runtime and the callbacks. The native library
    (runtime/csrc/host_rt.cc, built by g++ on this host) must load: no
    silent fall-back here. ``stack_samples`` bit-equal to ``np.stack`` on
    phase 23's batch (32 samples of ids / types / mask [128] int64), ms a
    batch beside ``np.stack``. Then phase 23's ERNIE-3.0-base through
    ``Model.fit`` for 2 steps (an in-process loader, so its collate's
    ``stack_samples`` calls count here) with telemetry on and a
    ``VisualDL`` callback: one ``train_step`` event a batch with
    ``tokens_per_second``, one TSV row a batch and numeric log."""
    import os

    from paddle_tpu_torch import runtime
    from paddle_tpu_torch.hapi.callbacks import VisualDL
    from paddle_tpu_torch.io import DataLoader

    t0 = time.perf_counter()
    if not runtime.native_available():
        raise AssertionError("57d: the native host runtime did not load "
                             "(g++ build of runtime/csrc/host_rt.cc)")
    steps = 2
    net = build_ernie()
    data = PairData(steps * ERNIE_BATCH, net.config.vocab_size, ERNIE_SEQ,
                    SEED + 57)
    fields = [[data[i][f] for i in range(ERNIE_BATCH)] for f in range(3)]
    for f in fields:
        if not np.array_equal(runtime.stack_samples(f), np.stack(f)):
            raise AssertionError("57d: stack_samples differs from np.stack")
    timed = {}
    for name, fn in (("stack_samples", runtime.stack_samples),
                     ("np_stack", np.stack)):
        t1 = time.perf_counter()
        for _ in range(P57_STACK_REPEATS):
            for f in fields:
                fn(f)
        timed[name] = 1e3 * (time.perf_counter() - t1) / P57_STACK_REPEATS
    calls = []
    real = runtime.stack_samples
    runtime.stack_samples = lambda s, out=None: (calls.append(len(s))
                                                 or real(s, out))
    vdl = os.path.join(tdir, "visualdl")
    try:
        with live_telemetry(tdir, live=False):
            model = ernie_model(net)
            loader = DataLoader(data, batch_size=ERNIE_BATCH, shuffle=False,
                                device=DEVICE)
            model.fit(loader, epochs=1, verbose=0,
                      callbacks=[VisualDL(vdl)])
    finally:
        runtime.stack_samples = real
    with open(os.path.join(tdir, "events_rank0.jsonl")) as f:
        events = [json.loads(line) for line in f if line.strip()]
    step_events = [e for e in events if e["kind"] == "train_step"]
    with open(os.path.join(vdl, "scalars.tsv")) as f:
        rows = [tuple(line.split("\t")[:2]) for line in f if line.strip()]
    want_rows = [(str(s), k) for s in range(steps)
                 for k in ("loss", "batch_size")]
    if (len(step_events) != steps
            or not all(e.get("tokens_per_second", 0) > 0
                       for e in step_events)
            or rows != want_rows or calls != [ERNIE_BATCH] * 3 * steps):
        raise AssertionError(
            f"57d: train_step events {step_events}, TSV rows {rows}, "
            f"stack_samples calls {calls}")
    out = dict(card=smi, native=True, stack_ms=timed,
               batch=f"3 x {ERNIE_BATCH} x [{ERNIE_SEQ}] int64",
               host_memory=runtime.host_memory_stats(),
               train_steps=[{k: e[k] for k in ("step", "seconds", "loss",
                                               "tokens_per_second")}
                            for e in step_events],
               collate_stack_calls=len(calls),
               seconds=time.perf_counter() - t0)
    log(f"# phase 57d: native host runtime loaded; stack_samples "
        f"{timed['stack_samples']:.4f} ms a batch vs np.stack "
        f"{timed['np_stack']:.4f} ms ({out['batch']}, bit-equal); ERNIE "
        f"fit {steps} steps with telemetry: train_step tokens/s "
        f"{[round(e['tokens_per_second'], 1) for e in step_events]} "
        f"(samples/s, as the reference counts batch_size), VisualDL rows "
        f"{len(rows)}, collate stack_samples calls {len(calls)}; "
        f"{out['seconds']:.1f} s  [{smi}]")
    del model, net, loader
    free_card()
    return out


def phase_57(pa, fa, smi, serving=None):
    """Phase 57 (a-d); returns the ``phase57`` JSON line's numbers.
    ``serving`` (phase 49's, None in a run of phase 57 alone) gives 49a's
    tokens/s beside 57a's."""
    import tempfile

    from paddle_tpu_torch.runtime import TCPStore
    from paddle_tpu_torch.serving import worker as worker_mod

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p57_")
    model = worker_mod.build_worker_model(
        worker_mod.build_arg_parser().parse_args(
            serving_argv(SERVING_MODEL)))
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    log(f"# phase 57: GPT-3 1.3B (phase 49's worker model) built in "
        f"{time.perf_counter() - t0:.2f} s (set-up)")
    store = TCPStore("127.0.0.1", 0, is_master=True, timeout=120.0)
    served = (serving["router_2workers"]["tokens_per_s"] if serving
              else None)
    out = dict(frontier=phase_frontier(pa, fa, smi, model, store,
                                       f"{tmp}/57a", served))
    store.close()
    out["replay"] = phase_replay(smi)
    out["profiler"] = phase_profiled_engine(pa, smi, model, f"{tmp}/57c")
    del model
    free_card()
    out["host_runtime"] = phase_host_runtime(smi, f"{tmp}/57d")
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 57: {out['seconds']:.1f} s")
    return out



# -- phase 58: the deployment path -------------------------------------------

#: 58a: phase 23's padded batch and a smaller one from the same artifact,
#: and the batch the CPU runs it at
P58_ERNIE_SHAPES = ((ERNIE_BATCH, ERNIE_SEQ), (8, 64))
P58_CPU_SHAPE = (2, 32)
#: 58b / 58c: GPT-3 1.3B's widths at this depth, at these (B, T)
P58_GPT_LAYERS = 2
P58_GPT_SHAPES = ((2, 512), (1, 1024))
#: loaded program vs the eager model on the card, max |err| / max |logit|:
#: the same kernels on the same weights, the program's aten ops where the
#: eager model's run (cuBLAS may pick another algorithm for a matmul
#: whose operand is laid out otherwise)
P58_RTOL = 1e-5
#: the artifact on the CPU vs on the card: K1 (TF32 tensor cores, three
#: passes) against the CPU's f32 routes through 12 post-LN layers
P58_CPU_RTOL = 1e-4
#: 58c: the to_static step's loss and gradients vs the eager step's: the
#: same eager calls, so equal up to the kernels' run-to-run order
P58_STEP_RTOL = 1e-6
P58_TIMED_RUNS = 10


def rel_err(got, want):
    """max |got - want| / max |want| in f64, on ``want``'s device (an
    array is read as a tensor)."""
    want = torch.as_tensor(want).detach()
    got = torch.as_tensor(got).detach().to(want.device, torch.float64)
    want = want.double()
    return float((got - want).abs().max() / want.abs().max())


def file_bytes(prefix):
    import os

    return sum(os.path.getsize(prefix + ext)
               for ext in (".pdmodel", ".pdiparams", ".pdmeta"))


def median_ms(fn, n=P58_TIMED_RUNS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def phase_deploy_ernie(fa, smi, tmp):
    """Phase 58a (see the module docstring)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn.functional import attention as tattn

    t0 = time.perf_counter()
    net = build_ernie().eval()
    vocab = net.config.vocab_size
    prefix = f"{tmp}/ernie"
    spec = [paddle.jit.InputSpec([None, None], "int64", n)
            for n in ("input_ids", "token_type_ids", "attention_mask")]
    t1 = time.perf_counter()
    paddle.jit.save(net, prefix, input_spec=spec)
    save_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    predictor = paddle.inference.create_predictor(
        paddle.inference.Config(prefix))
    load_s = time.perf_counter() - t1
    layers = net.config.num_hidden_layers
    runs, batches = {}, []
    for i, (b, t) in enumerate(P58_ERNIE_SHAPES):
        data = PairData(b, vocab, t, SEED + 58 + i)
        inputs = [data.ids, data.types, data.mask]
        batches.append(inputs)
        reset_flash(fa)
        got = predictor.run(inputs)[0]
        launches = fa.launches_fwd
        with torch.no_grad():
            want = net(*(torch.from_numpy(a).to(DEVICE) for a in inputs))
        err = rel_err(got, want)
        same = bool(np.array_equal(got.argmax(-1),
                                   want.argmax(-1).cpu().numpy()))
        if err > P58_RTOL or not same or launches != layers:
            raise AssertionError(
                f"58a: B={b} T={t}: logits rel err {err:.3e} (gate "
                f"{P58_RTOL}), argmax equal {same}, K1 launches {launches} "
                f"(want {layers})")
        runs[f"B{b}_T{t}"] = dict(rel_err=err, k1_launches=launches)
    # the same artifact on the CPU: the dense route, then K1's plain version
    data = PairData(P58_CPU_SHAPE[0], vocab, P58_CPU_SHAPE[1], SEED + 60)
    inputs = [data.ids, data.types, data.mask]
    card = predictor.run(inputs)[0]
    config = paddle.inference.Config(prefix + ".pdmodel")
    config.disable_gpu()
    cpu = paddle.inference.create_predictor(config)
    cpu_err = {}
    for route in ("dense", "flash_plain"):
        tattn._FLASH_ON_CPU = route == "flash_plain"
        try:
            reset_flash(fa)
            cpu_err[route] = rel_err(cpu.run(inputs)[0], card)
        finally:
            tattn._FLASH_ON_CPU = False
        if cpu_err[route] > P58_CPU_RTOL or fa.launches_fwd:
            raise AssertionError(
                f"58a: the CPU's {route} route vs the card: rel err "
                f"{cpu_err[route]:.3e} (gate {P58_CPU_RTOL}), K1 launches "
                f"{fa.launches_fwd} (want 0)")
    del cpu
    # ms a batch at phase 23's shape: the predictor on staged handles
    # (uploaded once), the eager model on the same tensors on the card
    for name, a in zip(predictor.get_input_names(), batches[0]):
        predictor.get_input_handle(name).copy_from_cpu(a)
    dev = [torch.from_numpy(a).to(DEVICE) for a in batches[0]]
    with torch.no_grad():
        pred_ms = median_ms(predictor.run)
        eager_ms = median_ms(lambda: net(*dev))
    out = dict(card=smi, layers=layers, save_s=save_s, load_s=load_s,
               bytes=file_bytes(prefix), runs=runs, cpu_rel_err=cpu_err,
               predictor_ms=pred_ms, eager_ms=eager_ms,
               timed_shape=f"B={P58_ERNIE_SHAPES[0][0]} "
                           f"T={P58_ERNIE_SHAPES[0][1]}",
               k1_launches=sum(r["k1_launches"] for r in runs.values()),
               seconds=time.perf_counter() - t0)
    log(f"# phase 58a: ERNIE-3.0-base saved (export + save {save_s:.2f} s, "
        f"{out['bytes']:,} B) and loaded by create_predictor "
        f"({load_s:.2f} s); {runs} against eager, K1 {layers} a run; the "
        f"CPU's routes at B=2 T=32 vs the card {cpu_err}; "
        f"{out['timed_shape']}: predictor {pred_ms:.3f} ms a batch vs "
        f"eager {eager_ms:.3f} ms (median of {P58_TIMED_RUNS}); "
        f"{out['seconds']:.1f} s  [{smi}]")
    del predictor, net, dev
    free_card()
    return out


def phase_deploy_gpt(fa, smi, tmp):
    """Phases 58b and 58c (see the module docstring); removes ``tmp``
    (58a's files too) after 58b."""
    import shutil

    import paddle_tpu_torch as paddle

    t0 = time.perf_counter()
    model = build_model(P58_GPT_LAYERS).eval()
    prefix = f"{tmp}/gpt"
    t1 = time.perf_counter()
    paddle.jit.save(model, prefix, input_spec=[
        paddle.jit.InputSpec([None, None], "int64", "input_ids")])
    save_s = time.perf_counter() - t1
    nbytes = file_bytes(prefix)
    t1 = time.perf_counter()
    loaded = paddle.jit.load(prefix)
    load_s = time.perf_counter() - t1
    rng = np.random.default_rng(SEED + 61)
    batches = [torch.from_numpy(rng.integers(0, model.config.vocab_size,
                                             shape)).to(DEVICE)
               for shape in P58_GPT_SHAPES]
    translated = {}
    for ids in batches:
        reset_flash(fa)
        got = loaded(ids)
        launches = fa.launches_fwd
        with torch.no_grad():
            want = model(ids)
        err = rel_err(got, want)
        if err > P58_RTOL or launches != P58_GPT_LAYERS:
            raise AssertionError(
                f"58b: {tuple(ids.shape)}: logits rel err {err:.3e} (gate "
                f"{P58_RTOL}), K1 launches {launches} (want "
                f"{P58_GPT_LAYERS})")
        translated[f"B{ids.shape[0]}_T{ids.shape[1]}"] = dict(
            rel_err=err, k1_launches=launches)
        del got, want
    del loaded
    shutil.rmtree(tmp)
    b_s = time.perf_counter() - t0
    log(f"# phase 58b: GPT-3 1.3B widths at depth {P58_GPT_LAYERS} saved "
        f"(export + save {save_s:.2f} s, {nbytes:,} B), jit.load "
        f"{load_s:.2f} s; TranslatedLayer {translated} against eager; the "
        f"files removed; {b_s:.1f} s  [{smi}]")

    # 58c: to_static on the same model
    t0 = time.perf_counter()
    with torch.no_grad():
        eager_out = [model(ids) for ids in batches]
    ids = batches[0]
    model.train()
    reset_flash(fa)
    loss = model(ids, labels=ids)
    loss.backward()
    eager_step = (loss.item(), {n: p.grad for n, p in
                                model.named_parameters()})
    for p in model.parameters():
        p.grad = None
    model.eval()
    paddle.jit.to_static(model)
    try:
        with torch.no_grad():
            equal = [bool(torch.equal(model(x), e))
                     for x, e in zip(batches, eager_out)]
        cache = model.forward.program_cache_size
        model.train()
        loss = model(ids, labels=ids)
        loss.backward()
        loss_err = abs(loss.item() - eager_step[0]) / abs(eager_step[0])
        grad_err = max(rel_err(p.grad, eager_step[1][n])
                       for n, p in model.named_parameters())
    finally:
        del model.forward
    launches = {k: getattr(fa, f"launches_{k}") for k in ("fwd", "dq", "dkv")}
    if (not all(equal) or cache != len(P58_GPT_SHAPES)
            or loss_err > P58_STEP_RTOL or grad_err > P58_STEP_RTOL):
        raise AssertionError(
            f"58c: outputs equal {equal}, program_cache_size {cache} (want "
            f"{len(P58_GPT_SHAPES)}), loss rel err {loss_err:.3e}, "
            f"gradients rel err {grad_err:.3e} (gate {P58_STEP_RTOL})")
    c_s = time.perf_counter() - t0
    log(f"# phase 58c: to_static outputs equal to eager {equal}, "
        f"program_cache_size {cache}; one step's loss rel err "
        f"{loss_err:.3e}, gradients {grad_err:.3e}; K1 / K2a / K2b "
        f"{launches} over 58c's eager and to_static steps; {c_s:.1f} s  "
        f"[{smi}]")
    del model, eager_out, eager_step, batches
    free_card()
    return dict(
        translated=dict(card=smi, layers=P58_GPT_LAYERS, save_s=save_s,
                        load_s=load_s, bytes=nbytes, runs=translated,
                        seconds=b_s),
        to_static=dict(card=smi, outputs_equal=equal, program_cache_size=cache,
                       loss_rel_err=loss_err, grad_rel_err=grad_err,
                       launches=launches, seconds=c_s))


def phase_58(fa, smi):
    """Phase 58 (a-c); returns the ``phase58`` JSON line's numbers."""
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p58_")
    out = dict(ernie=phase_deploy_ernie(fa, smi, tmp))
    out.update(phase_deploy_gpt(fa, smi, tmp))
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 58: {out['seconds']:.1f} s")
    return out


def main(only=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import build

    t_start = time.perf_counter()
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"capability {cap} count {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: need compute capability 9.0, got {cap}")
    peaks = card_peaks(name)
    log(f"bounds use the H100 {peaks['form']} peaks: {peaks['bw'] / 1e12} "
        f"TB/s HBM, {peaks['f32'] / 1e12} TFLOP/s f32 FMA, "
        f"{peaks['tf32'] / 1e12} TF32 and {peaks['bf16'] / 1e12} bf16 "
        "TFLOP/s on tensor cores")

    t0 = time.perf_counter()
    build.library()
    log(f"# phase 2: kernels built in {time.perf_counter() - t0:.2f} s "
        "(set-up)")
    if only == "--phase56":  # phase 56 alone (and phase 5's lockstep)
        phase_engine_parity(lambda: build_model(2), "GPT-3 1.3B depth 2", 5)
        p56 = phase_56(pa, fa, gm, smi, peaks, None, None, None)
        log(json.dumps({"phase56": p56}, default=str))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if only == "--phase57":  # phase 57 alone, for development
        p57 = phase_57(pa, fa, smi)
        log(json.dumps({"phase57": p57}, default=str))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if only == "--phase58":  # phase 58 alone, for development
        p58 = phase_58(fa, smi)
        log(json.dumps({"phase58": p58}, default=str))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0

    sweep_err = phase_kernel_sweep(pa)
    flash_err = phase_flash_sweep(fa)
    served = phase_serving(pa, fa, smi, lambda: build_model(24),
                           "GPT-3 1.3B", 4)
    timed = time_main_shapes(pa, peaks, served["contexts"])
    phase_engine_parity(lambda: build_model(2), "GPT-3 1.3B depth 2", 5)
    flash_timed = phase_flash_timing(fa, peaks)
    trained = phase_training(fa, smi, lambda: build_model(24), ADAMW,
                             "GPT-3 1.3B", 7)
    phase_train_lockstep(fa, lambda: build_model(2), ADAMW,
                         "GPT-3 1.3B depth 2", 8)
    gmm_err = phase_gmm_sweep(gm)
    gmm_timed = phase_gmm_timing(gm, peaks)
    moe_trained = phase_moe_training(gm, smi)
    phase_moe_lockstep(gm)

    torch.cuda.empty_cache()
    g = LLAMA3_8B["num_attention_heads"] // LLAMA3_8B["num_key_value_heads"]
    llama_served = phase_serving(
        pa, fa, smi, lambda: build_llama(LLAMA3_8B["num_hidden_layers"]),
        f"Llama-3-8B ({LLAMA3_8B['num_hidden_layers']} layers, G={g})", 13,
        gate_kv="f32")
    phase_engine_parity(lambda: build_llama(2), "Llama-3-8B depth 2", 14)
    log("# phase 15: K1 / K2 and K3 at the Llama-3-8B shapes")
    llama_flash = phase_flash_timing(
        fa, peaks, h=LLAMA3_8B["num_attention_heads"],
        hkv=LLAMA3_8B["num_key_value_heads"], strided=False)
    llama_k3 = time_main_shapes(pa, peaks, llama_served["contexts"],
                                hkv=LLAMA3_8B["num_key_value_heads"],
                                group=g)
    llama_trained = phase_training(
        fa, smi, lambda: build_llama(LLAMA_TRAIN_LAYERS), LLAMA_ADAMW,
        f"Llama-3-8B widths at depth {LLAMA_TRAIN_LAYERS}", 16)
    phase_train_lockstep(fa, lambda: build_llama(2), LLAMA_ADAMW,
                         "Llama-3-8B widths at depth 2", 17)
    step_ms = np.mean(llama_trained["step_ms"][1:])
    amp_runs = phases_amp(fa, smi, trained, llama_trained)
    encoders, enc_timed, enc_lockstep = phases_encoders(fa, smi, peaks)
    vision = phases_vision(smi, peaks)
    generation = phases_generation(fa, pa, smi)
    layer = phases_layer(fa, smi)
    distributed = phases_distributed(fa, smi, trained)
    pipeline = phases_pipeline(fa, smi, trained)
    torch.cuda.empty_cache()
    sep_ep = phases_sep_ep(fa, smi, trained)
    torch.cuda.empty_cache()
    zero3 = phases_zero3_wires(fa, smi, trained)
    torch.cuda.empty_cache()
    compose = phase_pp_compose(smi)
    torch.cuda.empty_cache()
    a3 = phases_a3(fa, smi, peaks, encoders["bert_mlm"]["f32"])
    torch.cuda.empty_cache()
    auto = phase_auto_parallel(smi)
    torch.cuda.empty_cache()
    serving = phase_serving_tier(pa, fa, smi)
    torch.cuda.empty_cache()
    mpmd = phase_mpmd(fa, smi)
    elastic = phase_launch_elastic(smi)
    table = phase_sharded_table(smi)
    torch.cuda.empty_cache()
    live_sup = phases_live_supervisor(pa, fa, smi, serving, mpmd, timed)
    torch.cuda.empty_cache()
    mp_sep = phase_mp_sep_hapi(pa, fa, smi)
    torch.cuda.empty_cache()
    p55 = phase_55(pa, fa, smi, peaks)
    torch.cuda.empty_cache()
    p56 = phase_56(pa, fa, gm, smi, peaks, served, llama_served, moe_trained)
    torch.cuda.empty_cache()
    p57 = phase_57(pa, fa, smi, serving)
    torch.cuda.empty_cache()
    p58 = phase_58(fa, smi)
    log(json.dumps({"llama3_8b": {
        "card": smi,
        "serving": {k: llama_served[k] for k in ("tokens_per_s", "decode_ms",
                                                 "prefill_ms", "launches")},
        "training": {"layers": LLAMA_TRAIN_LAYERS, "step_ms": step_ms,
                     "tokens_per_s": llama_trained["tokens"] / step_ms * 1e3,
                     "peak_gib": llama_trained["peak_bytes"] / 2 ** 30,
                     "launches": llama_trained["launches"]},
        "flash": {f"{kind} {str(dt)[6:]}": {
            k: r[k] for k in ("ms", "plain_ms", "library_ms",
                              "library_repeat_ms", "pair_ms", "bound_ms",
                              "bound_fma_ms") if k in r}
            for (kind, dt), r in llama_flash.items()},
        "paged": {shape: {k: r[k] for k in (
            "regime", "ms", "plain_ms", "library_ms", "loop_ms", "bound_ms",
            "bound_fma_ms")} for shape, r in llama_k3.items()},
    }}))

    def row(name, source, replaces, launches, err, r, timed_as="host loop"):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "bound_fma_ms": r["bound_fma_ms"],
               "library_ms": r["library_ms"], "timed_as": timed_as}
        if timed_as == "cuda graph":
            out.update({k: r[k] for k in ("loop_ms", "library_loop_ms",
                                          "plain_loop_ms")})
        if "pair_ms" in r:  # K2a + K2b, timed in turns with SDPA backward
            out["pair_ms"] = r["pair_ms"]
        return out

    def k3_live(regime):
        """Phase 53's K3 launches of one regime: 53a, 53b."""
        return ({"live_2workers": live_sup["live"]["launches"][regime]},
                {"supervisor_4workers":
                 live_sup["supervisor"]["launches"][regime]})

    def k3_serving(regime):
        """Phase 49's K3 launches of one regime, by run."""
        procs = serving["processes"]["workers"]
        return dict(
            router_2workers=serving["router_2workers"]["launches"][regime],
            **{f"disagg_{w}": serving["disagg"][w]["launches"][regime]
               for w in ("raw", "int8")},
            **{f"process_{n}_{r['event']}": r["k3"][f"launches_{regime}"]
               for n, r in procs.items()})

    def k3_mp(regime):
        """Phase 54a's K3 launches of one regime, by engine and rank."""
        return {f"{run}_rank{r}": res[f"launches_rank{r}"][regime]
                for run, res in mp_sep["serving"].items()
                if isinstance(res, dict) for r in (0, 1)}

    def k3_p55(regime):
        """Phase 55's K3 launches of one regime: each rank of 55a's
        workers, 55e's paged route."""
        return dict(**{f"worker_{n}": r[regime] for n, r in
                       p55["mp_worker"]["launches"].items()},
                    transformer_paged=p55["transformer"]["routes"]["paged"][
                        "k3"][regime])

    def k3_p56(shape):
        """Phase 56's K3 at this shape: the bf16-query times (56a) and the
        launches of the decorated models' serving runs (56b)."""
        regime = {"decode": "decode", "verify": "verify",
                  "prefill": "tile"}[shape]
        r = p56["k3_bf16"]["timed"]["gpt"][shape]
        return dict(
            bf16_query={k: r[k] for k in (
                "ms", "loop_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")},
            bf16_query_llama={k: p56["k3_bf16"]["timed"]["llama"][shape][k]
                              for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "regime")},
            launches_phase56={k: p56["serving"][k]["launches"][regime]
                              for k in ("gpt_bf16", "gpt_int8",
                                        "llama_bf16")})

    def k3_p57(regime):
        """Phase 57's K3 launches of one regime: each front tier (57a) and
        the profiled window (57c)."""
        moved = p57["profiler"]["launches"]
        return {"frontier_one_leaf": p57["frontier"]["one_leaf"][
                    "launches"][regime],
                "frontier_two_leaves": p57["frontier"]["two_leaves"][
                    "launches"][regime],
                "profiled_window": moved[f"launches_{regime}"]}

    def flash_p55(kind):
        """Phase 55's K1 / K2 launches of one kind at the 1.3B rows' kernel:
        ViT-B/16 (55c) in f32 and O1, Transformer-base (55e) by route."""
        vit = p55["vit"]["launches"]
        tr = p55["transformer"]
        out = {"vit_f32": vit["f32"][kind], "vit_o1_bf16": vit["o1"][
            f"{kind}_bf16"]}
        if kind == "fwd":
            out.update(vit_evaluate=vit["eval_fwd"],
                       vit_predict=vit["predict_fwd"],
                       transformer_encoder=tr["encoder_k1"],
                       **{f"transformer_{k}": r["k1"]
                          for k, r in tr["routes"].items()})
        return out

    def flash_p58(kind):
        """Phase 58's K1 / K2 launches of one kind: K1 in 58a's two
        gated predictor runs and in 58b's two TranslatedLayer calls; 58c
        from the eager step to the to_static step."""
        out = {"to_static": p58["to_static"]["launches"][kind]}
        if kind == "fwd":
            out.update(ernie_predictor=p58["ernie"]["k1_launches"],
                       gpt_translated=sum(
                           r["k1_launches"]
                           for r in p58["translated"]["runs"].values()))
        return out

    def flash_mp(kind):
        """Phase 54's K1 / K2 launches of one kind a rank: the masked ring
        probes and BERT at sep 2 (54b), ERNIE's fit at dp 2 (54c)."""
        out = {f"ring_{name}_rank{r}": res[name]["launches"][kind]
               for r, res in ((int(k[-1]), v)
                              for k, v in mp_sep["ring"].items())
               for name in res}
        for r in (0, 1):
            out[f"bert_sep2_rank{r}"] = mp_sep["bert"][
                f"launches_rank{r}"][kind]
            out[f"ernie_model_dp2_rank{r}"] = mp_sep["hapi"][
                f"launches_rank{r}"][kind]
        return out

    kernels = [
        dict(row(f"paged_attention_{shape}",
                 "paddle_tpu_torch/ops/cuda/paged_attention.cu",
                 "paddle_tpu/ops/pallas/paged_attention.py:81",
                 served["launches"][{"decode": "decode", "verify": "verify",
                                     "prefill": "tile"}[shape]],
                 max(sweep_err[timed[shape]["regime"]],
                     timed[shape]["max_abs_err"]), timed[shape],
                 "cuda graph"),
             launches_serving=k3_serving({"decode": "decode",
                                          "verify": "verify",
                                          "prefill": "tile"}[shape]),
             **dict(zip(("launches_live", "launches_supervisor"),
                        k3_live({"decode": "decode", "verify": "verify",
                                 "prefill": "tile"}[shape]))),
             launches_mp_serving=k3_mp({"decode": "decode",
                                        "verify": "verify",
                                        "prefill": "tile"}[shape]),
             launches_phase55=k3_p55({"decode": "decode",
                                      "verify": "verify",
                                      "prefill": "tile"}[shape]),
             launches_phase57=k3_p57({"decode": "decode",
                                      "verify": "verify",
                                      "prefill": "tile"}[shape]),
             **k3_p56(shape))
        for shape in ("decode", "verify", "prefill")]
    for kind, kernel in (("fwd", "flash_attention_fwd"),
                         ("dq", "flash_attention_bwd_dq"),
                         ("dkv", "flash_attention_bwd_dkv")):
        r = flash_timed[(kind, torch.float32)]
        gloo = distributed["gloo_two_ranks"]
        pp2 = pipeline["pp2_gloo"]
        kernels.append(dict(row(
            kernel, "paddle_tpu_torch/ops/cuda/flash_attention.cu",
            FLASH_REPLACES[kind], trained["launches"][kind],
            max(flash_err[kind], r["max_abs_err"]), r),
            launches_distributed=dict(
                fleet_nccl_1p3b=distributed["fleet_nccl_1p3b"][
                    "launches"][kind],
                **{f"gloo_{c}_rank{i}_h{gloo[c]['heads']}":
                   gloo[c]["launches" if i == 0 else "rank1_launches"][kind]
                   for c in FLEET_CONFIGS for i in (0, 1)}),
            launches_pipeline=dict(
                fold_1p3b=pipeline["fold_1p3b"]["launches"][kind],
                **{f"pp2_{c}_rank{i}":
                   pp2[c]["launches" if i == 0 else "rank1_launches"][kind]
                   for c in PP_CONFIGS for i in (0, 1)}),
            launches_sep={
                f"sep2_1p3b_rank{i}": sep_ep["sep_1p3b"][
                    "launches" if i == 0 else "rank1_launches"][kind]
                for i in (0, 1)},
            launches_zero3_wires=dict(
                **{f"zero3_1p3b_rank{i}": zero3["zero3_1p3b"][
                    "launches" if i == 0 else "rank1_launches"][kind]
                   for i in (0, 1)},
                **{f"grad_wire_{w}_rank{i}": zero3["grad_wire_dp2"][w][
                    "launches" if i == 0 else "rank1_launches"][kind]
                   for w in GRAD_WIRES for i in (0, 1)},
                **{f"mp_wire_int8_rank{i}": zero3["mp_wire_mp2"][
                    "launches" if i == 0 else "rank1_launches"][kind]
                   for i in (0, 1)},
                gradient_merge=zero3["gradient_merge"]["launches"][kind]),
            launches_pp_compose={
                f"{c}_rank{i}": compose[c]["ranks"][i]["launches"][
                    kind + ("_bf16" if COMPOSE_CONFIGS[c].get("bf16")
                            else "")]
                for c in COMPOSE_CONFIGS for i in range(COMPOSE_RANKS)
                if not COMPOSE_CONFIGS[c].get("plain_ring")},
            launches_a3=dict(
                bert_lamb=a3["bert_lamb"]["launches"][kind],
                **{f"gpt_mp2_lamb_rank{i}": a3["gpt_mp2_lamb"]["mp2_lamb"][
                    "launches" if i == 0 else "rank1_launches"][kind]
                   for i in (0, 1)},
                **{f"unpadded_{dt}": a3["unpadded"][dt]["launches"][kind]
                   for dt in ("float32", "bfloat16")}),
            launches_auto_parallel={
                f"parallelize_mp2_depth{AP_LAYERS}_rank{i}": auto["mp2"][
                    "launches" if i == 0 else "rank1_launches"][kind]
                for i in (0, 1)},
            launches_mpmd={name: r["launches"][kind]
                           for name, r in mpmd["runs"].items()},
            launches_elastic={
                f"{run}_rank{i}": elastic[run]["launches"][i][kind]
                for run in ("clean", "killed") for i in (0, 1)},
            launches_supervisor={
                f"mpmd_width{t['width']}_{j}": t["launches"][kind]
                for j, t in enumerate(live_sup["supervisor"]["train"])},
            launches_mp_sep_hapi=flash_mp(kind),
            launches_phase55=flash_p55(kind),
            launches_phase58=flash_p58(kind)))
    # the same three kernels at ViT-B/16's shape (phase 55c): the main
    # path's f32 launches (fit, and K1 in evaluate and predict)
    vit = p55["vit"]
    for kind, kernel in (("fwd", "flash_attention_fwd"),
                         ("dq", "flash_attention_bwd_dq"),
                         ("dkv", "flash_attention_bwd_dkv")):
        r = vit["timing"][kind]
        n = vit["launches"]["f32"][kind] + (
            vit["launches"]["eval_fwd"] + vit["launches"]["predict_fwd"]
            if kind == "fwd" else 0)
        kernels.append(dict(
            row(kernel, "paddle_tpu_torch/ops/cuda/flash_attention.cu",
                FLASH_REPLACES[kind], n, max(flash_err[kind],
                                             r["max_abs_err"]), r),
            shape=f"ViT-B/16 B={VIT_BATCH} T=197 H=12 D=64 unmasked",
            launches_o1_bf16=vit["launches"]["o1"][f"{kind}_bf16"]))
    # the same three kernels at the encoders' shapes (phase 26), with the
    # launches of the phases that ran them there: K1 in phase 23's evaluate
    # and predict, K2a / K2b in phase 24 (fit's attention is dense at
    # dropout 0.1); BERT's in phase 25's f32 run
    ernie_fwd = (encoders["ernie_finetune"]["eval_launches_fwd"]
                 + encoders["ernie_finetune"]["predict_launches_fwd"])
    bert_f32 = encoders["bert_mlm"]["f32"]["launches"]
    for shape, launches in (
            (f"ERNIE B={ERNIE_BATCH} T={ERNIE_SEQ} H=12 D=64 padded",
             {"fwd": ernie_fwd, "dq": enc_lockstep["dq"],
              "dkv": enc_lockstep["dkv"]}),
            (f"BERT B={BERT_BATCH} T={BERT_SEQ} H=12 D=64 padded",
             bert_f32)):
        rows_by = enc_timed["ernie" if shape.startswith("ERNIE") else "bert"]
        for kind, kernel in (("fwd", "flash_attention_fwd"),
                             ("dq", "flash_attention_bwd_dq"),
                             ("dkv", "flash_attention_bwd_dkv")):
            r = rows_by[(kind, torch.float32)]
            kernels.append(dict(
                row(kernel, "paddle_tpu_torch/ops/cuda/flash_attention.cu",
                    FLASH_REPLACES[kind], launches[kind],
                    max(flash_err[kind], r["max_abs_err"]), r),
                shape=shape, bf16_ms=rows_by[(kind, torch.bfloat16)]["ms"]))
    for kind, kernel, call, outs in (
            ("fwd", "grouped_matmul_fwd", "up fwd", ("out", "dlhs")),
            ("drhs", "grouped_matmul_drhs", "up drhs", ("drhs",))):
        r = gmm_timed[call]
        kernels.append(dict(row(
            kernel, "paddle_tpu_torch/ops/cuda/grouped_matmul.cu",
            GMM_REPLACES[kind], moe_trained["launches"][kind],
            max(r["max_abs_err"], *(gmm_err[o][0] for o in outs)), r),
            launches_o2_bf16=p56["moe_o2"]["launches"][f"{kind}_bf16"]))
    log(json.dumps({"amp": amp_runs}))
    log(json.dumps({"encoders": encoders}))
    log(json.dumps({"vision": vision}))
    log(json.dumps({"generation": generation}))
    log(json.dumps({"layer": layer}))
    log(json.dumps({"distributed": distributed}))
    log(json.dumps({"pipeline": pipeline}))
    log(json.dumps({"sep_ep": sep_ep}))
    log(json.dumps({"zero3_wires": zero3}))
    log(json.dumps({"pp_compose": compose}))
    log(json.dumps({"a3": a3}))
    log(json.dumps({"auto_parallel": auto}))
    log(json.dumps({"serving": serving}, default=str))
    log(json.dumps({"mpmd_elastic_ps": {"mpmd": mpmd, "elastic": elastic,
                                        "sharded_table": table}}))
    log(json.dumps({"live_supervisor": live_sup}, default=str))
    log(json.dumps({"mp_sep_hapi": mp_sep}, default=str))
    log(json.dumps({"phase55": p55}, default=str))
    log(json.dumps({"phase56": p56}, default=str))
    log(json.dumps({"phase57": p57}, default=str))
    log(json.dumps({"phase58": p58}, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--elastic-worker"]:  # a rank of phase 51
        elastic_worker(sys.argv[2])
        sys.exit(0)
    sys.exit(main(only=sys.argv[1] if sys.argv[1:2] in (
        ["--phase56"], ["--phase57"], ["--phase58"]) else None))
