#!/usr/bin/env python3
"""How far the kernel engine and the plain-attention engine drift apart,
by KV-cache dtype, on Llama-3-8B (``chip_smoke.py``'s configuration,
random weights from its seed) on one CUDA card.

    python3 scripts/engine_kv_drift.py [--layers 32 2]

For each depth and each KV dtype (f32, bf16, int8):

- both engines serve ``chip_smoke.make_prompts`` as phase 13 serves them
  (speculation k=4; at the first depth only) and the greedy streams are
  compared, with ``chip_smoke.report_divergence`` at the first parting;
- both engines then step in lockstep without speculation, teacher-forced
  along the plain run, and every decision's logits are compared: the
  per-step max |kernel - plain| (worst, median, 90th percentile), the
  top-2 margins of the decisions (the smaller of the two engines'), and
  how many decisions have a margin below the worst difference (those a
  rounding-level difference can flip).

Prints one JSON line per (depth, KV dtype).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def teacher_forced(a, b, prompts):
    """Per-decision logit differences and top-2 margins of engines ``a``
    (kernel) and ``b`` (plain), ``a`` forced along ``b``'s tokens."""
    ra = [a._requests[a.submit(p, max_new_tokens=cs.NEW_TOKENS)]
          for p in prompts]
    rb = [b._requests[b.submit(p, max_new_tokens=cs.NEW_TOKENS)]
          for p in prompts]
    diffs, margins, flips = [], [], 0
    while b.step():
        a.step()
        (sa, la), (sb, lb) = a.last_step, b.last_step
        if sa != sb:
            raise AssertionError("engines took different steps")
        for slot in sb:
            diffs.append((la[slot] - lb[slot]).abs().max().item())
            va, vb = torch.topk(la[slot], 2).values, torch.topk(
                lb[slot], 2).values
            margins.append(min((va[0] - va[1]).item(),
                               (vb[0] - vb[1]).item()))
        for x, y in zip(ra, rb):
            if x.tokens != y.tokens:
                flips += 1
                x.tokens[:] = y.tokens
    diffs, margins = np.asarray(diffs), np.asarray(margins)
    return dict(decisions=len(diffs), worst=float(diffs.max()),
                median=float(np.median(diffs)),
                p90=float(np.quantile(diffs, 0.9)), flips=flips,
                min_margin=float(margins.min()),
                margin_q01=float(np.quantile(margins, 0.01)),
                decisions_below_worst=int((margins < diffs.max()).sum()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[32, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("engine_kv_drift: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.inference.engine import DecodeEngine
    from paddle_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_line()
    for i, layers in enumerate(args.layers):
        model = cs.build_llama(layers)
        prompts = cs.make_prompts(model.config.vocab_size)
        for kv in ("f32", "bf16", "int8"):
            out = {"card": smi, "layers": layers, "kv": kv}
            if i == 0:
                a = DecodeEngine(model, kv_dtype=kv, **cs.engine_config())
                b = DecodeEngine(model, kv_dtype=kv, attn_kernel="plain",
                                 **cs.engine_config())
                oa, ob = cs.serve(a, prompts), cs.serve(b, prompts)
                out["streams_equal"] = int(sum(
                    np.array_equal(x, y) for x, y in zip(oa, ob)))
                if out["streams_equal"] != len(prompts):
                    cs.report_divergence(fa, model, prompts, oa, ob)
                del a, b
            cfg = dict(cs.engine_config(), speculate_k=0)
            a = DecodeEngine(model, kv_dtype=kv, **cfg)
            b = DecodeEngine(model, kv_dtype=kv, attn_kernel="plain", **cfg)
            out.update(teacher_forced(a, b, prompts))
            print(json.dumps(out), flush=True)
            del a, b
            torch.cuda.empty_cache()
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
