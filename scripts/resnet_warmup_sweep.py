#!/usr/bin/env python3
"""The fixed-batch loss of ``chip_smoke.py`` phase 27 (ResNet-50, batch
256 at 224 x 224, f32, ``TrainStep`` + ``Momentum``) under several
learning-rate warmups, on one CUDA card:

    python3 scripts/resnet_warmup_sweep.py

Prints each schedule's per-step losses and the margin phase 27 gates on
(the mean of the first 4 steps' losses less the last 4's; the gate asks
for a margin above 0). ``const`` runs twice: cuDNN's algorithms sum in a
run-dependent order, and the two runs show the trajectory's spread.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

# name -> (warmup steps, start lr, steps); one warmup step is a constant 0.1
SCHEDULES = {"const": (1, 0.1, 12), "const-again": (1, 0.1, 12),
             "warmup-4": (4, 0.01, 12), "warmup-8": (8, 0.01, 12),
             "warmup-12": (12, 0.01, 12), "warmup-6-from-0": (6, 0.0, 12),
             "const-16-steps": (1, 0.1, 16)}


def main() -> int:
    if not torch.cuda.is_available():
        print("resnet_warmup_sweep: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    print(cs.smi_line(), flush=True)
    batch = cs.resnet_batch()
    for name, (warm, start, steps) in SCHEDULES.items():
        cs.RESNET_WARMUP_STEPS, cs.RESNET_WARMUP_START = warm, start
        model = cs.build_resnet()
        step = cs.resnet_trainer(model, None)
        losses = []
        for _ in range(steps):
            losses.append(float(step(*batch)))
            step._opt._learning_rate.step()
        margin = np.mean(losses[:4]) - np.mean(losses[-4:])
        print(f"{name}: losses {[round(x, 3) for x in losses]}, margin "
              f"{margin:.3f}", flush=True)
        del model, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
