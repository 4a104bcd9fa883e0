"""Host-side generation helpers (counterpart of
``paddle_tpu/text/generation.py``; the batched generate loops come with a
later slice)."""
from __future__ import annotations

import numpy as np


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
