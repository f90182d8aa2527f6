"""Token selection for the serving step: greedy argmax and per-slot
temperature / top-k / top-p sampling.

Counterparts: ``paddle_tpu/models/generation.py:32-67`` (the filters)
and ``paddle_tpu/serving/compiled.py:69-84`` (per-slot selection). The
filters keep the reference's value-threshold semantics (tokens tying
the threshold all survive). Random draws come from an explicit
`torch.Generator` per request, so a sampled request is reproducible from
its seed whatever shares its batch; they are not JAX's PRNG streams, so
sampled tokens match the reference in distribution only.
"""
from __future__ import annotations

import torch


def filter_top_k(logits, k: int):
    """Keep the ``k`` largest logits per row (k clamped to the vocab)."""
    kth = torch.topk(logits, min(int(k), logits.shape[-1]), dim=-1)[0][
        ..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def filter_top_p(logits, p):
    """Nucleus filtering: keep the smallest set of tokens whose
    cumulative probability reaches ``p`` (the first always survives).
    ``p`` is a float or a tensor broadcastable to ``[..., 1]``."""
    sort = torch.sort(logits, dim=-1, descending=True)[0]
    probs = torch.softmax(sort, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    thr = torch.where(keep, sort, torch.full_like(sort, float("inf"))).amin(
        dim=-1, keepdim=True)
    return logits.masked_fill(logits < thr, float("-inf"))


def select_tokens(l32, samplers, top_k: int = 0):
    """logits ``[S, V]`` float32 -> ``[S]`` int64 next tokens.

    ``samplers[s]`` is None for a greedy row, else ``(temperature,
    top_p, generator)``; ``top_k`` (0 = off) applies to every sampled
    row, as the engine configures it."""
    tok = l32.argmax(dim=-1)
    rows = [s for s, smp in enumerate(samplers) if smp is not None]
    if not rows:
        return tok
    dev = l32.device
    idx = torch.tensor(rows, device=dev)
    temps = torch.tensor([samplers[s][0] for s in rows], device=dev)
    top_ps = torch.tensor([samplers[s][1] for s in rows], device=dev)
    lt = l32[idx] / temps[:, None]
    if top_k and top_k > 0:
        lt = filter_top_k(lt, top_k)
    lt = filter_top_p(lt, top_ps[:, None])
    probs = torch.softmax(lt, dim=-1)
    for j, s in enumerate(rows):
        tok[s] = torch.multinomial(probs[j], 1, generator=samplers[s][2])[0]
    return tok


__all__ = ["filter_top_k", "filter_top_p", "select_tokens"]
