"""Token selection for the serving step: greedy argmax and per-slot
temperature / top-k / top-p sampling.

Counterparts: ``paddle_tpu/models/generation.py:32-67`` (the filters)
and ``paddle_tpu/serving/compiled.py:69-166`` (per-slot selection, and
its speculative window form `_select_tokens_window` with the lane-wise
probabilities of `_verify_probs_window`). The filters keep the
reference's value-threshold semantics (tokens tying the threshold all
survive). Random draws come from an explicit `torch.Generator` per
request, one draw per step, so a sampled request is reproducible from
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


def _sampled_probs(l32, samplers, top_k):
    """``(rows, probs)``: the sampled rows of ``l32 [S, ..., V]`` and
    their filtered softmax ``[len(rows), ..., V]`` (``/ temperature``,
    then top-k, then top-p, per row), or ``([], None)``."""
    rows = [s for s, smp in enumerate(samplers) if smp is not None]
    if not rows:
        return rows, None
    dev = l32.device
    idx = torch.tensor(rows, device=dev)
    lanes = l32[idx]
    v = lanes.shape[-1]
    per = lanes[0].numel() // v                  # lanes per row
    temps = torch.tensor([samplers[s][0] for s in rows], device=dev)
    top_ps = torch.tensor([samplers[s][1] for s in rows], device=dev)
    lt = lanes.reshape(-1, v) / temps.repeat_interleave(per)[:, None]
    if top_k and top_k > 0:
        lt = filter_top_k(lt, top_k)
    lt = filter_top_p(lt, top_ps.repeat_interleave(per)[:, None])
    return rows, torch.softmax(lt, dim=-1).reshape(lanes.shape)


def select_tokens(l32, samplers, top_k: int = 0):
    """logits ``[S, V]`` float32 -> ``[S]`` int64 next tokens.

    ``samplers[s]`` is None for a greedy row, else ``(temperature,
    top_p, generator)``; ``top_k`` (0 = off) applies to every sampled
    row, as the engine configures it."""
    tok, _ = select_tokens_window(l32[:, None], samplers, top_k,
                                  [0] * l32.shape[0])
    return tok[:, 0]


def select_tokens_window(l32, samplers, top_k, lanes):
    """logits ``[S, W, V]`` float32 of a verify window -> ``(tok [S, W]
    int64, probs)``.

    Every lane of a greedy row takes its argmax. A sampled row draws ONE
    token, at lane ``lanes[s]`` (its draft count: the lane whose draw is
    the bonus token when every draft is accepted), from its own
    generator, exactly as `select_tokens` draws a decode step's token;
    its other lanes hold the argmax and are not read. ``probs [n, W, V]``
    are the sampled rows' filtered softmax per lane, in slot order (None
    without a sampled row): the modified rejection test reads them."""
    tok = l32.argmax(dim=-1)
    rows, probs = _sampled_probs(l32, samplers, top_k)
    for j, s in enumerate(rows):
        tok[s, lanes[s]] = torch.multinomial(
            probs[j, lanes[s]], 1, generator=samplers[s][2])[0]
    return tok, probs


__all__ = ["filter_top_k", "filter_top_p", "select_tokens",
           "select_tokens_window"]
