"""Self-speculative drafting for the engine's verify window.

Counterpart: ``paddle_tpu/serving/speculative.py:61-278`` (host-only
numpy, kept here as the port's own copy): the n-gram drafter, the
``(tokens, q)`` draft protocol and the greedy accept rule.

Speculative decoding (Leviathan et al. 2023; Chen et al. 2023): a cheap
drafter proposes ``k`` tokens, ONE batched target pass scores all ``k +
1`` positions, and the longest draft prefix the target agrees with is
accepted, plus the target's own next token. For greedy requests the
output is token-identical to plain decode by construction. Sampled
requests accept by modified rejection sampling (the engine's
`_accept_sampled`): a draft ``d`` at lane ``j`` survives with probability
``min(1, p(d) / q(d))``, and the first rejection samples from the
normalized residual ``max(0, p - q)``; the emitted stream is then
distributed exactly as plain sampled decode when the drafts really are
samples from the reported ``q``. `NgramDrafter.draft_with_q` samples
them from a floor-smoothed empirical proposal for that reason.

A second draft model (``Engine(draft_model=...)``) and the adaptive
``k`` controller come with later slices (ROADMAP A8).
"""
from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

_EMPTY = np.zeros((0,), np.int32)


class NgramDrafter:
    """Suffix-match (prompt-lookup) drafter over a slot's own tokens.

    ``draft(context, k)`` looks for the most recent earlier occurrence
    of the context's trailing n-gram (longest first, ``max_ngram`` down
    to ``min_ngram``) and proposes the up-to-``k`` tokens that followed
    it: an int32 array of length ``<= k``, possibly empty (the verify
    step then runs that slot's lanes zero-padded, the plain decode
    semantics)."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 q_floor: float = 0.02):
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        #: mixture weight of the uniform floor in `draft_with_q`'s
        #: proposal, so every token has q > 0
        self.q_floor = float(q_floor)
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}..{max_ngram}")
        if not 0.0 < self.q_floor < 1.0:
            raise ValueError(f"need 0 < q_floor < 1, got {q_floor}")

    def _hits(self, ctx: np.ndarray, n: int) -> np.ndarray:
        """Starts of the earlier occurrences of the trailing ``n``-gram
        whose following token lies inside the context (the trailing
        n-gram itself is excluded)."""
        n_ctx = int(ctx.shape[0])
        wins = sliding_window_view(ctx[:n_ctx - 1], n)
        return np.flatnonzero((wins == ctx[n_ctx - n:]).all(axis=1))

    def _ngram_sizes(self, n_ctx: int):
        return range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1, -1)

    def draft(self, context, k: int) -> np.ndarray:
        ctx = np.asarray(context)
        n_ctx = int(ctx.shape[0])
        if k <= 0 or n_ctx < 2:
            return _EMPTY
        for n in self._ngram_sizes(n_ctx):
            hits = self._hits(ctx, n)
            if hits.size:
                # prefer the most recent occurrence with a FULL k-token
                # continuation: on a cycling context the nearest match
                # sits one period from the end and would cap the draft
                # at the cycle length; an earlier lap continues alike
                full = hits[hits + n + int(k) <= n_ctx]
                p = int(full[-1]) if full.size else int(hits[-1])
                out = ctx[p + n:p + n + int(k)]
                if out.size:
                    return out.astype(np.int32)
        return _EMPTY

    def _follower_dist(self, ctx: np.ndarray, vocab_size: int):
        """Floor-smoothed empirical follower distribution of the trailing
        n-gram (longest match first), or None when nothing matches:
        ``q = (1 - q_floor) * counts / total + q_floor / V`` over the
        followers of every earlier occurrence."""
        n_ctx = int(ctx.shape[0])
        v = int(vocab_size)
        if n_ctx < 2:
            return None
        for n in self._ngram_sizes(n_ctx):
            hits = self._hits(ctx, n)
            if not hits.size:
                continue
            followers = ctx[hits + n]
            followers = followers[(followers >= 0) & (followers < v)]
            if not followers.size:
                continue
            counts = np.bincount(followers, minlength=v).astype(np.float64)
            q = (1.0 - self.q_floor) * counts / counts.sum()
            q += self.q_floor / v
            return q
        return None

    def draft_with_q(self, context, k: int, vocab_size: int, seed=None):
        """Sampled proposal for the exact sampled accept: ``-> (tokens
        [m <= k] int32, q [m, V] float64)``, or ``(empty, None)`` when no
        n-gram matches. Each position's draft is SAMPLED from its
        `_follower_dist` with a numpy generator seeded by ``seed`` (the
        engine passes the request's seed and token counter), and the
        match re-runs after each sampled token, so later lanes condition
        on earlier drafts."""
        v = int(vocab_size)
        k = int(k)
        if k <= 0 or v <= 0:
            return _EMPTY, None
        rng = np.random.default_rng(seed)
        base = np.asarray(context).astype(np.int64, copy=False)
        ctx = np.empty((base.shape[0] + k,), np.int64)
        ctx[:base.shape[0]] = base
        n = base.shape[0]
        toks, rows = [], []
        for _ in range(k):
            q = self._follower_dist(ctx[:n], v)
            if q is None:
                break
            # inverse-CDF draw with Generator.choice(p=...)'s arithmetic
            cdf = (q / q.sum()).cumsum()
            cdf /= cdf[-1]
            t = int(cdf.searchsorted(rng.random(), side="right"))
            toks.append(t)
            rows.append(q)
            ctx[n] = t
            n += 1
        if not toks:
            return _EMPTY, None
        return np.asarray(toks, np.int32), np.stack(rows)


def normalize_draft(out, k: int):
    """Any drafter return value -> ``(tokens [m <= k] int32, q)``.

    ``out`` is a bare token sequence (a deterministic proposal: ``q`` is
    None and the accept test scores it as a point mass, ``q = 1`` at the
    drafted token) or a ``(tokens, q)`` tuple with ``q`` either ``[m]``
    (the probability of each drafted token) or ``[m, V]`` (the whole
    proposal per position). Tokens are clipped to ``k``, ``q`` with
    them."""
    q = None
    if isinstance(out, tuple):
        out, q = out
    toks = np.asarray(out).reshape(-1)[:int(k)].astype(np.int32)
    if q is not None and len(toks):
        q = np.asarray(q, np.float64)
        if q.ndim == 0:
            q = q.reshape(1)
        q = q[:len(toks)]
    elif not len(toks):
        q = None
    return toks, q


def longest_accept(drafts: np.ndarray, verified: np.ndarray,
                   n_draft: int) -> int:
    """Accepted draft count of a greedy window: the longest prefix of
    ``drafts[1:]`` that matches the verify pass position for position.
    ``drafts [W]`` is the window fed to the verify step (lane 0 the
    pending token, lanes ``1..n_draft`` the proposals); ``verified[j]``
    is the target's next token after lane ``j``. The emitted tokens are
    ``verified[0 .. acc]``: the accepted drafts plus the bonus token."""
    acc = 0
    while acc < n_draft and int(drafts[acc + 1]) == int(verified[acc]):
        acc += 1
    return acc


__all__ = ["NgramDrafter", "normalize_draft", "longest_accept"]
