"""The schedule of the bf16 general flash kernels (B2) at head dims 192
and 256, written out in plain PyTorch and held against paddle_tpu's
interpret-mode kernels at D=256.

The card kernels (``fwd_wg_kernel<256>`` and ``bwd_wg_wide_kernel<256>``
in ``paddle_tpu_torch/kernels/csrc/flash_attention.cu``) cannot run here,
so their arithmetic is spelled out below in float32 in the order they do
it:

- forward: 128-query tiles, an online softmax over 64-key tiles with the
  running max in natural units and each exponential taken as
  ``2 ** ((s - m) * log2(e))``;
- backward in one pass: a loop over 64-key blocks and, inside, over the
  64-row query tiles that see the block (from its first visible row
  under causal masking). One consumer group forms S^T = K Q^T and P^T
  once per score and hands P^T to the other with each dropped score's
  sign flipped (so -0.0 still reads as dropped); that one forms dP^T =
  V dO^T and dS^T from it. dV (the first group) and dK (the second) are
  summed over the query tiles across all D columns; dQ = dS K is formed
  in 64-column chunks (chunks 0 and 2 by the first group, 1 and 3 by
  the second) and added across key blocks into a float32 accumulator.

Held at atol 1e-5, the tolerance of tests/test_torch_flash_b2_schedule.py
(float32 summation order), with an rtol of 1e-6 (about 8 float32 ulps)
for the few elements above 1: the fully masked row's dq reaches about 18,
where the kernels' two 64-key blocks and the reference's one sum in
another order (6 ulps, 1.1e-5 apart). On numpy-seeded inputs with the
same dropout seed and blocks as the reference: causal with Sq != Sk,
key padding with dropout 0.1 at lengths that are not multiples of 64, a
fully masked row, and two reference blocks (the dropout ids of 64-row
tiles inside 128-row blocks).
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as pfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

ATOL, RTOL = 1e-5, 1e-6
SEED = 3141
LOG2E = 1.4426950408889634
ROWS_FWD, KEYS, ROWS_BWD, CHUNK = 128, 64, 64, 64    # the kernels' tiles


@pytest.fixture
def interpret_kernel(monkeypatch):
    """paddle_tpu's Pallas kernels on the CPU (interpret mode)."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def _keep_tile(seed, bh, r, c, bq, bk, dropout_p):
    """1/keep or 0 for query rows ``r`` x key columns ``c`` (int64 tensors,
    one tile inside one reference block), from the integer threshold."""
    qb, kb = int(r[0]) // bq, int(c[0]) // bk
    base = pfa.mix32(seed, bh, qb, kb)
    x = (base + pfa._mul32(r - qb * bq, 0x9E3779B1)[:, None]
         + pfa._mul32(c - kb * bk, 0x85EBCA77)[None, :])
    keep = torch.tensor(np.float32(1.0 - dropout_p))
    return torch.where(pfa._hash24(x) < pfa.keep_threshold(dropout_p),
                       torch.ones_like(keep) / keep, torch.zeros_like(keep))


def _tile_scores(q_t, k_t, r, c, b, causal, off, s_k, bias, scale):
    """s = q.k * scale + bias, keys past Sk or past the causal diagonal
    replaced by -1e30, for one (query tile, key tile) of one head."""
    s = (q_t @ k_t.T) * scale
    if bias is not None:
        rows = bias[min(b, bias.shape[0] - 1)]
        s = s + rows[r.clamp(max=rows.shape[0] - 1)][:, c.clamp(max=s_k - 1)]
    cut = (c[None, :] >= s_k) | ((off + r[:, None] < c[None, :]) & causal)
    return torch.where(cut, torch.tensor(-1e30), s)


def _padded(t, rows):
    """``t [S, D]`` zero-padded to ``rows`` rows (the TMA's zero fill)."""
    return torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[0]))


def schedule_fwd(q, k, v, causal, bias, dropout_p, seed, bq, bk, scale):
    b, s_q, h, d = q.shape
    s_k, off = k.shape[1], k.shape[1] - q.shape[1]
    n_k = -(-s_k // KEYS)
    o = torch.zeros_like(q)
    lse = torch.zeros((b, h, s_q))
    for bi in range(b):
        for hi in range(h):
            kp = _padded(k[bi, :, hi], n_k * KEYS)
            vp = _padded(v[bi, :, hi], n_k * KEYS)
            for q0 in range(0, s_q, ROWS_FWD):
                r = torch.arange(q0, min(q0 + ROWS_FWD, s_q))
                last = off + int(r[-1])
                nk = n_k if not causal else (
                    0 if last < 0 else min(n_k, last // KEYS + 1))
                m = torch.full((len(r),), -1e30)
                l = torch.zeros(len(r))
                acc = torch.zeros((len(r), d))
                for kt in range(nk):
                    c = torch.arange(kt * KEYS, (kt + 1) * KEYS)
                    s = _tile_scores(q[bi, r, hi], kp[c], r, c, bi, causal,
                                     off, s_k, bias, scale)
                    m_new = torch.maximum(m, s.amax(dim=1))
                    alpha = torch.exp2((m - m_new) * LOG2E)
                    p = torch.exp2((s - m_new[:, None]) * LOG2E)
                    l = l * alpha + p.sum(dim=1)
                    if dropout_p:
                        p = p * _keep_tile(seed, bi * h + hi, r, c, bq, bk,
                                           dropout_p)
                    acc = acc * alpha[:, None] + p @ vp[c]
                    m = m_new
                lc = l.clamp(min=1e-30)
                o[bi, r, hi] = acc / lc[:, None]
                lse[bi, hi, r] = m + torch.log(lc)
    return o, lse


def _hand_over(pt, kept, inv_keep):
    """Group 0's P^T as group 1 reads it, a dropped score's sign flipped;
    returns ``(p, 1/keep or 0)`` decoded from it."""
    x = torch.where(kept, pt, -pt)
    return x.abs(), torch.where(torch.signbit(x), torch.zeros(()),
                                torch.tensor(inv_keep))


def schedule_bwd(q, k, v, o, lse, do, causal, bias, dropout_p, seed, bq, bk,
                 scale):
    b, s_q, h, d = q.shape
    s_k, off = k.shape[1], k.shape[1] - q.shape[1]
    delta = (do * o).sum(dim=-1).transpose(1, 2)          # [B, H, Sq]
    dq_acc = torch.zeros_like(q)                           # f32 accumulator
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    n_q = -(-s_q // ROWS_BWD) * ROWS_BWD
    chunks = [list(range(g, d // CHUNK, 2)) for g in (0, 1)]
    inv_keep = 1 / np.float32(1.0 - dropout_p)
    for bi in range(b):
        for hi in range(h):
            qp, dop = (_padded(t[bi, :, hi], n_q) for t in (q, do))
            lse_p = torch.cat([lse[bi, hi], torch.full((n_q - s_q,),
                                                       math.inf)])
            delta_p = torch.cat([delta[bi, hi], torch.zeros(n_q - s_q)])
            for k0 in range(0, s_k, KEYS):
                c = torch.arange(k0, k0 + KEYS)
                kb, vb = (_padded(t[bi, k0:k0 + KEYS, hi], KEYS)
                          for t in (k, v))
                dv_b = torch.zeros((KEYS, d))      # group 0's accumulator
                dk_b = torch.zeros((KEYS, d))      # group 1's
                first = max(0, k0 - off) // ROWS_BWD * ROWS_BWD if causal \
                    else 0
                for q0 in range(first, s_q, ROWS_BWD):
                    r = torch.arange(q0, q0 + ROWS_BWD)
                    # group 0: S^T and P^T, rows keys, columns queries
                    st = _tile_scores(qp[r], kb, r, c, bi, causal, off, s_k,
                                      bias, scale).T
                    pt = torch.exp2((st - lse_p[r][None, :]) * LOG2E)
                    ks = (_keep_tile(seed, bi * h + hi, r, c, bq, bk,
                                     dropout_p).T if dropout_p
                          else torch.ones_like(pt))
                    # group 1: dP^T, then dS^T from the P^T handed over
                    dpt = vb @ dop[r].T
                    p1, ks1 = _hand_over(pt, ks > 0, inv_keep)
                    dst = p1 * (dpt * ks1 - delta_p[r][None, :]) * scale
                    dv_b += (pt * ks) @ dop[r]
                    dk_b += dst @ qp[r]
                    live = r < s_q
                    for g in (0, 1):
                        for j in chunks[g]:
                            cols = slice(j * CHUNK, (j + 1) * CHUNK)
                            part = dst.T @ kb[:, cols]
                            dq_acc[bi, r[live], hi, cols] += part[live]
                n = min(KEYS, s_k - k0)
                dk[bi, k0:k0 + n, hi] = dk_b[:n]
                dv[bi, k0:k0 + n, hi] = dv_b[:n]
    return dq_acc, dk, dv


def _mask(kind, rng, b, s_q, s_k):
    if kind == "key_padding":          # lengths 130 and 187
        m = np.arange(s_k)[None] < np.array([[130], [187]])[:b]
        return m[:, None, None, :]
    if kind == "dead_row":             # key padding, one row sees nothing
        m = np.broadcast_to(
            (np.arange(s_k)[None] < rng.integers(s_k // 2, s_k, (b, 1)))
            [:, None, None, :], (b, 1, s_q, s_k)).copy()
        m[-1, 0, 5] = False
        return m
    return None


CASES = {
    # name: (b, s_q, s_k, h, d, causal, mask, dropout, blocks)
    "causal_sq_ne_sk": (1, 136, 264, 2, 256, True, None, 0.1, 1024),
    "key_padding_s200": (2, 200, 200, 2, 256, False, "key_padding", 0.1,
                         1024),
    # the reference gives a fully masked row p = 1 on every key (its lse
    # rounds to the -1e9 bias), so that row's dq grows with Sk; at one
    # key block of the reference its float32 sums stay inside atol
    "fully_masked_row": (2, 128, 128, 2, 256, False, "dead_row", 0.1, 1024),
    "two_blocks": (1, 256, 256, 2, 256, True, "key_padding", 0.1, 128),
}


@pytest.mark.parametrize("name", list(CASES))
def test_wide_schedule_matches_the_interpret_kernels(interpret_kernel, name):
    b, s_q, s_k, h, d, causal, kind, p, blocks = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s_k, h, d)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    mask = _mask(kind, rng, b, s_q, s_k)

    jmask = None if mask is None else jnp.asarray(mask)

    def fn(q, k, v):
        out = jfa.flash_attention_fwd(
            q, k, v, is_causal=causal, block_q=blocks, block_k=blocks,
            attn_mask=jmask, dropout_p=p,
            seed=jnp.asarray([SEED], jnp.int32))
        return out._value if hasattr(out, "_value") else out

    o_ref, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
    want = [np.asarray(t) for t in (o_ref, *vjp(jnp.asarray(g)))]

    bias = None if mask is None else pfa.normalize_mask_bias(
        torch.from_numpy(mask))
    bq, bk = pfa._blocks(s_q, s_k, blocks, blocks)
    args = (causal, bias, p, SEED, bq, bk, 1.0 / math.sqrt(d))
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    o, lse = schedule_fwd(tq, tk, tv, *args)
    grads = schedule_bwd(tq, tk, tv, o, lse, tg, *args)
    for part, a, w in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL, rtol=RTOL,
                                   err_msg=part)

