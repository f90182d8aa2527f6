"""The qkv backward's column rule and dropout ids against paddle_tpu's.

On a card, B1's and B5's backward is the general backward kernel
(``csrc/flash_attention.cu``) reading the fused projection ``[B, S,
3*H*D]`` through a rule from head to column that the wrapper computes
(`qkv_columns`) and writing dqkv through the same rule, with the qkv
kernels' per-head dropout ids (`qkv_drop_ids`). The kernel runs only on
a card; what the wrapper hands it is checked here, for both layouts:

- the rule names exactly the columns that paddle_tpu's ``_fwd_qkv`` /
  ``_fwd_qkv3`` (interpret mode) read for each head's q, k and v: each
  head's attention, computed from those columns with the dropout mask of
  its ids, is the reference's output for that head;
- the columns the kernel writes are where the port's plain backward
  (``flash_qkv_bwd_reference`` / ``flash_qkv3_bwd_reference``) puts each
  head's dq, dk and dv;
- each head's dropout base is the reference's ``_mix32(seed, b, pair,
  head)``.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as pfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

SEED = 97531
LAYOUTS = {"pair": "_fwd_qkv", "which": "_fwd_qkv3"}
PLAIN_BWD = {"pair": pfa.flash_qkv_bwd_reference,
             "which": pfa.flash_qkv3_bwd_reference}
PLAIN_FWD = {"pair": pfa.flash_qkv_reference,
             "which": pfa.flash_qkv3_reference}

grid = pytest.mark.parametrize("layout,h,d", [
    (layout, h, d) for layout in LAYOUTS for h in (2, 4, 16)
    for d in (64, 128)])


@pytest.fixture
def interpret_kernel(monkeypatch):
    """paddle_tpu's Pallas kernels on the CPU (interpret mode), as
    tests/test_flash_attention.py runs them."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def _head(x, col, d):
    return x[..., col:col + d]


def head_columns(cols, h, d):
    """Head ``h``'s first q, k and v columns under `qkv_columns`' rule
    ``cols``, as the kernel forms them (``head_col`` in
    ``csrc/flash_attention.cu``, plus the q, k or v offset)."""
    group, stride, *offsets = cols
    base = (h // group) * stride + (h % group) * d
    return tuple(base + off for off in offsets)


def _attention(q, k, v, scale, keep=None):
    """One head's attention in float64 numpy, full (no mask): ``(o,
    lse)``, p scaled by ``keep`` after the denominator, as the reference
    forms it."""
    s = q @ k.T * scale
    m = s.max(axis=-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(axis=-1, keepdims=True)
    if keep is not None:
        p = p * keep
    return p @ v / l, (m + np.log(l))[:, 0]


@grid
def test_columns_are_those_the_reference_reads(interpret_kernel, layout, h,
                                               d):
    """Each head's q, k and v, read at `qkv_columns`' columns and run
    through plain attention with the keep mask of `qkv_drop_ids`, give
    the reference kernel's output and lse for that head; the heads' q, k
    and v columns tile ``[0, 3*H*D)`` once."""
    b, s, p = 2, 16, 0.3
    rng = np.random.default_rng(10 * h + d + len(layout))
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    scale = float(1.0 / np.sqrt(d))
    o_ref, lse_ref = getattr(jfa, LAYOUTS[layout])(
        jnp.asarray(qkv), scale, False, d, p, jnp.asarray([SEED], jnp.int32))
    o_ref = np.asarray(o_ref)
    # lse [B, pairs, 16, S]: rows 0 and 8 are the pair's two heads
    lse_ref = np.asarray(lse_ref)[:, :, ::8].reshape(b, h, s)

    cols = pfa.qkv_columns(layout, h, d)
    starts = sorted(c for hg in range(h)
                    for c in head_columns(cols, hg, d))
    assert starts == list(range(0, 3 * h * d, d))
    x = qkv.astype(np.float64)
    for bi in range(b):
        for hg in range(h):
            qc, kc, vc = head_columns(cols, hg, d)
            keep = pfa.hash_keep_scale(SEED, pfa.qkv_drop_ids(bi, hg), (s, s),
                                       p).numpy().astype(np.float64)
            o, lse = _attention(_head(x[bi], qc, d), _head(x[bi], kc, d),
                                _head(x[bi], vc, d), scale, keep)
            np.testing.assert_allclose(o_ref[bi, :, hg * d:(hg + 1) * d], o,
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(lse_ref[bi, hg], lse, atol=1e-5,
                                       rtol=0)


@grid
def test_dqkv_columns_are_where_the_plain_backward_puts_them(layout, h, d):
    """Each head's dq, dk and dv, by autograd of its own attention on the
    columns `qkv_columns` names, lie at those columns of the port's plain
    backward (`flash_qkv_bwd_reference` / `flash_qkv3_bwd_reference`)."""
    b, s, causal = 2, 16, True
    rng = np.random.default_rng(7 * h + d + len(layout))
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d))
                           .astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((b, s, h * d))
                          .astype(np.float32))
    o, lse = PLAIN_FWD[layout](qkv, h, causal)
    dqkv = PLAIN_BWD[layout](qkv, do, o, lse, h, causal)

    cols = pfa.qkv_columns(layout, h, d)
    tri = torch.ones((s, s), dtype=torch.bool).tril()
    for hg in range(h):
        parts = [_head(qkv, c, d).clone().requires_grad_(True)
                 for c in head_columns(cols, hg, d)]
        q, k, v = parts
        sc = (q @ k.transpose(1, 2) / math.sqrt(d)).masked_fill(~tri, -1e30)
        (torch.softmax(sc, dim=-1) @ v).backward(
            _head(do, hg * d, d))
        for c, part in zip(head_columns(cols, hg, d), parts):
            torch.testing.assert_close(_head(dqkv, c, d), part.grad,
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("h", [2, 4, 16])
def test_dropout_base_is_the_references(h):
    """The per-head dropout base, ``mix32(seed, *qkv_drop_ids(b, h))``,
    is the reference's ``_mix32(seed, b, pair, head)`` for head ``h =
    2*pair + head``, the ids both of its qkv kernels hash (neither the
    layout nor D enters; the first test holds the masks themselves)."""
    for bi in range(3):
        for hg in range(h):
            pair, hh = divmod(hg, 2)
            want = int(np.asarray(jfa._mix32(jnp.asarray(SEED, jnp.int32),
                                             bi, pair, hh)))
            assert pfa.mix32(SEED, *pfa.qkv_drop_ids(bi, hg)) == want
