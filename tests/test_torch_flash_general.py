"""The port's general [B,S,H,D] flash attention against paddle_tpu's.

The plain versions of the Hopper kernels (forward, and backward through
torch.autograd) are held against paddle_tpu's ``flash_attention_fwd`` with
its Pallas kernels in interpret mode (through ``jax.vjp``), on the same
numpy-seeded float32 inputs with the same dropout seed and blocks, at
atol 1e-5 (the two differ only in summation order). The cases cover
every mask shape the kernels stream, causal masking with S_q < S_k, a
length that pads (S=200), a head_dim that pads (32), a fully masked row,
the one-block (merged) and two-block (split) backward, and dropout. The
B2 dropout keep tiles are compared bit for bit, the gate shape by shape,
and a masked GPT forward and its grads against paddle_tpu's GPT. The
kernels themselves run only on a card: tests/test_torch_kernels_cuda.py
and chip_smoke.py hold them against the same plain versions there.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import kernels as jkernels
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit.api import functional_call as jfunctional_call
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import GPTModel as JGPTModel
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.models import (GPTForPretraining,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.nn import functional as F

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

ATOL = 1e-5
SEED = 4321


@pytest.fixture
def interpret_kernel(monkeypatch):
    """paddle_tpu's Pallas kernels on the CPU (interpret mode), as
    tests/test_flash_attention.py runs them."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """...and its gates open, as on a TPU. The reference's fallback
    counters are process-wide (another test in the worker may have left
    a count), so they are reset before the test as well as after."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    monkeypatch.setattr(jkernels, "pallas_available", lambda: True)
    jkernels.reset_kernel_fallback_counters()
    yield
    jkernels.reset_kernel_fallback_counters()


@pytest.mark.parametrize("blocks,shape", [((128, 128), (256, 256)),
                                          ((256, 128), (200, 384)),
                                          ((512, 512), (512, 512))])
def test_block_keep_is_bitwise_the_reference(blocks, shape):
    bq, bk = blocks
    keep = pfa._block_keep(torch.tensor([SEED], dtype=torch.int32), 3,
                           *shape, bq, bk, 0.1, None)
    for bh in range(3):
        for qi in range(-(-shape[0] // bq)):
            for ki in range(-(-shape[1] // bk)):
                want = np.asarray(jfa._hash_keep_scale(
                    jnp.int32(SEED), (np.int32(bh), np.int32(qi),
                                      np.int32(ki)), (bq, bk), 0.1))
                got = keep[bh, qi * bq:(qi + 1) * bq, ki * bk:(ki + 1) * bk]
                np.testing.assert_array_equal(
                    got.numpy(), want[:got.shape[0], :got.shape[1]])


def _mask(kind, rng, b, s_q, s_k):
    """A mask of each shape the kernels stream (numpy)."""
    if kind == "b11s":                 # bool key padding, per-row lengths
        m = np.arange(s_k)[None] < rng.integers(s_k // 2, s_k, (b, 1))
        return m[:, None, None, :]
    if kind == "1qs":                  # additive, shared by the batch
        return (rng.standard_normal((1, s_q, s_k)) * 2).astype(np.float32)
    if kind == "qs":
        return (rng.standard_normal((s_q, s_k)) * 2).astype(np.float32)
    if kind == "dead_row":             # bool, one query row sees nothing
        m = rng.uniform(size=(b, 1, s_q, s_k)) > 0.3
        m[-1, 0, 3] = False
        return m
    return None


CASES = {
    # name: (b, s_q, s_k, h, d, causal, mask, dropout, blocks)
    "key_padding": (2, 256, 256, 2, 64, False, "b11s", 0.0, 1024),
    "additive_1qs": (1, 256, 256, 2, 64, False, "1qs", 0.0, 1024),
    "additive_qs": (2, 128, 128, 2, 64, True, "qs", 0.0, 1024),
    "causal_sq_lt_sk": (2, 128, 384, 2, 64, True, None, 0.0, 1024),
    "pads_s200": (1, 200, 200, 2, 64, True, "b11s", 0.0, 1024),
    "pads_d32": (2, 128, 128, 2, 32, False, "b11s", 0.0, 1024),
    "fully_masked_row": (2, 128, 128, 2, 64, False, "dead_row", 0.0, 1024),
    "one_block_merged": (1, 128, 128, 2, 128, True, None, 0.0, 1024),
    "two_blocks_split": (1, 256, 256, 2, 64, True, "b11s", 0.0, 128),
    "dropout_one_block": (2, 128, 128, 2, 64, False, "b11s", 0.2, 1024),
    "dropout_two_blocks": (1, 256, 256, 2, 64, True, None, 0.2, 128),
}


def _reference(q, k, v, g, causal, mask, p, blocks):
    """paddle_tpu's ``flash_attention_fwd`` and its grads by jax.vjp."""
    seed = jnp.asarray([SEED], jnp.int32) if p else None
    jmask = None if mask is None else jnp.asarray(mask)

    def fn(q, k, v):
        o = jfa.flash_attention_fwd(q, k, v, is_causal=causal,
                                    block_q=blocks, block_k=blocks,
                                    attn_mask=jmask, dropout_p=p, seed=seed)
        return o._value if hasattr(o, "_value") else o

    o, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
    return [np.asarray(t) for t in (o, *vjp(jnp.asarray(g)))]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_versions_match_the_interpret_kernels(interpret_kernel, name):
    b, s_q, s_k, h, d, causal, kind, p, blocks = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s_k, h, d)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    mask = _mask(kind, rng, b, s_q, s_k)
    want = _reference(q, k, v, g, causal, mask, p, blocks)

    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = pfa.flash_attention(*leaves, is_causal=causal,
                            attn_mask=None if mask is None
                            else torch.from_numpy(mask),
                            dropout_p=p, seed=SEED if p else None,
                            block_q=blocks, block_k=blocks)
    o.backward(torch.from_numpy(g))
    got = [o.detach().numpy()] + [t.grad.numpy() for t in leaves]
    for part, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, atol=ATOL, rtol=0, err_msg=part)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_the_interpret_kernel(interpret_kernel, causal):
    """lse [B, H, Sq] against ``_fwd``'s 8-row-broadcast lse, with a
    key-padding bias, at S_q < S_k."""
    rng = np.random.default_rng(9)
    b, s_q, s_k, h, d = 2, 128, 256, 2, 64
    q = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s_k, h, d)).astype(np.float32)
            for _ in range(2))
    mask = _mask("b11s", rng, b, s_q, s_k)
    bias = jfa._normalize_mask_bias(jnp.asarray(mask))

    def bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, -1, d)

    _, lse = jfa._fwd(bh(q), bh(k), bh(v), float(1 / np.sqrt(d)), causal,
                      128, 256, bias=bias, heads=h)
    _, got = pfa.flash_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), causal,
        pfa.normalize_mask_bias(torch.from_numpy(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(lse)[:, 0].reshape(
        b, h, s_q), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 1, 1, 128), (1, 1, 128, 128),
                                   (1, 128, 128), (128, 128), (1, 128),
                                   (2, 1, 128, 128)])
@pytest.mark.parametrize("dtype", ["bool", "float32"])
def test_normalize_mask_bias_matches_the_reference(shape, dtype):
    rng = np.random.default_rng(1)
    m = (rng.uniform(size=shape) > 0.4) if dtype == "bool" else \
        rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jfa._normalize_mask_bias(jnp.asarray(m)))
    got = pfa.normalize_mask_bias(torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_head_varying_mask_raises():
    with pytest.raises(ValueError, match="broadcast over heads"):
        pfa.normalize_mask_bias(torch.zeros((1, 2, 128, 128),
                                            dtype=torch.bool))


def test_pick_block_matches_the_reference():
    for limit in (128, 256, 512, 1024):
        for seq in range(128, 4097, 128):
            assert pfa.pick_block(limit, seq) == jfa._pick_block(limit, seq)


def test_head_dim_over_128_raises(monkeypatch):
    """Heads wider than 128 no longer raise where the kernels run (a
    CUDA tensor: here the dispatch rule is patched to take the kernel
    branch, and the launchers record what they were given and answer
    with the plain versions): both launches get q, k and v zero-padded
    to `kernel_head_dim` (192 stays 192, 200 goes to 256) with the scale
    of the real head dim, and the caller gets its own D back. A CPU
    tensor takes the plain version (tests/test_torch_head_dim.py and
    tests/test_torch_flash_wide_heads.py hold the values)."""
    calls = []

    def fwd(q, k, v, causal, bias, dropout_p, seed, bq, bk, scale):
        calls.append(("fwd", q.shape, k.shape, v.shape, scale))
        return pfa.flash_reference(q, k, v, causal, bias, dropout_p, seed,
                                   bq, bk, scale)

    def bwd(q, k, v, o, lse, do, causal, bias, dropout_p, seed, bq, bk,
            scale):
        calls.append(("bwd", q.shape, do.shape, scale))
        return pfa.flash_bwd_reference(q, k, v, o, lse, do, causal, bias,
                                       dropout_p, seed, bq, bk, scale)

    for d, width in ((192, 192), (200, 256)):
        x = torch.randn((1, 128, 1, d), requires_grad=True)
        out = pfa.flash_attention(x, x, x)
        assert out.shape == x.shape
        with monkeypatch.context() as mp:
            mp.setattr(pfa, "runs_plain", lambda t, kernel: False)
            mp.setattr(pfa, "flash_attention_fwd", fwd)
            mp.setattr(pfa, "flash_attention_bwd", bwd)
            calls.clear()
            got = pfa.flash_attention(x, x, x)
            got.sum().backward()
        padded = (1, 128, 1, width)
        assert [c[0] for c in calls] == ["fwd", "bwd"]
        assert calls[0][1:4] == (padded,) * 3 and calls[1][1:3] == (padded,) * 2
        assert calls[0][4] == calls[1][3] == pytest.approx(1 / math.sqrt(d))
        assert got.shape == x.shape
        torch.testing.assert_close(got, out, atol=1e-6, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = kernels.kernel_launch_counts()
    x = torch.zeros((1, 128, 2, 64), requires_grad=True)
    mask = torch.ones((1, 1, 1, 128), dtype=torch.bool)
    pfa.flash_attention(x, x, x, attn_mask=mask).sum().backward()
    assert kernels.kernel_launch_counts() == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pfa.flash_attention_fwd(x.detach(), x.detach(), x.detach(), False)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pfa.flash_attention_bwd(*(x.detach(),) * 3, None, None, None, False)


def test_dropout_seed_comes_from_the_current_generator():
    from paddle_tpu_torch.core import random as prandom

    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 128, 2, 64)).astype(np.float32))
    outs = []
    for _ in range(2):
        with prandom.rng_guard(prandom.step_generator(5, "cpu")):
            outs.append(pfa.flash_attention(x, x, x, dropout_p=0.5))
            outs.append(pfa.flash_attention(x, x, x, dropout_p=0.5))
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("s_q,s_k", [(128, 128), (128, 256), (96, 96)])
@pytest.mark.parametrize("kind", [None, "b11s", "qs"])
def test_sdpa_takes_the_references_branch(pallas_interpret, s_q, s_k, kind):
    """``scaled_dot_product_attention`` against the reference's with its
    gate open: the flash kernels at 128-multiples, the composition at
    S=96, the same numbers either way."""
    rng = np.random.default_rng(s_q + s_k)
    b, h, d = 2, 2, 64
    q = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s_k, h, d)).astype(np.float32)
            for _ in range(2))
    mask = _mask(kind, rng, b, s_q, s_k)
    want = JF.scaled_dot_product_attention(
        *(JTensor(jnp.asarray(t)) for t in (q, k, v)),
        attn_mask=None if mask is None else JTensor(jnp.asarray(mask)),
        is_causal=kind is None)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=kind is None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                               atol=ATOL, rtol=0)


def test_gate_agrees_with_the_reference(monkeypatch):
    monkeypatch.setattr(jkernels, "pallas_available", lambda: True)
    try:
        _gate_grid()
    finally:     # the reference's gate counts the calls it refuses
        jkernels.reset_kernel_fallback_counters()


def _gate_grid():
    b, h, d = 2, 2, 64
    seen = set()
    for s_q, s_k in ((128, 128), (128, 256), (200, 200), (256, 200),
                     (512, 512)):
        masks = [None, (b, 1, 1, s_k), (1, 1, 1, s_k), (b, 1, s_q, s_k),
                 (1, 1, s_q, s_k), (b, 2, s_q, s_k), (1, s_q, s_k),
                 (1, 1, s_k), (2, s_q, s_k), (s_q, s_k), (1, s_k),
                 (s_k,), (3, 1, 1, s_k), (b, 1, 1, s_k + 1)]
        for shape in masks:
            for grad in (False, True):
                if shape is None and grad:
                    continue
                for p in (0.0, 0.1, 1.0):
                    jm = tm = None
                    if shape is not None:
                        jm = JTensor(jnp.zeros(shape, jnp.float32))
                        jm.stop_gradient = not grad
                        tm = torch.zeros(shape, requires_grad=grad)
                    want = jkernels.flash_attention_enabled(
                        jax.ShapeDtypeStruct((b, s_q, h, d), jnp.float32),
                        jax.ShapeDtypeStruct((b, s_k, h, d), jnp.float32),
                        jm, p)
                    got = kernels.flash_attention_enabled(
                        torch.empty((b, s_q, h, d), device="meta"),
                        torch.empty((b, s_k, h, d), device="meta"), tm, p)
                    assert got == want, (s_q, s_k, shape, grad, p)
                    seen.add(want)
    assert seen == {True, False}
    three_d = torch.empty((b, 128, h * d), device="meta")
    assert not kernels.flash_attention_enabled(three_d, three_d, None, 0.0)


#: a small GPT whose qkv gate takes S=128 unmasked (h 128, 2 heads, d 64)
GPT_CFG = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=256,
               max_position_embeddings=128, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)


def test_masked_gpt_forward_and_grads_match_reference(pallas_interpret):
    """A masked GPT forward (causal and key padding, [B, 1, S, S] bool)
    takes B2 in both packages: logits and every parameter's grad agree
    at atol 1e-5 (the reference's kernels in interpret mode, the port's
    plain versions)."""
    b, s = 2, 128
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 256, (b, s))
    lens = np.array([s, 90])
    mask = (np.tril(np.ones((s, s), bool))[None]
            & (np.arange(s)[None, None, :] < lens[:, None, None]))[:, None]
    # the cotangent of a mean over positions keeps the grads O(0.1), so
    # atol 1e-5 is summation order, not a loose relative bound
    w = (rng.standard_normal((b, s, 256)) / (b * s)).astype(np.float32)
    paddle_tpu.seed(11)
    jmodel = JGPT(JGPTModel(JConfig(**GPT_CFG)))
    jparams = {n: p._value for n, p in jmodel.named_parameters()}

    def jloss(p):
        with jautograd.no_grad():
            logits = jfunctional_call(jmodel, p, JTensor(jnp.asarray(ids)),
                                      attn_mask=JTensor(jnp.asarray(mask)))
        return jnp.sum(logits._value * w), logits._value

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    assert jkernels.kernel_fallback_counters() == {}

    model = GPTForPretraining(GPTConfig(**GPT_CFG), device="cpu")
    arrays = {n: np.asarray(v) for n, v in jparams.items()}
    arrays.update({f"gpt.h.{i}.attn.qkv_layout": np.asarray(1, np.int32)
                   for i in range(2)})
    load_paddle_tpu_state_dict(model, arrays)
    model.requires_grad_(True)
    logits = model(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask))
    (logits * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   atol=ATOL, rtol=0, err_msg=n)
