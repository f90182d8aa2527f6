"""The general flash path (B2) and B4 at head dims above 128, on the CPU.

On a card, heads wider than 128 run the kernels sliced over D
(csrc/flash_attention.cu: `fwd_wide_kernel`, `dkdv_wide_kernel`,
`dq_wide_kernel`) at `kernel_head_dim`; on the CPU the plain versions
run. Here, on the same numpy-seeded float32 inputs, against paddle_tpu
(its Pallas kernels in interpret mode, with its gates open where a layer
decides, as tests/test_torch_flash_general.py runs them), at D 192 and
384 with a key-padding mask and causal masking, forward and grads:

- ``nn.functional.scaled_dot_product_attention``, `flash_attention` and
  `flash_attention_with_lse` (B4: a loss that reads lse);
- a stack of two `TransformerEncoderLayer` at d_model 512, nhead 2
  (D = 256), weights carried across;
- `kernel_head_dim`, the width the wrappers pad to, for every D.

Tolerances: 1e-5 where the two differ only in summation order (sdpa,
the layers' outputs), the reference's own 2e-4 / 5e-4 for B4 (as
tests/test_torch_flash_lse.py), and 2e-5 for grads summed over 384
columns. The kernels run only on a card: tests/test_torch_kernels_cuda.py
and chip_smoke.py hold them against these plain versions there.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import kernels as jkernels
from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit.api import functional_call as jfunctional_call
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.nn import TransformerEncoderLayer
from paddle_tpu_torch.nn import functional as F

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

ATOL = 1e-5
ATOL_GRAD = 2e-5
TOL_LSE_OUT = dict(rtol=2e-4, atol=2e-4)
TOL_LSE_GRAD = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """paddle_tpu's Pallas kernels in interpret mode with their gates
    open; its process-wide fallback counters reset before and after."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    monkeypatch.setattr(jkernels, "pallas_available", lambda: True)
    jkernels.reset_kernel_fallback_counters()
    yield
    jkernels.reset_kernel_fallback_counters()


def test_kernel_head_dim():
    for d in range(1, 513):
        width = pfa.kernel_head_dim(d)
        assert width >= d and width % 64 == 0, d
        if d <= 128:
            assert width in (64, 128) and (d > 64) == (width == 128), d
        else:
            assert width - d < 64, d


def _inputs(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _key_padding(b, s, seed):
    lens = np.random.default_rng(seed).integers(s // 2, s + 1, (b,))
    lens[0] = s
    return (np.arange(s)[None, :] < lens[:, None])[:, None, None, :]


@pytest.mark.parametrize("d", [192, 384])
@pytest.mark.parametrize("causal", [False, True], ids=["masked", "causal"])
def test_sdpa_forward_and_grads_match_the_reference(d, causal):
    b, s, h = 2, 128, 2
    q, k, v, w = _inputs((b, s, h, d), seed=d + causal)
    mask = None if causal else _key_padding(b, s, d)

    def jfn(q, k, v):
        return JF.scaled_dot_product_attention(
            JTensor(q), JTensor(k), JTensor(v), is_causal=causal,
            attn_mask=None if mask is None else JTensor(jnp.asarray(mask))
        )._value

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(w))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = F.scaled_dot_product_attention(
        *leaves, is_causal=causal,
        attn_mask=None if mask is None else torch.from_numpy(mask))
    got.backward(torch.from_numpy(w))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    for t, g, name in zip(leaves, jgrads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=ATOL_GRAD, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("d", [192, 384])
@pytest.mark.parametrize("causal", [False, True], ids=["masked", "causal"])
def test_flash_attention_matches_the_interpret_kernels(pallas_interpret, d,
                                                       causal):
    """`flash_attention` (its plain versions) against paddle_tpu's
    ``flash_attention_fwd`` (which pads D to a multiple of 128 for its
    Pallas kernels) and its grads by jax.vjp, with a key-padding mask,
    at Sq != Sk under causal masking."""
    b, h = 2, 2
    s_q, s_k = (128, 256) if causal else (128, 128)
    q, g = _inputs((b, s_q, h, d), seed=3 * d + causal, n=2)
    k, v = _inputs((b, s_k, h, d), seed=5 * d + causal, n=2)
    mask = _key_padding(b, s_k, d + 1)

    def jfn(q, k, v):
        o = jfa.flash_attention_fwd(q, k, v, is_causal=causal,
                                    attn_mask=jnp.asarray(mask))
        return o._value if hasattr(o, "_value") else o

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = pfa.flash_attention(*leaves, is_causal=causal,
                              attn_mask=torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    for t, jg, name in zip(leaves, jgrads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=ATOL_GRAD, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("d", [192, 384])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_with_lse_matches_the_reference(pallas_interpret, d,
                                                        causal):
    """B4: o, lse and the grads of ``sum(sin(o)) + sum(cos(lse))`` (the
    lse cotangent enters ds) against paddle_tpu's
    ``flash_attention_with_lse`` in interpret mode."""
    arrays = _inputs((1, 128, 2, d), seed=90 + d + causal, n=3)

    def loss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, is_causal=causal)
        return jnp.sum(jnp.sin(o)) + jnp.sum(jnp.cos(lse)), (o, lse)

    (_, (ro, rlse)), rgrads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, arrays))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    o, lse = kernels.flash_attention_with_lse(q, k, v, is_causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ro),
                               **TOL_LSE_OUT)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(rlse),
                               **TOL_LSE_OUT)
    (o.sin().sum() + lse.cos().sum()).backward()
    for t, jg, name in zip((q, k, v), rgrads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   **TOL_LSE_GRAD, err_msg=f"d{name}")


# ------------------------------------ two encoder layers at 2 heads of 256
D_MODEL, NHEAD, FFN = 512, 2, 1024


class _JStack(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.layers = jnn.LayerList([
            jnn.TransformerEncoderLayer(D_MODEL, NHEAD, FFN, dropout=0.0)
            for _ in range(2)])

    def forward(self, x, mask):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _Stack(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = torch.nn.ModuleList([
            TransformerEncoderLayer(D_MODEL, NHEAD, FFN, dropout=0.0,
                                    device="cpu") for _ in range(2)])

    def forward(self, x, mask):
        for layer in self.layers:
            x = layer(x, mask)
        return x


def test_encoder_layers_at_head_dim_256_match_the_reference(pallas_interpret):
    """Forward and every parameter's grad of two post-LN encoder layers
    (D = 256, a [B, 1, 1, S] key-padding mask, S = 128: both packages'
    sdpa gates take the flash branch) at atol 1e-5 / 2e-5; the
    reference runs its Pallas kernels (no fallback counted)."""
    b, s = 2, 128
    rng = np.random.default_rng(256)
    x = rng.standard_normal((b, s, D_MODEL)).astype(np.float32)
    w = (rng.standard_normal((b, s, D_MODEL)) / (b * s)).astype(np.float32)
    mask = _key_padding(b, s, 7)
    paddle_tpu.seed(21)
    jstack = _JStack()
    jparams = {n: p._value for n, p in jstack.named_parameters()}

    def jloss(p):
        with jautograd.no_grad():
            out = jfunctional_call(jstack, p, JTensor(jnp.asarray(x)),
                                   JTensor(jnp.asarray(mask)))
        return jnp.sum(out._value * w), out._value

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    assert jkernels.kernel_fallback_counters() == {}

    stack = _Stack()
    params = dict(stack.named_parameters())
    assert set(params) == set(jparams)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(torch.from_numpy(np.array(jparams[n])))
    out = stack(torch.from_numpy(x), torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=0)
    for n, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   atol=ATOL_GRAD, rtol=0, err_msg=n)
