"""Heads wider than the kernels take (head_dim 256) on the CPU.

The port's ``nn.functional.scaled_dot_product_attention`` at D = 256
runs the plain version of the general flash path on a CPU tensor, as the
JAX package composes there; on a CUDA tensor the general kernels run,
sliced over D, which tests/test_torch_kernels_cuda.py holds on a card
(tests/test_torch_flash_wide_heads.py holds D 192 and 384 here). Output and
the gradients in q, k and v are held against paddle_tpu's
``scaled_dot_product_attention`` and ``jax.grad`` of it, on the same
numpy-seeded float32 inputs, at atol 1e-5 (the two differ only in
summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.nn import functional as F

ATOL = 1e-5
SHAPE = (2, 128, 2, 256)   # [B, S, H, D]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3)]


def _reference(q, k, v, causal):
    out = JF.scaled_dot_product_attention(JTensor(q), JTensor(k),
                                          JTensor(v), is_causal=causal)
    return out._value


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_head_dim_256_matches_reference(causal):
    q, k, v = _inputs(11 + causal)
    got = F.scaled_dot_product_attention(
        *(torch.tensor(a) for a in (q, k, v)), is_causal=causal)
    want = np.asarray(_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal))
    assert tuple(got.shape) == SHAPE
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_head_dim_256_grads_match_jax_grad(causal):
    q, k, v = _inputs(21 + causal)
    w = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = F.scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
    (out * torch.tensor(w)).sum().backward()

    def loss(a, b, c):
        return jnp.sum(_reference(a, b, c, causal) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for t, g in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL,
                                   rtol=0)


def test_flash_attention_head_dim_256_plain_on_cpu():
    q, k, v = (torch.tensor(a) for a in _inputs(31))
    got = pfa.flash_attention(q, k, v, is_causal=True)
    want, _ = pfa.flash_reference(q, k, v, True, None, 0.0, None,
                                  *pfa._blocks(SHAPE[1], SHAPE[1],
                                               pfa.DEFAULT_BLOCK,
                                               pfa.DEFAULT_BLOCK),
                                  1.0 / 16.0)
    torch.testing.assert_close(got, want, atol=0, rtol=0)

