"""The port's which-major qkv3 flash attention against paddle_tpu's.

The plain versions of the B5 kernels (forward, and backward through
torch.autograd) are held against paddle_tpu's Pallas kernels
``_fwd_qkv3``/``_bwd_qkv3`` run in interpret mode (through ``jax.vjp``),
on the same numpy-seeded float32 inputs with the same dropout seed, at
atol 1e-5 (the two differ only in summation order), and against B1's
plain version on the repacked projection bit for bit (same math, same
dropout ids). `flash_attention_packed` is held against the reference's
too. The kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py and chip_smoke.py hold them against the
same plain versions there.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as pfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

ATOL = 1e-5
SEED = 2468


@pytest.fixture
def interpret_kernel(monkeypatch):
    """paddle_tpu's Pallas kernels on the CPU (interpret mode), as
    tests/test_flash_attention.py runs them."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def _reference(qkv, g, h, d, causal, p):
    """paddle_tpu's qkv3 kernels: (o, lse [B, H, S], dqkv) by jax.vjp."""
    seed = jnp.asarray([SEED], jnp.int32) if p else None
    scale = float(1.0 / np.sqrt(d))
    x = jnp.asarray(qkv)
    o, lse = jfa._fwd_qkv3(x, scale, causal, d, p, seed)
    _, vjp = jax.vjp(lambda v: jfa._flash_qkv3_p(v, seed, scale, causal, d,
                                                 p), x)
    (dqkv,) = vjp(jnp.asarray(g))
    # lse [B, pairs, 16, S]: rows 0 and 8 are the pair's two heads
    lse = np.asarray(lse)[:, :, ::8].reshape(qkv.shape[0], h, -1)
    return np.asarray(o), lse, np.asarray(dqkv)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h", [2, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_versions_match_the_interpret_kernels(interpret_kernel, d, h,
                                                    causal, p):
    rng = np.random.default_rng(7 * d + h + 10 * causal + int(100 * p))
    b, s = 2, 128
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    g = rng.standard_normal((b, s, h * d)).astype(np.float32)
    o_ref, lse_ref, dqkv_ref = _reference(qkv, g, h, d, causal, p)

    seed = SEED if p else None
    x = torch.from_numpy(qkv).requires_grad_(True)
    o = pfa.flash_attention_qkv3(x, h, is_causal=causal, dropout_p=p,
                                 seed=seed)
    o.backward(torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), o_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), dqkv_ref, atol=ATOL, rtol=0)
    seed_t = torch.tensor([SEED], dtype=torch.int32) if p else None
    o2, lse = pfa.flash_qkv3_reference(torch.from_numpy(qkv), h, causal, p,
                                       seed_t)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL, rtol=0)
    assert torch.equal(o2, o.detach())


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_qkv3_is_b1_on_the_repacked_projection(p):
    """Same function, same dropout ids: the which-major entry equals the
    pair-major one on the repacked projection, output and gradient, bit
    for bit; the gradient comes back which-major."""
    rng = np.random.default_rng(11)
    h, d = 4, 64
    x = torch.from_numpy(rng.standard_normal((2, 128, 3 * h * d))
                         .astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((2, 128, h * d))
                         .astype(np.float32))
    xp = pfa._which_to_pair(x.detach(), h).requires_grad_(True)
    o3 = pfa.flash_attention_qkv3(x, h, dropout_p=p, seed=SEED)
    o1 = pfa.flash_attention_qkv(xp, h, dropout_p=p, seed=SEED)
    o3.backward(g)
    o1.backward(g)
    assert torch.equal(o3, o1)
    assert torch.equal(x.grad, pfa._pair_to_which(xp.grad, h))
    assert torch.equal(pfa._pair_to_which(xp.detach(), h), x.detach())


def test_flash_attention_packed_matches_the_reference(interpret_kernel):
    rng = np.random.default_rng(5)
    h, d = 2, 64
    q, k, v = (rng.standard_normal((2, 128, h * d)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jfa.flash_attention_packed(
        *(jnp.asarray(t) for t in (q, k, v)), h, is_causal=True)._value)
    got = pfa.flash_attention_packed(
        *(torch.from_numpy(t) for t in (q, k, v)), h, is_causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = kernels.kernel_launch_counts()
    x = torch.zeros((1, 128, 3 * 2 * 64), requires_grad=True)
    pfa.flash_attention_qkv3(x, 2, is_causal=True).sum().backward()
    assert kernels.kernel_launch_counts() == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pfa.flash_attention_qkv3_fwd(x.detach(), 2, True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pfa.flash_attention_qkv3_bwd(x.detach(), None, None, None, 2, True)


@pytest.mark.parametrize("shape", [(128, 128, 2, 64), (2048, 2048, 4, 128),
                                   (256, 128, 2, 64), (128, 128, 3, 64),
                                   (128, 128, 2, 32), (4096, 4096, 2, 64)])
def test_packed_supported_is_the_references(shape):
    assert pfa.packed_supported(*shape) == jfa.packed_supported(*shape)
