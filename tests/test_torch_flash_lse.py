"""B4, flash attention with a differentiable lse, against paddle_tpu's.

The port's `flash_attention_with_lse` on the CPU (B4's plain versions,
differentiable through `_FlashLse`) against paddle_tpu's
``flash_attention_with_lse`` with its Pallas kernels in interpret mode
(``_fwd``, then ``_bwd_merged`` with ``has_dlse``), as
``tests/test_flash_attention.py:484-521`` runs it, on the same numpy
inputs. The loss reads lse, ``sum(sin(o)) + sum(cos(lse))``, so the lse
cotangent is not zero and enters ds. Tolerances are the reference's
own: 2e-4 for o and lse, 5e-4 for the grads. The kernels run only on a
card (chip_smoke.py phase 11 holds them against these plain versions).
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

TOL_OUT = dict(rtol=2e-4, atol=2e-4)
TOL_GRAD = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_reference(arrays, causal):
    """The reference's o, lse and the q/k/v grads of sin(o) + cos(lse)."""
    def loss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, is_causal=causal)
        return jnp.sum(jnp.sin(o)) + jnp.sum(jnp.cos(lse)), (o, lse)

    (_, (o, lse)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, arrays))
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_outputs_and_grads_match_the_reference(causal, d):
    """o, lse and the grads of a loss that reads lse, at D 64 and 128 and
    a D the kernels pad (32)."""
    arrays = _inputs((1, 128, 2, d), seed=70 + d + int(causal))
    ref_o, ref_lse, ref_grads = _jax_reference(arrays, causal)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    o, lse = kernels.flash_attention_with_lse(q, k, v, is_causal=causal)
    assert o.shape == q.shape and lse.shape == (1, 2, 128)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.detach().numpy(), ref_o, **TOL_OUT)
    np.testing.assert_allclose(lse.detach().numpy(), ref_lse, **TOL_OUT)
    (o.sin().sum() + lse.cos().sum()).backward()
    for t, g, name in zip((q, k, v), ref_grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), g, **TOL_GRAD,
                                   err_msg=f"d{name}")


def test_unequal_lengths_raise_in_the_references_words():
    q, k, _ = (torch.from_numpy(a) for a in _inputs((1, 128, 2, 64), 1))
    with pytest.raises(ValueError, match=r"requires s_q == s_k \(got 128 "
                                         r"vs 64\)"):
        kernels.flash_attention_with_lse(q, k[:, :64], k[:, :64])
    with pytest.raises(ValueError, match="s_q == s_k"):
        jfa.flash_attention_with_lse(jnp.asarray(q.numpy()),
                                     jnp.asarray(k[:, :64].numpy()),
                                     jnp.asarray(k[:, :64].numpy()))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_no_dlse_equals_zero_dlse_equals_the_general_backward(causal):
    """A loss that never reads lse (its cotangent missing), a zero lse
    cotangent and B2's plain backward (`flash_bwd_reference` without
    dlse) give the same grads; a loss that reads only lse works too."""
    arrays = _inputs((2, 128, 2, 64), seed=5 + int(causal))
    rng = np.random.default_rng(9)
    do = torch.from_numpy(rng.standard_normal((2, 128, 2, 64))
                          .astype(np.float32))

    def grads(with_lse):
        q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
        o, lse = kernels.flash_attention_with_lse(q, k, v, is_causal=causal)
        loss = (o * do).sum() + (0.0 * lse.sum() if with_lse else 0.0)
        loss.backward()
        return [t.grad for t in (q, k, v)]

    missing, zero = grads(False), grads(True)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    o, lse = pfa.flash_reference(q, k, v, causal)
    general = pfa.flash_bwd_reference(q, k, v, o, lse, do, causal)
    folded = pfa.flash_bwd_reference(q, k, v, o, lse, do, causal,
                                     dlse=torch.zeros_like(lse))
    for a, b, c, e in zip(missing, zero, general, folded):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
        torch.testing.assert_close(c, e, rtol=0, atol=0)
    # only lse read: o's cotangent is missing and counts as zero
    qg, kg, vg = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    _, lse = kernels.flash_attention_with_lse(qg, kg, vg, is_causal=causal)
    lse.sum().backward()
    want = pfa.flash_bwd_reference(q, k, v, o, lse.detach(),
                                   torch.zeros_like(do), causal,
                                   dlse=torch.ones_like(lse))
    for t, w in zip((qg, kg, vg), want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


def test_plain_dlse_is_the_lse_gradient():
    """The plain backward's dlse term alone is the gradient of
    ``sum(lse * c)`` that torch's autograd finds through a logsumexp of
    the same scores."""
    arrays = _inputs((1, 128, 2, 32), seed=13)
    c = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 2, 128)).astype(np.float32))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(32)
    mask = torch.ones(128, 128, dtype=torch.bool).tril()
    lse = scores.masked_fill(~mask, -1e30).logsumexp(-1)
    want = torch.autograd.grad((lse * c).sum(), (q, k))
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, rlse = pfa.flash_reference(qd, kd, vd, True)
    got = pfa.flash_bwd_reference(qd, kd, vd, o, rlse, torch.zeros_like(o),
                                  True, dlse=c)
    for g, w in zip(got[:2], want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert got[2].abs().max() == 0


def test_kernel_entry_counts_under_b4s_own_names():
    """B4's launches count under ``flash_attention_lse_fwd`` /
    ``flash_attention_lse_bwd``, apart from B2's; both start at zero."""
    counts = kernels.kernel_launch_counts()
    assert {"flash_attention_lse_fwd", "flash_attention_lse_bwd"} <= set(
        counts)
    q = torch.zeros((1, 128, 1, 64))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pfa.flash_attention_lse_fwd(q, q, q, False)
    lse = torch.zeros((1, 1, 128))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pfa.flash_attention_lse_bwd(q, q, q, q, lse, q, lse, False)


def test_head_dim_over_128_runs_plain_on_the_cpu():
    """The CPU's plain version takes any head_dim (a card runs D > 128 in
    the kernels sliced over D: tests/test_torch_kernels_cuda.py)."""
    arrays = _inputs((1, 128, 1, 160), seed=3)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    o, lse = kernels.flash_attention_with_lse(q, k, v, is_causal=True)
    ro, rlse = pfa.flash_reference(q, k, v, True)
    torch.testing.assert_close(o, ro, rtol=0, atol=0)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=0)
