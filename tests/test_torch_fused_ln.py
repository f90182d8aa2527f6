"""The port's fused (residual +) LayerNorm against paddle_tpu's.

The plain versions of the B6 kernels (forward, and backward through
torch.autograd) are held against paddle_tpu's Pallas kernels
(``kernels/fused_ln.py``, interpret mode, gradients by ``jax.vjp``) on the
same numpy-seeded float32 inputs: y, dx and d(residual) at atol 1e-5 (one
row's mean and variance summed in another order), dg and db at atol 1e-4
(column sums over 256 rows of values of order 1, in another order). The
entry `_ln_maybe_fused` is held against the reference's on both its
branches (the kernel's shapes and the composition), and the shape gate
against the reference's. The kernels themselves run only on a card:
tests/test_torch_kernels_cuda.py and chip_smoke.py hold them against the
same plain versions there.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import kernels as jkernels
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu_torch import kernels
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.kernels import fused_ln as pfl

jfl = importlib.import_module("paddle_tpu.kernels.fused_ln")

ATOL, ATOL_SUMS = 1e-5, 1e-4
EPS = 1e-5


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(jfl, "_INTERPRET", True)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    m = shape[-1]
    x, r, dy = (rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
                for _ in range(3))
    g = (rng.standard_normal(m) * 0.5 + 1).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    return x, r, g, b, dy


def _reference(x, r, g, b, dy, residual):
    """paddle_tpu's kernels: y and the grads of (x, residual, g, b)."""
    args = [jnp.asarray(t) for t in (x, r, g, b)]
    if residual:
        fn = lambda xv, rv, gv, bv: jfl.fused_add_layer_norm(xv, rv, gv, bv,
                                                              EPS)
    else:
        args.pop(1)
        fn = lambda xv, gv, bv: jfl.fused_add_layer_norm(xv, None, gv, bv,
                                                         EPS)
    y, vjp = jax.vjp(fn, *args)
    return np.asarray(y), [np.asarray(t) for t in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("shape", [(256, 128), (2, 128, 256)])
@pytest.mark.parametrize("residual", [True, False])
def test_plain_versions_match_the_interpret_kernels(interpret_kernel, shape,
                                                    residual):
    x, r, g, b, dy = _inputs(shape, 3 + residual + len(shape))
    y_ref, grads_ref = _reference(x, r, g, b, dy, residual)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (x, r, g, b)]
    tx, tr, tg, tb = leaves
    y = pfl.fused_add_layer_norm(tx, tr if residual else None, tg, tb, EPS)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, atol=ATOL, rtol=0)
    got = [tx.grad] + ([tr.grad] if residual else []) + [tg.grad, tb.grad]
    if not residual:
        assert tr.grad is None
    for a, w, tol in zip(got, grads_ref,
                         [ATOL] * (1 + residual) + [ATOL_SUMS] * 2):
        np.testing.assert_allclose(a.numpy(), w, atol=tol, rtol=0)


def test_saved_statistics_are_the_references(interpret_kernel):
    x, r, g, b, _ = _inputs((256, 128), 9)
    _, mean_ref, rstd_ref = jfl._fwd(*(jnp.asarray(t) for t in (x, r, g, b)),
                                     EPS)
    _, mean, rstd = pfl.fused_ln_reference(
        *(torch.from_numpy(t) for t in (x, r, g, b)), EPS)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_ref)[0],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_ref)[0],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 5, 128)])
@pytest.mark.parametrize("residual", [True, False])
def test_ln_maybe_fused_matches_the_reference_entry(interpret_kernel,
                                                    monkeypatch, shape,
                                                    residual):
    """Both branches: (2, 64, 128) takes the kernels in both packages,
    (3, 5, 128) (15 rows) the composition."""
    monkeypatch.setattr(jkernels, "pallas_available", lambda: True)
    x, r, g, b, _ = _inputs(shape, 21 + residual)
    assert pfl.supported(shape, 128) == (shape[1] == 64)
    rv = JTensor(jnp.asarray(r)) if residual else None
    want = JIF._ln_maybe_fused(*(JTensor(jnp.asarray(t)) for t in (x, g, b)),
                               EPS, residual=rv)._value
    got = IF._ln_maybe_fused(*(torch.from_numpy(t) for t in (x, g, b)), EPS,
                             residual=torch.from_numpy(r) if residual
                             else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("shape", [(128, 128), (8, 512, 1024), (100, 128),
                                   (128, 96), (3, 5, 128), (256, 256)])
def test_supported_is_the_references(shape):
    assert pfl.supported(shape, shape[-1]) == jfl.supported(shape, shape[-1])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = kernels.kernel_launch_counts()
    x = torch.ones((128, 128), requires_grad=True)
    w = torch.ones(128, requires_grad=True)
    pfl.fused_add_layer_norm(x, x, w, torch.zeros(128), EPS).sum().backward()
    assert kernels.kernel_launch_counts() == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pfl.fused_ln_fwd(x.detach(), None, w.detach(), w.detach(), EPS)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pfl.fused_ln_bwd(x.detach(), None, w.detach(), None, None, x)


def test_bf16_weight_gets_a_bf16_gradient():
    """The kernels read g and b in float32; the gradients come back in
    each parameter's own dtype (the reference casts dg, db to g's)."""
    x = torch.randn((128, 128), dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones(128, dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(128, dtype=torch.bfloat16, requires_grad=True)
    y = pfl.fused_add_layer_norm(x, None, w, b, EPS)
    y.float().sum().backward()
    assert y.dtype == x.grad.dtype == w.grad.dtype == b.grad.dtype \
        == torch.bfloat16
