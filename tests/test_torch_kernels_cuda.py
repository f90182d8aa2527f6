"""The port's general flash kernels against their plain versions, on a
card.

These tests need a CUDA device and skip without one (marker ``cuda``).
They import neither jax nor paddle_tpu, so they run where the port runs:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m
cuda`` (``--noconftest``: tests/conftest.py sets up jax for the parity
tests). chip_smoke.py holds every kernel at the main paths' shapes; this
is a quick check at a padded, masked, causal shape with dropout.
"""
import pytest
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as pfa


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_the_plain_versions_on_a_card(dtype):
    """The kernels against their plain versions at a masked, padded,
    causal shape with dropout: f32 at 1e-4 (summation order), bf16 at
    2e-2 (a few bf16 ulps of values of order 1); each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((2, 200, 3, 64), generator=g, device="cuda")
                   .to(dt) for _ in range(4))
    mask = torch.rand((2, 1, 200, 200), generator=g, device="cuda") > 0.3
    kw = dict(bias=pfa.normalize_mask_bias(mask), dropout_p=0.1,
              seed=torch.tensor([7], dtype=torch.int32, device="cuda"))
    kernels.reset_kernel_launch_counts()
    o, lse = pfa.flash_attention_fwd(q, k, v, True, **kw)
    ro, rlse = pfa.flash_reference(q, k, v, True, **kw)
    grads = pfa.flash_attention_bwd(q, k, v, ro, rlse, do, True, **kw)
    rgrads = pfa.flash_bwd_reference(q, k, v, ro, rlse, do, True, **kw)
    tol = dict(atol=1e-4, rtol=0) if dtype == "float32" else \
        dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    for a, r in zip((o, *grads), (ro, *rgrads)):
        torch.testing.assert_close(a.float(), r.float(), **tol)
    counts = kernels.kernel_launch_counts()
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 1
