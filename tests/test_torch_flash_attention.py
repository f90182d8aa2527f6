"""The port's pair-major qkv flash attention against paddle_tpu's.

The plain versions of the Hopper kernels (forward, and backward through
torch.autograd) are held against paddle_tpu's Pallas kernels
``_fwd_qkv``/``_bwd_qkv`` run in interpret mode (through ``jax.vjp``), on
the same numpy-seeded float32 inputs with the same dropout seed, at
atol 1e-5 (the two differ only in summation order). The dropout hash is
compared bit for bit, and the gate shape by shape. The kernels
themselves run only on a card: chip_smoke.py holds them against the
same plain versions there.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import kernels as jkernels
from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.kernels import flash_attention as pfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

ATOL = 1e-5
SEED = 1234


@pytest.fixture
def interpret_kernel(monkeypatch):
    """paddle_tpu's Pallas kernels on the CPU (interpret mode), as
    tests/test_flash_attention.py runs them."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)


@pytest.mark.parametrize("seed", [0, SEED, 0x7FFFFFFF])
@pytest.mark.parametrize("ids", [(0, 0, 0), (1, 3, 1), (7, 5, 0)])
def test_hash_keep_scale_is_bitwise_the_reference(seed, ids):
    want = np.asarray(jfa._hash_keep_scale(
        jnp.int32(seed), tuple(np.int32(i) for i in ids), (256, 256), 0.1))
    got = pfa.hash_keep_scale(seed, ids, (256, 256), 0.1).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(np.asarray(jfa._mix32(jnp.int32(seed), *map(np.int32, ids)))
               ) == pfa.mix32(seed, *ids)


def test_keep_tiles_follow_batch_pair_head_ids():
    tiles = pfa._keep_tiles(torch.tensor([SEED], dtype=torch.int32), 2, 4,
                            128, 0.3, None)
    for b in range(2):
        for hg in range(4):
            want = np.asarray(jfa._hash_keep_scale(
                jnp.int32(SEED), (np.int32(b), np.int32(hg // 2),
                                  np.int32(hg % 2)), (128, 128), 0.3))
            np.testing.assert_array_equal(tiles[b, hg].numpy(), want)


def _reference(qkv, g, h, d, causal, p):
    """paddle_tpu's kernels: (o, lse [B, H, S], dqkv) by jax.vjp."""
    seed = jnp.asarray([SEED], jnp.int32) if p else None
    scale = float(1.0 / np.sqrt(d))
    x = jnp.asarray(qkv)
    o, lse = jfa._fwd_qkv(x, scale, causal, d, p, seed)
    _, vjp = jax.vjp(lambda v: jfa._flash_qkv_p(v, seed, scale, causal, d,
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
    rng = np.random.default_rng(d + h + 10 * causal + int(100 * p))
    b, s = 2, 128
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    g = rng.standard_normal((b, s, h * d)).astype(np.float32)
    o_ref, lse_ref, dqkv_ref = _reference(qkv, g, h, d, causal, p)

    seed = SEED if p else None
    x = torch.from_numpy(qkv).requires_grad_(True)
    o = pfa.flash_attention_qkv(x, h, is_causal=causal, dropout_p=p,
                                seed=seed)
    o.backward(torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), o_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), dqkv_ref, atol=ATOL, rtol=0)
    seed_t = torch.tensor([SEED], dtype=torch.int32) if p else None
    o2, lse = pfa.flash_qkv_reference(torch.from_numpy(qkv), h, causal, p,
                                      seed_t)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL, rtol=0)
    assert torch.equal(o2, o.detach())


def test_dropout_seed_comes_from_the_current_generator():
    """Without a seed, each call draws one from the generator: the same
    generator state gives the same output, the next draw another."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((1, 128, 3 * 2 * 64))
                           .astype(np.float32))
    outs = []
    for _ in range(2):
        with prandom.rng_guard(prandom.step_generator(5, "cpu")):
            outs.append(pfa.flash_attention_qkv(qkv, 2, True, 0.5))
            outs.append(pfa.flash_attention_qkv(qkv, 2, True, 0.5))
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert not torch.equal(outs[0], outs[1])
    seed = prandom.flash_seed(prandom.step_generator(5, "cpu"))
    assert seed.dtype == torch.int32 and 0 <= int(seed) <= 0x7FFFFFFF


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = kernels.kernel_launch_counts()
    x = torch.zeros((1, 128, 3 * 2 * 64), requires_grad=True)
    pfa.flash_attention_qkv(x, 2, is_causal=True).sum().backward()
    assert kernels.kernel_launch_counts() == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pfa.flash_attention_qkv_fwd(x.detach(), 2, True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pfa.flash_attention_qkv_bwd(x.detach(), None, None, None, 2, True)


@pytest.mark.parametrize("mask", [False, True])
def test_gate_agrees_with_the_reference(monkeypatch, mask):
    monkeypatch.setattr(jkernels, "pallas_available", lambda: True)
    try:
        _gate_grid(mask)
    finally:     # the reference's gate counts the shapes it refuses
        jkernels.reset_kernel_fallback_counters()


def _gate_grid(mask):
    seen = set()
    for s in (64, 128, 200, 256, 2048, 2176):
        for h in (1, 2, 3, 4, 16):
            for d in (32, 64, 96, 128):
                for p in (0.0, 0.1, 1.0):
                    shape = (1, s, 3 * h * d)
                    jm = jnp.zeros((s, s), bool) if mask else None
                    want = jkernels.flash_attention_qkv_enabled(
                        jax.ShapeDtypeStruct(shape, jnp.float32), h, jm, p)
                    tm = torch.zeros((s, s), dtype=torch.bool) if mask \
                        else None
                    got = kernels.flash_attention_qkv_enabled(
                        torch.empty(shape, device="meta"), h, tm, p)
                    assert got == want, (s, h, d, p, mask)
                    seen.add(want)
    assert seen == ({False} if mask else {True, False})
