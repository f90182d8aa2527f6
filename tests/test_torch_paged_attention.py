"""The port's paged attention and paged-KV writers against paddle_tpu.

The plain version of the Hopper kernel (`paged_attention_reference`) is
held against paddle_tpu's Pallas kernel run in interpret mode and
against its gather oracle, on the same numpy-seeded inputs, in float32
at atol 2e-5 (the two differ only in summation order). The kernel itself
runs only on a card; chip_smoke.py holds it against the same plain
version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.paged_attention as jpa
import paddle_tpu.kernels.paged_kv as jkv
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import paged_kv
from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention_reference,
    paged_decode_attention,
)

ATOL = 2e-5


@pytest.fixture
def interpret_kernel():
    """Run paddle_tpu's Pallas kernel on the CPU (interpret mode), as
    tests/test_paged_attention.py does; always restore."""
    jpa._INTERPRET = True
    try:
        yield
    finally:
        jpa._INTERPRET = False


def _case(ps, w, seed, n=4, h=2, d=64, pmax=5):
    """Shuffled block table over n*pmax pages (+ the sentinel), ragged
    steps, left pads, and row 3 fully masked by valid_cols with its
    cursor on the last column (so every page of its row is read)."""
    rng = np.random.default_rng(seed)
    pages = n * pmax
    pool_k = rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32)
    pool_v = rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32)
    bt = rng.permutation(pages).reshape(n, pmax).astype(np.int32)
    lp = pmax * ps
    steps = rng.integers(1, lp - w + 1, (n,)).astype(np.int32)
    steps[3] = lp - w
    vc = np.ones((n, lp), np.int32)
    for r in range(n):
        vc[r, :rng.integers(0, steps[r])] = 0      # left pads
    vc[3] = 0
    q = rng.standard_normal((n, h, w, d)).astype(np.float32)
    return q, pool_k, pool_v, bt, steps, vc


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("w", [1, 3])
def test_reference_matches_pallas_kernel_interpret(interpret_kernel, ps, w):
    q, pk, pv, bt, st, vc = _case(ps, w, seed=ps * 10 + w)
    j_out, j_lse = jpa.fused_paged_attention(q, pk, pv, bt, st, vc, 64)
    out, lse = paged_attention_reference(*_t(q, pk, pv, bt, st, vc))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=ATOL,
                               rtol=0)
    # the fully masked row is the uniform average, not NaN
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(
        out[3].numpy(),
        np.broadcast_to(jkv.gather_pages(pv, bt)[3].mean(axis=1)[:, None],
                        out[3].shape), atol=ATOL, rtol=0)


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("w", [1, 3])
def test_decode_dispatcher_matches_gather_oracle(ps, w):
    q, pk, pv, bt, st, vc = _case(ps, w, seed=ps * 100 + w)
    ref = jpa.paged_decode_attention(q, pk, pv, bt, st, 64, valid_cols=vc)
    before = kernels.kernel_launch_counts()["paged_attention"]
    got = paged_decode_attention(*_t(q, pk, pv, bt, st), 64,
                                 valid_cols=torch.from_numpy(vc))
    assert got.shape == (4, w, 2 * 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert kernels.kernel_launch_counts()["paged_attention"] == before


@pytest.mark.parametrize("w", [1, 3])
def test_fully_masked_row_matches_the_tpu_kernel(interpret_kernel, w):
    """A row with no readable column up to its cursor, on distinct pages,
    gets the TPU kernel's result: the average over every page of its
    table. With W=3 the last query has one readable column (its own),
    the first two none."""
    q, pk, pv, bt, st, vc = _case(8, w, seed=40 + w)
    st[1] = 5
    vc[1] = 0
    if w == 3:
        vc[1, st[1] + 2] = 1
    j_out, j_lse = jpa.fused_paged_attention(q, pk, pv, bt, st, vc, 64)
    out, lse = paged_attention_reference(*_t(q, pk, pv, bt, st, vc))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=ATOL,
                               rtol=0)
    mean = jkv.gather_pages(pv, bt)[1].mean(axis=1)            # [H, D]
    for j in range(2 if w == 3 else 1):
        np.testing.assert_allclose(out[1, :, j].numpy(), mean, atol=ATOL,
                                   rtol=0)


def test_parked_row_reads_only_the_sentinel_page():
    """A parked serving slot (cursor 0, every table entry the sentinel
    page, nothing readable) averages the sentinel page: finite, never
    NaN, and the TPU kernel's result."""
    q, pk, pv, bt, st, vc = _case(8, 1, seed=7)
    sentinel = pk.shape[0] - 1
    bt[2], st[2], vc[2] = sentinel, 0, 0
    out, lse = paged_attention_reference(*_t(q, pk, pv, bt, st, vc))
    np.testing.assert_allclose(
        out[2, :, 0].numpy(), pv[sentinel].mean(axis=1), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse[2].numpy(), -1e30, rtol=1e-6)


def test_paged_kv_gather_and_token_writer_parity():
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((9, 2, 4, 8)).astype(np.float32)
    bt = rng.permutation(8).reshape(2, 4).astype(np.int32)
    np.testing.assert_array_equal(
        paged_kv.gather_pages(*_t(pool, bt)).numpy(),
        np.asarray(jkv.gather_pages(pool, bt)))
    pages = np.array([5, 8], np.int32)
    offs = np.array([3, 0], np.int32)
    val = rng.standard_normal((2, 2, 8)).astype(np.float32)
    ref = np.asarray(jkv.write_token_pages(jnp.asarray(pool), pages, offs,
                                          val))
    mine = torch.from_numpy(pool.copy())
    assert paged_kv.write_token_pages(mine, *_t(pages, offs, val)) is mine
    np.testing.assert_array_equal(mine.numpy(), ref)


@pytest.mark.parametrize("bucket,ps", [(8, 4), (6, 4), (5, 8)],
                         ids=["divides", "bucket6_ps4", "bucket5_ps8"])
def test_scatter_prompt_pages_parity(bucket, ps):
    """Including a bucket that is not a multiple of page_size: the last
    page's tail is zero-padded in both."""
    rng = np.random.default_rng(bucket * ps)
    n, h, d = 2, 2, 8
    pb = paged_kv.pages_for(bucket, ps)
    assert pb == jkv.pages_for(bucket, ps) == -(-bucket // ps)
    pool = rng.standard_normal((2 * pb + 3, h, ps, d)).astype(np.float32)
    rows = rng.permutation(2 * pb + 2)[:2 * (pb + 1)].reshape(
        2, pb + 1).astype(np.int32)
    local = rng.standard_normal((n, h, bucket, d)).astype(np.float32)
    ref = np.asarray(jkv.scatter_prompt_pages(jnp.asarray(pool), rows, local,
                                             ps))
    mine = torch.from_numpy(pool.copy())
    paged_kv.scatter_prompt_pages(mine, *_t(rows, local), ps)
    np.testing.assert_array_equal(mine.numpy(), ref)
