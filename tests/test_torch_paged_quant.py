"""The port's quantized KV pages against paddle_tpu.

- The quantizer and the writers (`quantize_tokens`, the three ``_q``
  writers and `scatter_tail_pages` with its sentinel redirect) give
  bit-identical pages and scales to ``paddle_tpu.kernels.paged_kv`` for
  int8 and fp8 (fp8 compared as uint8 views).
- The plain version of the quantized kernel (`paged_attention_reference`
  with scales) against paddle_tpu's Pallas kernel in interpret mode on
  int8 pages, and against its gather oracle on fp8 pages (the reference
  sends fp8 pages there), in float32 at atol 2e-5: both dequantize
  ``page.f32 * scale`` in f32 and differ only in summation order.
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
QUANT = {"int8": (torch.int8, jnp.int8),
         "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


@pytest.fixture
def interpret_kernel():
    """Run paddle_tpu's Pallas kernel on the CPU (interpret mode), as
    tests/test_paged_attention.py does; always restore."""
    jpa._INTERPRET = True
    try:
        yield
    finally:
        jpa._INTERPRET = False


def _bits(x):
    """A torch or jax array as comparable numpy bits (fp8 as uint8)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            x = x.view(torch.uint8)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype == jnp.float8_e4m3fn else a


def _torch_pool(a):
    """numpy pool (int8, or fp8 as its jnp dtype) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _tokens(rng, shape):
    """K/V-like values over a wide range, with one all-zero token and
    values that land on .5 quantization steps."""
    val = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1])[
        ..., None]).astype(np.float32)
    val.reshape(-1, shape[-1])[1] = 0.0
    row = val.reshape(-1, shape[-1])[2]
    row[:] = np.arange(shape[-1]) - 127.0 / 2      # max 127/2: .5 steps
    row[0] = -127.0 / 2
    return val


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_tokens_bit_identical(mode):
    tdt, jdt = QUANT[mode]
    val = _tokens(np.random.default_rng(1), (3, 4, 5, 64))
    q, s = paged_kv.quantize_tokens(torch.from_numpy(val), tdt)
    rq, rs = jkv.quantize_tokens(val, jdt)
    np.testing.assert_array_equal(_bits(q), _bits(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    # the all-zero token keeps scale 0 and dequantizes to zeros
    assert s.reshape(-1)[1] == 0 and not q.float().reshape(-1, 64)[1].any()


def _quant_pool(rng, mode, shape):
    """A quantized pool and its scales holding random written tokens."""
    pool, scale = jkv.quantize_tokens(
        rng.standard_normal(shape).astype(np.float32), QUANT[mode][1])
    return np.asarray(pool), np.asarray(scale)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_write_token_pages_q_parity(mode):
    rng = np.random.default_rng(2)
    pool, scale = _quant_pool(rng, mode, (9, 2, 4, 16))
    pages = np.array([5, 8, 0], np.int32)
    offs = np.array([3, 0, 2], np.int32)
    val = _tokens(rng, (3, 2, 16))
    rp, rsc = jkv.write_token_pages_q(jnp.asarray(pool), jnp.asarray(scale),
                                      pages, offs, val)
    mp, msc = _torch_pool(pool), torch.from_numpy(scale.copy())
    out = paged_kv.write_token_pages_q(mp, msc, torch.from_numpy(pages),
                                       torch.from_numpy(offs),
                                       torch.from_numpy(val))
    assert out[0] is mp and out[1] is msc
    np.testing.assert_array_equal(_bits(mp), _bits(rp))
    np.testing.assert_array_equal(msc.numpy(), np.asarray(rsc))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("bucket,ps", [(8, 4), (6, 4), (5, 8)],
                         ids=["divides", "bucket6_ps4", "bucket5_ps8"])
def test_scatter_prompt_pages_q_parity(mode, bucket, ps):
    """Including a bucket that is not a multiple of page_size: the last
    page's tail is (0, scale 0) in both."""
    rng = np.random.default_rng(bucket * ps)
    n, h, d = 2, 2, 16
    pb = paged_kv.pages_for(bucket, ps)
    pool, scale = _quant_pool(rng, mode, (2 * pb + 3, h, ps, d))
    rows = rng.permutation(2 * pb + 2)[:2 * (pb + 1)].reshape(
        2, pb + 1).astype(np.int32)
    local = _tokens(rng, (n, h, bucket, d))
    rp, rsc = jkv.scatter_prompt_pages_q(jnp.asarray(pool),
                                         jnp.asarray(scale), rows, local, ps)
    mp, msc = _torch_pool(pool), torch.from_numpy(scale.copy())
    paged_kv.scatter_prompt_pages_q(mp, msc, torch.from_numpy(rows),
                                    torch.from_numpy(local), ps)
    np.testing.assert_array_equal(_bits(mp), _bits(rp))
    np.testing.assert_array_equal(msc.numpy(), np.asarray(rsc))


def _tail_case(rng, ps=4, pmax=3, s=5):
    """Two rows over a full block table (every entry a real page) plus
    the sentinel; row 0's window runs past the table's last column, so
    two of its columns go to the sentinel page, not onto its own pages."""
    bt = rng.permutation(2 * pmax).reshape(2, pmax).astype(np.int32)
    col0 = np.array([pmax * ps - 3, 2], np.int32)
    return bt, col0, _tokens(rng, (2, 2, s, 16))


@pytest.mark.parametrize("mode", ["float32", "int8", "fp8"])
def test_scatter_tail_pages_parity_with_the_sentinel_redirect(mode):
    rng = np.random.default_rng(11)
    bt, col0, local = _tail_case(rng)
    sentinel = 2 * 3
    if mode == "float32":
        pool = rng.standard_normal((sentinel + 1, 2, 4, 16)).astype(
            np.float32)
        ref = np.asarray(jkv.scatter_tail_pages(jnp.asarray(pool), bt, col0,
                                                local))
        mine = torch.from_numpy(pool.copy())
        paged_kv.scatter_tail_pages(mine, *map(torch.from_numpy,
                                               (bt, col0, local)))
        np.testing.assert_array_equal(mine.numpy(), ref)
        before, after = pool, ref
    else:
        pool, scale = _quant_pool(rng, mode, (sentinel + 1, 2, 4, 16))
        rp, rsc = jkv.scatter_tail_pages_q(jnp.asarray(pool),
                                           jnp.asarray(scale), bt, col0,
                                           local)
        mp, msc = _torch_pool(pool), torch.from_numpy(scale.copy())
        paged_kv.scatter_tail_pages_q(mp, msc, *map(torch.from_numpy,
                                                    (bt, col0, local)))
        np.testing.assert_array_equal(_bits(mp), _bits(rp))
        np.testing.assert_array_equal(msc.numpy(), np.asarray(rsc))
        before, after = scale, np.asarray(rsc)
    # row 0's last real page keeps its first column; the two columns past
    # the window landed on the sentinel page
    last = bt[0, -1]
    np.testing.assert_array_equal(after[last, :, 0], before[last, :, 0])
    assert not np.array_equal(after[sentinel, :, :2], before[sentinel, :, :2])


def _quant_case(mode, ps, w, seed, n=4, h=2, d=64, pmax=5):
    """A shuffled block table over quantized pages (standard normals
    written by the reference's quantizer) plus the sentinel, ragged steps, left pads,
    and row 3 fully masked by valid_cols with its cursor on the last
    column (so every page of its row is read)."""
    rng = np.random.default_rng(seed)
    pages = n * pmax
    jdt = QUANT[mode][1]
    pk, ks = (np.array(a) for a in jkv.quantize_tokens(
        rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32), jdt))
    pv, vs = (np.array(a) for a in jkv.quantize_tokens(
        rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32), jdt))
    bt = rng.permutation(pages).reshape(n, pmax).astype(np.int32)
    lp = pmax * ps
    steps = rng.integers(1, lp - w + 1, (n,)).astype(np.int32)
    steps[3] = lp - w
    vc = np.ones((n, lp), np.int32)
    for r in range(n):
        vc[r, :rng.integers(0, steps[r])] = 0      # left pads
    vc[3] = 0
    q = rng.standard_normal((n, h, w, d)).astype(np.float32)
    return q, pk, pv, bt, steps, vc, ks, vs


def _port_args(q, pk, pv, bt, st, vc, ks, vs):
    t = torch.from_numpy
    return (t(q), _torch_pool(pk), _torch_pool(pv), t(bt), t(st), t(vc),
            t(ks), t(vs))


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("w", [1, 3, 5])
def test_int8_reference_matches_pallas_kernel_interpret(interpret_kernel,
                                                        ps, w):
    q, pk, pv, bt, st, vc, ks, vs = _quant_case("int8", ps, w,
                                                seed=ps * 10 + w)
    j_out, j_lse = jpa.fused_paged_attention(q, pk, pv, bt, st, vc, 64,
                                             k_scale=ks, v_scale=vs)
    out, lse = paged_attention_reference(
        *_port_args(q, pk, pv, bt, st, vc, ks, vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=ATOL,
                               rtol=0)
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("w", [1, 5])
def test_quantized_dispatcher_matches_gather_oracle(mode, ps, w):
    """The decode/verify dispatcher on quantized pools against the
    reference's gather oracle (where its fp8 pages go), f32: the oracle
    rounds the dequantized view to q's dtype, a no-op in f32."""
    q, pk, pv, bt, st, vc, ks, vs = _quant_case(mode, ps, w,
                                                seed=ps * 100 + w)
    ref = jpa.paged_decode_attention(q, pk, pv, bt, st, 64, valid_cols=vc,
                                     k_scale=ks, v_scale=vs)
    before = kernels.kernel_launch_counts()
    tq, tk, tv, tbt, tst, tvc, tks, tvs = _port_args(q, pk, pv, bt, st, vc,
                                                     ks, vs)
    got = paged_decode_attention(tq, tk, tv, tbt, tst, 64, valid_cols=tvc,
                                 k_scale=tks, v_scale=tvs)
    assert got.shape == (4, w, 2 * 64)
    # row 3 has no readable column: the reference's oracle and the TPU
    # kernel differ there (finfo.min/2 against -1e30); the engine never
    # reads such a row
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(ref)[:3],
                               atol=ATOL, rtol=0)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert kernels.kernel_launch_counts() == before


def test_quantized_pages_dequantize_as_the_float_pages_they_replace():
    """A pool written through the quantized writer attends within the
    quantization error of the float pool written with the same values:
    the scale rides with its page through the block table."""
    rng = np.random.default_rng(5)
    q, pk, pv, bt, st, vc, _, _ = _quant_case("int8", 8, 3, seed=9)
    fk = rng.standard_normal(pk.shape).astype(np.float32)
    fv = rng.standard_normal(pv.shape).astype(np.float32)
    t = torch.from_numpy
    qk, sk = paged_kv.quantize_tokens(t(fk))
    qv, sv = paged_kv.quantize_tokens(t(fv))
    out_q, _ = paged_attention_reference(t(q), qk, qv, t(bt), t(st), t(vc),
                                         sk, sv)
    out_f, _ = paged_attention_reference(t(q), t(fk), t(fv), t(bt), t(st),
                                         t(vc))
    # int8 rounding: at most half a step (max|v| / 254) per element
    err = (out_q - out_f).abs().max().item()
    assert 0 < err < 3.0 * np.abs(fv).max() / 254
