"""The paged-attention path at head dims other than 64 and 128 and at
page sizes that are not multiples of 8, on the CPU.

The Hopper kernel (csrc/paged_attention.cu) takes any head dim up to 512
(above 256 at width 512 in 2-query tiles) and any page size, with the
pools at the model's own D. What of that is plain Python is pinned here:

- the kernel's plan (`kernel_width`, `chunk_cols`, `query_tile`,
  `plan_splits`) for every D from 1 to 256 and every page size from 1 to
  64: the padded width holds D in whole 32-lane coordinates, the ring
  chunks of a page cover its columns exactly (the last one partial), and
  the split plan covers the table; at D 320 and 512 the same, in
  2-query tiles;
- the plain version and `paged_decode_attention` against paddle_tpu's
  `paged_decode_attention` (which routes these shapes to its gather
  oracle) on numpy-seeded float32 inputs, D in {16, 80, 200, 320}, ps
  in {3, 4, 16}, float and int8 pages, W 1 and 5, at atol 1e-5;
- the port's `Engine` against paddle_tpu's ``Engine(kv_mode="paged")``
  on a 2-layer GPT with 2 heads of 80 and 4-column pages, and on a
  1-layer GPT with 2 heads of 320: identical greedy tokens and page
  accounting.

The kernel itself runs only on a card: tests/test_torch_kernels_cuda.py
and chip_smoke.py hold it against the same plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import paged_kv
from paddle_tpu_torch.models import GPTForPretraining, load_paddle_tpu_state_dict
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.serving import Engine

import _torch_serving as ts

ATOL = 1e-5
H100_SMS = 132


# ------------------------------------------------------------- the plan
def test_kernel_width_holds_every_head_dim_up_to_256():
    widths = (32, 64, 96, 128, 256)
    for d in range(1, 257):
        width = pa.kernel_width(d)
        assert width >= d and width in widths, d
        # the least instantiated width that holds d
        assert all(w < d for w in widths if w < width), d
        for itemsize in (4, 2, 1):
            chunk = pa.chunk_cols(width, itemsize)
            assert chunk in (8, 16)
            # 4 warps' two-stage rings of K and V chunks fit the block
            assert 4 * 2 * 2 * chunk * width * itemsize <= 132 * 1024
        for w in (1, 4, 5, 8):
            tile = pa.query_tile(w, d)
            assert tile == (8 if w > 4 and width <= 128 else 4), (d, w)


def test_head_dims_above_256_name_roadmap_c6():
    """C.6, closed: heads of 257 to 512 run at width 512 in 2-query
    tiles (chunks of 16, 8 or 4 columns by the page type's row bytes, the
    rings within the block's shared memory); above 512 it raises."""
    for d in (257, 320, 384, 511, 512):
        assert pa.kernel_width(d) == 512
        for w in (1, 2, 5, 9):
            assert pa.query_tile(w, d) == 2
    for itemsize, chunk in ((4, 4), (2, 8), (1, 16)):
        assert pa.chunk_cols(512, itemsize) == chunk
        assert 4 * 2 * 2 * chunk * 512 * itemsize <= 132 * 1024
    with pytest.raises(NotImplementedError, match="up to 512"):
        pa.kernel_width(513)


def test_ring_chunks_cover_every_page_size():
    """The kernel walks a page in ceil(ps / chunk) chunks of columns
    [i * chunk, min((i + 1) * chunk, ps)): every in-page column once; the
    split plan covers the table at every page size."""
    for ps in range(1, 65):
        for width in (32, 64, 96, 128, 256):
            for itemsize in (4, 2, 1):
                chunk = pa.chunk_cols(width, itemsize)
                n = -(-ps // chunk)
                cols = [c for i in range(n)
                        for c in range(i * chunk, min((i + 1) * chunk, ps))]
                assert cols == list(range(ps)), (ps, chunk)
        for d in (16, 80, 200):
            for w in (1, 5):
                splits, pps = pa.plan_splits(8, 32, w, 41, ps, H100_SMS, d)
                assert splits * pps >= 41 > (splits - 1) * pps


def test_plan_covers_the_table_at_head_dims_320_and_512():
    """Above 256 the plan is width 512, 2-query tiles, ring chunks of the
    page type's row bytes; the split plan covers the table at every page
    size and window, and the combine's tickets count one a 2-query
    tile."""
    for d in (320, 512):
        width = pa.kernel_width(d)
        assert width == 512 and width % 32 == 0 and width >= d
        for ps in (1, 3, 4, 16, 64):
            for itemsize in (4, 2, 1):
                chunk = pa.chunk_cols(width, itemsize)
                n = -(-ps // chunk)
                cols = [c for i in range(n)
                        for c in range(i * chunk, min((i + 1) * chunk, ps))]
                assert cols == list(range(ps))
            for w in (1, 2, 5, 9):
                assert pa.query_tile(w, d) == 2
                splits, pps = pa.plan_splits(8, 5, w, 41, ps, H100_SMS, d)
                assert splits * pps >= 41 > (splits - 1) * pps


# ------------------------------------------- the dispatcher against paddle_tpu
def _case(seed, d, ps, w, n=3, h=2, pmax=9):
    """Shuffled table, ragged steps and left pads (every row keeps a
    readable column, so the reference's oracle and the port agree on
    every row)."""
    rng = np.random.default_rng(seed)
    pages = n * pmax
    pool_k = rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32)
    pool_v = rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32)
    bt = rng.permutation(pages).reshape(n, pmax).astype(np.int32)
    lp = pmax * ps
    steps = np.array([lp - w, ps + 1, lp // 2], np.int32)[:n]
    vc = np.ones((n, lp), np.int32)
    vc[0, :ps + 1] = 0                       # left pads past a page
    vc[2, :3] = 0
    q = rng.standard_normal((n, h, w, d)).astype(np.float32)
    return q, pool_k, pool_v, bt, steps, vc


def _quantized(pool):
    q, s = paged_kv.quantize_tokens(torch.from_numpy(pool), torch.int8)
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("d", [16, 80, 200, 320])
@pytest.mark.parametrize("ps", [3, 4, 16])
@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("pages", ["float32", "int8"])
def test_dispatcher_matches_the_reference(d, ps, w, pages):
    q, pk, pv, bt, st, vc = _case(d * 7 + ps * 3 + w, d, ps, w)
    kw_j, kw_t = {}, {}
    if pages == "int8":
        (pk, ks), (pv, vs) = _quantized(pk), _quantized(pv)
        kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kw_t = dict(k_scale=torch.from_numpy(ks),
                    v_scale=torch.from_numpy(vs))
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(st), d, valid_cols=jnp.asarray(vc), **kw_j))
    t = [torch.from_numpy(a) for a in (q, pk, pv, bt, st, vc)]
    got = pa.paged_decode_attention(*t[:5], d, valid_cols=t[5], **kw_t)
    assert tuple(got.shape) == (q.shape[0], w, q.shape[1] * d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    out, lse = pa.paged_attention_reference(*t, **kw_t)
    np.testing.assert_allclose(
        out.permute(0, 2, 1, 3).reshape(got.shape).numpy(), want, atol=ATOL,
        rtol=0)
    assert np.isfinite(lse.numpy()).all()


@pytest.mark.parametrize("d,ps", [(80, 4), (16, 3), (200, 16)])
def test_tail_segment_matches_the_reference(d, ps):
    """The beam's tail read (the same kernel at W = 1, one cursor for
    every row) at these shapes, against paddle_tpu's."""
    q, pk, pv, bt, _, _ = _case(d + ps, d, ps, 1)
    gen_col = bt.shape[1] * ps - 2
    jo, jl = jpa.paged_tail_segment(jnp.asarray(q[:, :, 0]), jnp.asarray(pk),
                                    jnp.asarray(pv), jnp.asarray(bt),
                                    gen_col, d)
    to, tl = pa.paged_tail_segment(torch.from_numpy(q[:, :, 0]),
                                   torch.from_numpy(pk), torch.from_numpy(pv),
                                   torch.from_numpy(bt), gen_col, d)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=1e-6)


# ----------------------------------------------------- the Engine at D = 80
paddle.seed(113)
# 2 layers, 2 heads of 80 (gpt3-2.7b's head dim), vocab 256
_CFG = dict(vocab_size=256, hidden_size=160, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=320,
            max_position_embeddings=64, use_flash_attention=False)
JAX_MODEL = JaxGPT(JaxGPTModel(JaxGPTConfig(**_CFG)))
JAX_MODEL.eval()
MODEL = load_paddle_tpu_state_dict(
    GPTForPretraining(GPTConfig(**_CFG), device="cpu"),
    {k: np.asarray(v._value) for k, v in JAX_MODEL.state_dict().items()})


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_at_head_dim_80_and_page_size_4_matches_the_reference(
        kv_quant):
    rng = np.random.default_rng(41)
    rows = [rng.integers(1, 255, (n,)).astype("int64") for n in (7, 3, 12)]
    outs, stats = [], []
    kw = dict(slots=2, max_len=16 + 6, prefill_buckets=(8, 16), page_size=4,
              kv_quant=kv_quant)
    for eng in (JaxEngine(JAX_MODEL, kv_mode="paged", **kw),
                Engine(MODEL, device="cpu", kv_mode="paged", **kw)):
        h0 = eng.submit(rows[0], max_new_tokens=6)
        eng.step()
        h1 = eng.submit(rows[1], max_new_tokens=6)
        h2 = eng.submit(rows[2], max_new_tokens=6)
        outs.append([h.result() for h in (h0, h1, h2)])
        stats.append(eng.stats())
    assert outs[1] == outs[0]
    for s in stats:
        assert s.completed == 3
        assert s.kv_pages_in_use == 0 and s.kv_pages_free == s.kv_pages_total
    assert (stats[1].decode_steps, stats[1].prefill_steps) == (
        stats[0].decode_steps, stats[0].prefill_steps)


# ---------------------------------------------------- the Engine at D = 320
# 1 layer, 2 heads of 320 (above the kernel's old 256 limit), vocab 256,
# weights numpy-seeded at std 0.3 so that greedy streams vary
_CFG_320 = dict(vocab_size=256, hidden_size=640, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=1280,
                max_position_embeddings=64, use_flash_attention=False)
_JAX_320 = JaxGPT(JaxGPTModel(JaxGPTConfig(**_CFG_320)))
_JAX_320.eval()
_ARRAYS_320 = ts.seeded_arrays(_JAX_320, 320)
_JAX_320.set_state_dict(_ARRAYS_320)
_MODEL_320 = load_paddle_tpu_state_dict(
    GPTForPretraining(GPTConfig(**_CFG_320), device="cpu"), _ARRAYS_320)


@pytest.mark.parametrize("spec_k", [0, 2])
def test_engine_at_head_dim_320_matches_the_reference(spec_k):
    rng = np.random.default_rng(43)
    rows = [rng.integers(1, 255, (n,)).astype("int64") for n in (7, 3, 12)]
    outs, stats = [], []
    kw = dict(slots=2, max_len=16 + 6 + spec_k, prefill_buckets=(8, 16),
              page_size=4, spec_k=spec_k)
    for eng in (JaxEngine(_JAX_320, kv_mode="paged", **kw),
                Engine(_MODEL_320, device="cpu", kv_mode="paged", **kw)):
        h0 = eng.submit(rows[0], max_new_tokens=6)
        eng.step()
        h1 = eng.submit(rows[1], max_new_tokens=6)
        h2 = eng.submit(rows[2], max_new_tokens=6)
        outs.append([list(h.result()) for h in (h0, h1, h2)])
        stats.append(eng.stats())
    assert outs[1] == outs[0]
    assert len({t for o in outs[1] for t in o}) > 3
    for s in stats:
        assert s.completed == 3
        assert s.kv_pages_in_use == 0 and s.kv_pages_free == s.kv_pages_total
    assert (stats[1].decode_steps, stats[1].prefill_steps) == (
        stats[0].decode_steps, stats[0].prefill_steps)
