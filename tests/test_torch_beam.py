"""The port's beam search against paddle_tpu's, and the beam's kernels.

``gpt-test`` weights from a numpy seed go into both packages. The
reference's beam functions (`_build_beam_fn`, gather and paged) are
built once per case for the module: each build is a whole XLA compile.
Its paged runs take the fused tail in Pallas interpret mode (its
``interpret_kernel`` fixture, ``tests/test_paged_attention.py:56-60``),
so both packages merge a tail segment into the shared prompt segment;
the port's tail is `paged_tail_segment`'s plain version on the CPU. Beam
tokens must be identical, with an EOS that fires mid-beam, the length
penalty, left-padded prompts, and int8 and fp8 tail pools at page size 2
(a copy-on-write almost every step). `paged_tail_segment`,
`merge_attention_segments` and `beam_shared_attention` hold against the
reference's functions at float32 (atol 1e-5: summation order only).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import paged_kv as jpkv
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import paged_kv
from paddle_tpu_torch.models import GPTForPretraining, load_paddle_tpu_state_dict
from paddle_tpu_torch.models import generation as gen

jpa = importlib.import_module("paddle_tpu.kernels.paged_attention")

ATOL = 1e-5
B, PROMPT, MAX_NEW = 2, 5, 7


def _seeded_arrays(model, seed):
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in model.state_dict().items():
        a = np.asarray(v._value)
        if a.ndim == 2:
            a = (rng.standard_normal(a.shape) * 0.3).astype(a.dtype)
        elif a.ndim == 1 and a.dtype == np.float32:
            a = (a + rng.standard_normal(a.shape) * 0.05).astype(a.dtype)
        arrays[k] = a
    return arrays


JAX_MODEL = JaxGPT(JaxGPTModel(jax_gpt_config("gpt-test")))
JAX_MODEL.eval()
_ARRAYS = _seeded_arrays(JAX_MODEL, 17)
JAX_MODEL.set_state_dict(_ARRAYS)
MODEL = load_paddle_tpu_state_dict(GPTForPretraining("gpt-test",
                                                     device="cpu"), _ARRAYS)
RNG = np.random.default_rng(31)
IDS = RNG.integers(1, 255, (B, PROMPT)).astype("int64")
MASK = np.ones_like(IDS)
MASK[1, :2] = 0                                # row 1: 3 real tokens
IDS_PADDED = np.where(MASK == 1, IDS, 0)
# an EOS that greedy emits early, so it fires mid-beam
EOS = int(np.asarray(JAX_MODEL.generate(paddle.to_tensor(IDS),
                                        max_new_tokens=3)._value)[0, 1])
PAD = 999                                      # outside the 256-token vocab

_REF = {}


@pytest.fixture
def interpret_kernel():
    """paddle_tpu's fused paged kernel on the CPU (Pallas interpret
    mode), restored after the test."""
    jpa._INTERPRET = True
    try:
        yield
    finally:
        jpa._INTERPRET = False


def _ids(masked):
    return (IDS_PADDED, MASK) if masked else (IDS, None)


def _reference(kv, k, masked, eos, lp, page_size=16, kv_quant=None):
    """The reference beam fn's output for one case, built once."""
    key = (kv, k, masked, eos, lp, page_size, kv_quant)
    if key not in _REF:
        fn = JAX_MODEL._build_beam_fn(
            B, PROMPT, MAX_NEW, k, eos, PAD if eos is not None else None, lp,
            with_mask=masked, kv_impl=kv, page_size=page_size,
            kv_quant=kv_quant)
        ids, mask = _ids(masked)
        args = [[t._value for t in JAX_MODEL.state_dict().values()], ids,
                jax.random.PRNGKey(0)]
        if masked:
            args.append(jnp.asarray(mask, jnp.int32))
        with JAX_MODEL._serving_guard():
            _REF[key] = np.asarray(fn(*args))
    return _REF[key]


def _port(kv, k, masked, eos, lp, page_size=16, kv_quant=None):
    fn = MODEL._build_beam_fn(B, PROMPT, MAX_NEW, k, eos,
                              PAD if eos is not None else None, lp,
                              with_mask=masked, kv_impl=kv,
                              page_size=page_size, kv_quant=kv_quant)
    ids, mask = _ids(masked)
    with torch.inference_mode():
        out = fn(torch.from_numpy(ids),
                 None if mask is None else torch.from_numpy(mask))
    return out.numpy()


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kv", ["gather", "paged"])
def test_beam_matches_reference(kv, k, masked, interpret_kernel):
    """EOS mid-beam, out-of-vocab pad, length penalty 1.0."""
    got = _port(kv, k, masked, EOS, 1.0)
    np.testing.assert_array_equal(got, _reference(kv, k, masked, EOS, 1.0))
    assert got.shape == (B, MAX_NEW)


def test_beam_without_eos_paged_equals_gather(interpret_kernel):
    """No EOS, no penalty: the paged beam equals the reference and the
    port's own gather oracle."""
    paged = _port("paged", 3, False, None, 0.0)
    np.testing.assert_array_equal(
        paged, _reference("paged", 3, False, None, 0.0))
    np.testing.assert_array_equal(paged, _port("gather", 3, False, None, 0.0))


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_tail_pools_at_page_size_2(kv_quant, interpret_kernel):
    """1-byte tail pages at page size 2: a copy-on-write of the partial
    page (data and scale rows) nearly every step. The reference serves
    fp8 tails through its one-softmax oracle, the port through the tail
    segment and the merge: the same tokens."""
    got = _port("paged", 3, True, EOS, 1.0, page_size=2, kv_quant=kv_quant)
    np.testing.assert_array_equal(got, _reference(
        "paged", 3, True, EOS, 1.0, page_size=2, kv_quant=kv_quant))
    with pytest.raises(ValueError, match="kv_quant"):
        MODEL._build_beam_fn(B, PROMPT, MAX_NEW, 3, None, None, 0.0,
                             kv_impl="gather", kv_quant=kv_quant)


def test_generate_beam_surface_matches_reference(interpret_kernel):
    """`generate(decode_strategy="beam_search")` end to end, both KV
    layouts, with an attention mask."""
    kw = dict(max_new_tokens=5, decode_strategy="beam_search", num_beams=2,
              eos_token_id=EOS, pad_token_id=PAD, length_penalty=1.0)
    for kv in ("paged", "gather"):
        ref = JAX_MODEL.generate(paddle.to_tensor(IDS_PADDED),
                                 attention_mask=paddle.to_tensor(MASK),
                                 beam_kv=kv, **kw)
        got = MODEL.generate(IDS_PADDED, attention_mask=MASK, beam_kv=kv,
                             **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref._value))
    with pytest.raises(ValueError, match="kv_impl"):
        MODEL.generate(IDS, beam_kv="dense", **kw)
    with pytest.raises(ValueError, match="outside the vocab"):
        MODEL.generate(IDS, max_new_tokens=3, decode_strategy="beam_search",
                       num_beams=2, eos_token_id=300)
    with pytest.raises(ValueError, match="num_beams"):
        MODEL.generate(IDS, decode_strategy="beam_search", num_beams=0)


def test_beam_runs_no_kernel_on_the_cpu():
    """On the CPU the tail read takes the plain version: no launch is
    counted."""
    before = kernels.kernel_launch_counts()
    _port("paged", 2, False, None, 0.0)
    assert kernels.kernel_launch_counts() == before


def _pools(rng, n, h, d, ps, pg, quant):
    pk, pv = (rng.standard_normal((n * pg, h, ps, d)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(n * pg).reshape(n, pg).astype(np.int32)
    if not quant:
        return (pk, pv), None, bt
    (qk, sk), (qv, sv) = (paged_kv.quantize_tokens(torch.from_numpy(p))
                          for p in (pk, pv))
    return ((qk.numpy(), qv.numpy()), (sk.numpy(), sv.numpy()), bt)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("gen_col", [0, 5, 11])
def test_paged_tail_segment_matches_reference(gen_col, quant,
                                              interpret_kernel):
    """(out, lse) of the tail read against the reference's fused tail
    (interpret mode) at N=4, H=2, D=32, ps=4, Pg=3, f32 queries, on f32
    and int8 pages; gen column 0 is a tail of one column."""
    rng = np.random.default_rng(gen_col)
    n, h, d, ps, pg = 4, 2, 32, 4, 3
    (pk, pv), scales, bt = _pools(rng, n, h, d, ps, pg, quant)
    q = rng.standard_normal((n, h, d)).astype(np.float32)
    skw = {} if scales is None else dict(k_scale=scales[0], v_scale=scales[1])
    ref_o, ref_lse = jpa.paged_tail_segment(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        gen_col, d, **{k: jnp.asarray(v) for k, v in skw.items()})
    out, lse = pa.paged_tail_segment(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(bt), gen_col, d,
        **{k: torch.from_numpy(v) for k, v in skw.items()})
    assert out.shape == (n, h, d) and lse.shape == (n, h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_tail_segment(torch.from_numpy(q), torch.from_numpy(pk),
                              torch.from_numpy(pv), torch.from_numpy(bt),
                              gen_col, d // 2)


def test_merge_attention_segments_matches_reference():
    rng = np.random.default_rng(5)
    o1, o2 = (rng.standard_normal((6, 3, 16)).astype(np.float32)
              for _ in range(2))
    lse1 = (rng.standard_normal((6, 3)) * 4).astype(np.float32)
    lse2 = (rng.standard_normal((6, 3)) * 4).astype(np.float32)
    lse2[0, 0] = -1e30                         # an empty segment
    ref = jpa.merge_attention_segments(*(jnp.asarray(a) for a in
                                         (o1, lse1, o2, lse2)))
    got = pa.merge_attention_segments(*(torch.from_numpy(a) for a in
                                        (o1, lse1, o2, lse2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # merging two halves of one softmax gives the whole
    q = rng.standard_normal((2, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 10, 16)).astype(np.float32)
    s = torch.einsum("hd,hld->hl", torch.from_numpy(q), torch.from_numpy(kv))
    whole = torch.einsum("hl,hld->hd", torch.softmax(s, -1),
                         torch.from_numpy(kv))
    halves = []
    for sl in (slice(0, 4), slice(4, 10)):
        halves += [torch.einsum("hl,hld->hd", torch.softmax(s[:, sl], -1),
                                torch.from_numpy(kv[:, sl])),
                   torch.logsumexp(s[:, sl], -1)]
    torch.testing.assert_close(pa.merge_attention_segments(*halves), whole,
                               atol=ATOL, rtol=0)


def test_beam_shared_attention_matches_reference():
    rng = np.random.default_rng(6)
    b, k, h, d, sc, lg = 2, 3, 2, 16, 7, 5
    qh = rng.standard_normal((b * k, h, d)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, h, sc, d)).astype(np.float32)
              for _ in range(2))
    gk, gv = (rng.standard_normal((b * k, h, lg, d)).astype(np.float32)
              for _ in range(2))
    ctx_valid = np.ones((b, sc), np.int32)
    ctx_valid[1, :3] = 0
    gen_valid = (np.arange(lg) <= 2).astype(np.int32)
    for kw in (dict(), dict(ctx_valid=ctx_valid, gen_valid=gen_valid)):
        ref = jpkv.beam_shared_attention(
            *(jnp.asarray(a) for a in (qh, ck, cv, gk, gv)), d,
            **{n: jnp.asarray(v) for n, v in kw.items()})
        got = paged_kv.beam_shared_attention(
            *(torch.from_numpy(a) for a in (qh, ck, cv, gk, gv)), d,
            **{n: torch.from_numpy(v) for n, v in kw.items()})
        assert got.shape == (b * k, 1, h * d)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_paged_beam_step_equals_the_one_softmax_oracle():
    """One layer's paged beam attention (prompt segment + tail segment,
    merged) against `beam_shared_attention` over the dense tail view."""
    rng = np.random.default_rng(8)
    attn = MODEL.gpt.h[0].attn
    b, k, h, d, sp, ps, pg, j = 2, 3, 4, 16, 6, 2, 3, 4
    n = b * k
    x = torch.from_numpy(rng.standard_normal((n, 1, 64)).astype(np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((b, h, sp, d)).astype(
        np.float32)) for _ in range(2))
    pk, pv = (torch.from_numpy(rng.standard_normal((n * pg, h, ps, d)).astype(
        np.float32)) for _ in range(2))
    bt = torch.from_numpy(rng.permutation(n * pg).reshape(n, pg).astype(
        np.int32))
    pad_mask = torch.ones((b, sp), dtype=torch.long)
    pad_mask[0, :2] = 0
    with torch.inference_mode():
        got = attn.forward_decode_beam_paged(x, ck, cv, pk, pv, bt, j,
                                             pad_mask=pad_mask)
        gen_valid = torch.arange(pg * ps) <= j
        ctx = paged_kv.beam_shared_attention(
            attn._heads(x)[0][:, :, 0], ck, cv, paged_kv.gather_pages(pk, bt),
            paged_kv.gather_pages(pv, bt), d, ctx_valid=pad_mask,
            gen_valid=gen_valid)
        want = attn.out_proj(ctx)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, -1e30, 3.0, 2.0, -1e30, -1e30],
                  [-1e30] * 8, [0.5, 0.5, 0.5, 0.5, 1.0, 1.0, 0.0, 0.5]],
                 np.float32)
    for k in (1, 2, 3, 5):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        v, i = gen._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
