"""The port's `generate()` against paddle_tpu's on the same weights.

``gpt-test`` weights are drawn from a numpy seed (wide enough that
greedy streams do not repeat one token), set into paddle_tpu's model and
carried over with `load_paddle_tpu_state_dict`. Greedy streams — dense,
left-padded, with an EOS early exit and an out-of-vocab pad, with
weight-only int8 weights, streamed — must be token-identical; sampled
streams reproduce per seed and are distributed as the reference's (a
two-sample chi-square). The weight quantizer holds bit for bit, and
``Engine(weight_quant="int8")`` serves the reference engine's tokens.
"""
import numpy as np
import pytest
import torch
from scipy.stats import chi2

import paddle_tpu as paddle
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch import kernels
from paddle_tpu_torch.models import GPTForPretraining, load_paddle_tpu_state_dict
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.serving import Engine

WEIGHT_STD = 0.3


def seeded_arrays(model, seed):
    """``model``'s state dict with numpy-seeded values: matrices normal
    ``(0, WEIGHT_STD)``, LayerNorm scales and biases perturbed around
    their init, markers kept."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in model.state_dict().items():
        a = np.asarray(v._value)
        if a.ndim == 2:
            a = (rng.standard_normal(a.shape) * WEIGHT_STD).astype(a.dtype)
        elif a.ndim == 1 and a.dtype == np.float32:
            a = (a + rng.standard_normal(a.shape) * 0.05).astype(a.dtype)
        arrays[k] = a
    return arrays


def both_models(seed=5):
    """(paddle_tpu model, port model) on the same seeded weights."""
    jm = JaxGPT(JaxGPTModel(jax_gpt_config("gpt-test")))
    jm.eval()
    arrays = seeded_arrays(jm, seed)
    jm.set_state_dict(arrays)
    return jm, load_paddle_tpu_state_dict(
        GPTForPretraining("gpt-test", device="cpu"), arrays)


JAX_MODEL, MODEL = both_models()
RNG = np.random.default_rng(11)
IDS = RNG.integers(1, 255, (3, 7)).astype("int64")


def _ref(ids, **kw):
    return np.asarray(JAX_MODEL.generate(paddle.to_tensor(ids), **kw)._value)


def _port(ids, **kw):
    return MODEL.generate(ids, **kw).cpu().numpy()


def _left_padded():
    """IDS with rows of 7, 4 and 2 real tokens, left-padded with id 0."""
    mask = np.zeros_like(IDS)
    for r, n in enumerate((7, 4, 2)):
        mask[r, 7 - n:] = 1
    return np.where(mask == 1, IDS, 0), mask


def test_greedy_dense_matches_reference():
    out = _port(IDS, max_new_tokens=10)
    np.testing.assert_array_equal(out, _ref(IDS, max_new_tokens=10))
    assert out.dtype == np.int64 and out.shape == (3, 10)
    assert len(set(out[0].tolist())) > 3          # a stream, not one token


def test_greedy_left_padded_matches_reference():
    ids, mask = _left_padded()
    ref = _ref(ids, max_new_tokens=8, attention_mask=paddle.to_tensor(mask))
    np.testing.assert_array_equal(
        _port(ids, max_new_tokens=8, attention_mask=mask), ref)
    # an all-ones mask is the dense batch
    np.testing.assert_array_equal(
        _port(IDS, max_new_tokens=4, attention_mask=np.ones_like(IDS)),
        _ref(IDS, max_new_tokens=4))


def test_greedy_eos_early_exit_with_out_of_vocab_pad():
    """EOS = a token row 0 emits early: that row fills with the pad (999,
    outside the 256-token vocab) after it, the others run on, and a batch
    in which every row finishes ends the loop early."""
    dense = _ref(IDS, max_new_tokens=8)
    eos = int(dense[0, 2])
    kw = dict(max_new_tokens=8, eos_token_id=eos, pad_token_id=999)
    out = _port(IDS, **kw)
    np.testing.assert_array_equal(out, _ref(IDS, **kw))
    first = list(out[0]).index(eos)
    assert (out[0, first + 1:] == 999).all()
    # every row hits EOS at its first token: the loop stops after it
    firsts = dense[:, 0]
    one = IDS[[0]]
    kw1 = dict(max_new_tokens=6, eos_token_id=int(firsts[0]))
    np.testing.assert_array_equal(_port(one, **kw1), _ref(one, **kw1))
    # without pad_token_id the EOS id pads
    kw2 = dict(max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(_port(IDS, **kw2), _ref(IDS, **kw2))


def test_weight_only_int8_matches_reference():
    kw = dict(max_new_tokens=8, weight_quant="int8")
    out = _port(IDS, **kw)
    np.testing.assert_array_equal(out, _ref(IDS, **kw))
    ids, mask = _left_padded()
    np.testing.assert_array_equal(
        _port(ids, attention_mask=mask, **kw),
        _ref(ids, attention_mask=paddle.to_tensor(mask), **kw))
    # the quantized weights are cached until a parameter changes
    q1 = MODEL.serving_weights("int8")
    assert MODEL.serving_weights("int8") is q1
    with pytest.raises(ValueError, match="only 'int8'"):
        MODEL.serving_weights("int4")


def test_quantizer_bit_for_bit():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((24, 40)) * 0.7).astype(np.float32)
    w[:, 5] = 0.0                                # an all-zero channel
    w[7, :] = 0.0
    for axis in (0, 1):
        rq, rs = jgen.quantize_weight_int8(w, axis=axis)
        q, s = gen.quantize_weight_int8(torch.from_numpy(w), axis=axis)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    names = list(JAX_MODEL.state_dict().keys())
    ref = jgen.quantize_state_int8(
        names, [v._value for v in JAX_MODEL.state_dict().values()])
    port = MODEL.serving_weights("int8")
    ref_q = {n: v for n, v in zip(names, ref) if isinstance(v, tuple)}
    assert set(port) == set(ref_q)
    for n, (q, s, dtype) in port.items():
        rq, rs, _ = ref_q[n]
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq), err_msg=n)
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs), err_msg=n)
        np.testing.assert_array_equal(
            gen.dequantize_leaf((q, s, dtype)).numpy(),
            np.asarray(jgen.dequantize_leaf(ref_q[n])), err_msg=n)


def test_stream_callback_tokens_identical():
    cols = []
    kw = dict(max_new_tokens=7, eos_token_id=int(_ref(IDS, max_new_tokens=4)
                                                 [1, 3]), pad_token_id=999)
    out = MODEL.generate(IDS, stream_callback=cols.append, **kw)
    np.testing.assert_array_equal(out.numpy(), _port(IDS, **kw))
    np.testing.assert_array_equal(np.stack(cols, axis=1),
                                  out.numpy()[:, :len(cols)])
    assert all(c.dtype == np.int64 and c.shape == (3,) for c in cols)
    ref_cols = []
    JAX_MODEL.generate(paddle.to_tensor(IDS), stream_callback=ref_cols.append,
                       **kw)
    np.testing.assert_array_equal(np.stack(cols), np.stack(ref_cols))


def test_sampled_reproducible_per_seed():
    kw = dict(max_new_tokens=6, decode_strategy="sampling", temperature=1.3,
              top_k=40, top_p=0.95)
    a = _port(IDS, seed=7, **kw)
    np.testing.assert_array_equal(a, _port(IDS, seed=7, **kw))
    assert not np.array_equal(a, _port(IDS, seed=8, **kw))
    assert ((a >= 0) & (a < 256)).all()
    # temperature 0 is greedy
    np.testing.assert_array_equal(
        _port(IDS, max_new_tokens=5, decode_strategy="sampling",
              temperature=0.0), _ref(IDS, max_new_tokens=5))


def _chi2_two_sample(a, b):
    """Two-sample chi-square statistic over token counts -> (stat, df)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mask = (a + b) > 0
    a, b = a[mask], b[mask]
    k1, k2 = np.sqrt(b.sum() / a.sum()), np.sqrt(a.sum() / b.sum())
    return float(((k1 * a - k2 * b) ** 2 / (a + b)).sum()), int(mask.sum()) - 1


def test_sampled_distribution_matches_reference():
    """400 rows of one prompt, sampled at temperature 1.5 with top-k 24:
    the first and second tokens' counts of the port and of the reference
    agree (two-sample chi-square at p = 0.001)."""
    ids = np.repeat(IDS[:1], 400, axis=0)
    kw = dict(max_new_tokens=2, decode_strategy="sampling", temperature=1.5,
              top_k=24)
    port = _port(ids, seed=3, **kw)
    ref = _ref(ids, seed=3, **kw)
    for col in range(2):
        stat, df = _chi2_two_sample(np.bincount(port[:, col], minlength=256),
                                    np.bincount(ref[:, col], minlength=256))
        assert df > 2
        assert stat < chi2.ppf(0.999, df), (col, stat, df)


def test_forward_with_caches_matches_reference():
    """Concat-grow caches: a 4-token prefix, then 2 tokens, then 1, each
    call continuing the positions; logits and caches against the
    reference (atol 1e-4, float32)."""
    ids = IDS[:2]
    caches, ref_caches = MODEL.gen_cache(2), JAX_MODEL.gen_cache(2)
    assert tuple(caches[0][0].shape) == (2, 0, 4, 16)
    for lo, hi in ((0, 4), (4, 6), (6, 7)):
        chunk = ids[:, lo:hi]
        logits, caches = MODEL(torch.from_numpy(chunk), caches=caches)
        ref_logits, ref_caches = JAX_MODEL(paddle.to_tensor(chunk),
                                           caches=ref_caches)
        np.testing.assert_allclose(logits.numpy(),
                                   np.asarray(ref_logits._value), atol=1e-4)
        for (k, v), (rk, rv) in zip(caches, ref_caches):
            np.testing.assert_allclose(k.numpy(), np.asarray(rk._value),
                                       atol=1e-5)
            np.testing.assert_allclose(v.numpy(), np.asarray(rv._value),
                                       atol=1e-5)
    # the whole sequence in one call gives the same last logits
    full = MODEL(torch.from_numpy(ids))
    np.testing.assert_allclose(logits[:, -1].numpy(), full[:, -1].numpy(),
                               atol=1e-4)


def test_pad_to_bucket_matches_reference():
    ids, mask = _left_padded()
    for kw in (dict(), dict(attention_mask=mask)):
        got = gen.pad_to_bucket(ids, (4, 10, 16), pad_token_id=3, **kw)
        ref = jgen.pad_to_bucket(
            paddle.to_tensor(ids), (4, 10, 16), pad_token_id=3,
            **{k: paddle.to_tensor(v) for k, v in kw.items()})
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r._value))
    same = gen.pad_to_bucket(ids, (7,))
    np.testing.assert_array_equal(same[0].numpy(), ids)
    with pytest.raises(ValueError, match="exceeds every bucket"):
        gen.pad_to_bucket(ids, (4,))


def test_unmasked_prefill_takes_the_flash_branch():
    """A pad-free prompt the qkv gate takes (S % 128 == 0) attends through
    `flash_attention_qkv` (its plain version here: no launch), and agrees
    with the masked branch given an all-ones mask; K/V written alike."""
    cfg = GPTConfig(256, 64, 2, 4, 128, 256, use_flash_attention=True)
    m = GPTForPretraining(cfg, device="cpu", seed=2)
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 128)))
    before = kernels.kernel_launch_counts()
    c_flash, c_mask = m.gen_static_cache(2, 130), m.gen_static_cache(2, 130)
    with torch.inference_mode():
        h_flash = m.gpt.prefill(ids, c_flash)
        h_mask = m.gpt.prefill(ids, c_mask, pad_mask=torch.ones_like(ids))
    torch.testing.assert_close(h_flash, h_mask, atol=1e-5, rtol=1e-5)
    for a, b in zip(c_flash, c_mask):
        torch.testing.assert_close(a[0], b[0], atol=0, rtol=0)
    assert kernels.kernel_launch_counts() == before


def test_generate_argument_checks():
    with pytest.raises(NotImplementedError, match="A12"):
        MODEL.generate(IDS, mesh=object())
    with pytest.raises(NotImplementedError, match="A12"):
        MODEL.generate(IDS, sharding_rule=object())
    with pytest.raises(NotImplementedError, match="A14"):
        MODEL.export_generate("/nonexistent", 1, 4)
    with pytest.raises(NotImplementedError, match="A14"):
        gen.load_generate("/nonexistent")
    with pytest.raises(NotImplementedError, match="A14"):
        MODEL.quantize_for_serving()
    assert MODEL.quantize_for_serving(release=False) is MODEL
    with pytest.raises(ValueError, match="stream_callback"):
        MODEL.generate(IDS, decode_strategy="beam_search", num_beams=2,
                       stream_callback=print)
    with pytest.raises(ValueError, match="LEFT-padded"):
        MODEL.generate(IDS, attention_mask=np.ones_like(IDS)[:, ::-1]
                       * (np.arange(7) < 5))
    with pytest.raises(ValueError, match="all-pad"):
        MODEL.generate(IDS, attention_mask=np.zeros_like(IDS))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        MODEL.generate(IDS, max_new_tokens=60)
    with pytest.raises(NotImplementedError, match="decode_strategy"):
        MODEL.generate(IDS, decode_strategy="contrastive")
    with pytest.raises(ValueError, match="max_new_tokens"):
        MODEL.generate(IDS, max_new_tokens=0)


def test_generate_restores_training_mode_and_weights():
    MODEL.train()
    try:
        before = {n: p.clone() for n, p in MODEL.named_parameters()}
        MODEL.generate(IDS, max_new_tokens=2, weight_quant="int8")
        assert MODEL.training
        for n, p in MODEL.named_parameters():
            assert isinstance(p, torch.nn.Parameter), n
            torch.testing.assert_close(p, before[n], atol=0, rtol=0)
    finally:
        MODEL.eval()


def test_engine_weight_quant_int8_matches_reference_engine():
    rows = [RNG.integers(1, 255, (n,)).astype("int64") for n in (6, 3, 5)]
    outs = []
    for eng in (JaxEngine(JAX_MODEL, kv_mode="paged", weight_quant="int8",
                          slots=2, max_len=16, prefill_buckets=(8,),
                          page_size=4),
                Engine(MODEL, weight_quant="int8", slots=2, max_len=16,
                       prefill_buckets=(8,), page_size=4, device="cpu")):
        handles = [eng.submit(r, max_new_tokens=6) for r in rows]
        outs.append([h.result() for h in handles])
    assert outs[1] == outs[0]
    # and the same tokens as one-shot generate on the int8 weights
    one = MODEL.generate(rows[0][None], max_new_tokens=6,
                         weight_quant="int8").numpy()[0].tolist()
    assert outs[1][0] == one
