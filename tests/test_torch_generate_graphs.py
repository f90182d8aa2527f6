"""`generate()` on captured decode steps, against paddle_tpu's.

``gpt-test`` weights are drawn from a numpy seed and carried into the
port by `load_paddle_tpu_state_dict`. The decode step now takes its
cursor as a device tensor and attends the whole static cache under
``arange(max_len) <= step``, the reference's own form: held against
paddle_tpu's `decode_step` at several steps, with and without
``valid_cols``, on numpy-seeded caches (float32, atol 1e-4, summation
order only). Greedy generation and both beams (their tails in
paddle_tpu's Pallas interpret mode, as ``tests/test_torch_beam.py``
runs them) must be token-identical to the reference, also on
weight-only int8 weights; a second call at one shape replays the loop
built by the first (one build of its decode step, the same cache
entry), and the cache keeps the 32 most recently used loops, within its
byte budget. int8 weights are dequantized once a loop, not a step, and
an armed sentinel trips on a rebuilt decode step.
"""
import importlib
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu_torch.models import GPTForPretraining, load_paddle_tpu_state_dict
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.observability import RecompileError, get_sentinel

jpa = importlib.import_module("paddle_tpu.kernels.paged_attention")

ATOL = 1e-4
WEIGHT_STD = 0.3


def _seeded_arrays(model, seed):
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


JAX_MODEL = JaxGPT(JaxGPTModel(jax_gpt_config("gpt-test")))
JAX_MODEL.eval()
_ARRAYS = _seeded_arrays(JAX_MODEL, 23)
JAX_MODEL.set_state_dict(_ARRAYS)
MODEL = load_paddle_tpu_state_dict(GPTForPretraining("gpt-test",
                                                     device="cpu"), _ARRAYS)
RNG = np.random.default_rng(41)
IDS = RNG.integers(1, 255, (2, 6)).astype("int64")
MASK = np.ones_like(IDS)
MASK[1, :3] = 0
IDS_PADDED = np.where(MASK == 1, IDS, 0)


@pytest.fixture
def interpret_kernel():
    """paddle_tpu's fused paged kernel on the CPU (Pallas interpret
    mode), restored after the test."""
    jpa._INTERPRET = True
    try:
        yield
    finally:
        jpa._INTERPRET = False


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


@pytest.mark.parametrize("cursor", ["int", "tensor"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("step", [0, 5, 11])
def test_decode_step_with_a_device_cursor_matches_reference(step, masked,
                                                            cursor):
    """One decode step at cache column ``step`` of 12, over caches
    holding numpy-seeded K/V: logits and the written caches."""
    cfg = MODEL.config
    b, max_len = 2, 12
    rng = np.random.default_rng(100 + step)
    shape = (b, cfg.num_attention_heads, max_len, cfg.head_dim)
    caches = [(rng.standard_normal(shape).astype(np.float32),
               rng.standard_normal(shape).astype(np.float32))
              for _ in range(cfg.num_hidden_layers)]
    tok = rng.integers(1, 255, (b, 1)).astype(np.int64)
    kw, jkw = {}, {}
    if masked:
        pads = np.array([0, 2], np.int64)
        vc = np.ones((b, max_len), np.int64)
        vc[1, :2] = 0
        kw = dict(pads=torch.from_numpy(pads), valid_cols=torch.from_numpy(vc))
        jkw = dict(pads=paddle.to_tensor(pads), valid_cols=paddle.to_tensor(vc))
    j_logits, j_caches = JAX_MODEL.decode_step(
        paddle.to_tensor(tok), paddle.to_tensor(np.int32(step)),
        [(paddle.to_tensor(k), paddle.to_tensor(v)) for k, v in caches],
        **jkw)
    t_caches = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
                for k, v in caches]
    cur = step if cursor == "int" else torch.tensor([step], dtype=torch.int32)
    with torch.inference_mode():
        logits, _ = MODEL.decode_step(torch.from_numpy(tok), cur, t_caches,
                                      **kw)
    np.testing.assert_allclose(logits.numpy(), _np(j_logits), atol=ATOL,
                               rtol=0)
    for (k, v), (jk, jv) in zip(t_caches, j_caches):
        np.testing.assert_allclose(k.numpy(), _np(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(v.numpy(), _np(jv), atol=ATOL, rtol=0)


def test_decode_step_past_the_cache_raises_from_the_host():
    caches = MODEL.gen_static_cache(1, 4)
    with pytest.raises(ValueError, match="out of range"):
        MODEL.decode_step(torch.ones((1, 1), dtype=torch.long), 4, caches)


CASES = {
    "greedy": dict(),
    "greedy masked": dict(masked=True),
    "greedy int8 weights": dict(weight_quant="int8", masked=True),
    "beam paged": dict(decode_strategy="beam_search", num_beams=2,
                       masked=True),
    "beam gather": dict(decode_strategy="beam_search", num_beams=2,
                        beam_kv="gather", masked=True),
    "beam paged int8 weights": dict(decode_strategy="beam_search",
                                    num_beams=2, weight_quant="int8"),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_generate_matches_reference_and_replays_its_loop(case,
                                                         interpret_kernel):
    kw = dict(CASES[case])
    masked = kw.pop("masked", False)
    ids = IDS_PADDED if masked else IDS
    if masked:
        kw["attention_mask"] = MASK
    kw.update(max_new_tokens=5, eos_token_id=None)
    jkw = {k: paddle.to_tensor(v) if k == "attention_mask" else v
           for k, v in kw.items()}
    ref = np.asarray(JAX_MODEL.generate(paddle.to_tensor(ids),
                                        **jkw)._value)
    first = MODEL.generate(ids, **kw).numpy()
    np.testing.assert_array_equal(first, ref)
    loops = MODEL._generate_graphs()[0]
    loop = next(reversed(loops.values()))
    n = len(loops)
    again = MODEL.generate(ids, **kw).numpy()
    np.testing.assert_array_equal(again, ref)
    assert len(loops) == n and next(reversed(loops.values())) is loop
    assert loop.decode.captures == 1
    assert get_sentinel().trace_count(loop.decode.name) == 1
    assert loop.decode.name.startswith("generate.")


def test_generate_keeps_the_32_most_recently_used_loops():
    model = GPTForPretraining("gpt-test", device="cpu", seed=3)
    ids = IDS[:1, :3]
    for new in range(1, gen.GENERATE_CACHE_SIZE + 2):
        model.generate(ids, max_new_tokens=new)
    loops = model._generate_graphs()[0]
    assert len(loops) == gen.GENERATE_CACHE_SIZE
    assert {key[2] for key in loops} == set(
        range(2, gen.GENERATE_CACHE_SIZE + 2))
    model.generate(ids, max_new_tokens=2)          # a hit moves to the end
    assert next(reversed(loops))[2] == 2
    model.clear_generate_cache()
    assert not loops


def test_a_replaced_weight_builds_a_new_loop():
    """The loop's graph reads the weights where they lie: a parameter
    replaced by new storage keys a new loop."""
    model = GPTForPretraining("gpt-test", device="cpu", seed=4)
    ids = IDS[:1, :4]
    a = model.generate(ids, max_new_tokens=3)
    w = model.gpt.ln_f.weight
    model.gpt.ln_f.weight = torch.nn.Parameter(w.detach() * 2,
                                               requires_grad=False)
    model.generate(ids, max_new_tokens=3)
    assert len(model._generate_graphs()[0]) == 2
    model.gpt.ln_f.weight = w
    np.testing.assert_array_equal(model.generate(ids, max_new_tokens=3), a)
    assert len(model._generate_graphs()[0]) == 2


LOOP_KINDS = {
    "greedy": dict(),
    "beam paged": dict(decode_strategy="beam_search", num_beams=2),
    "beam gather": dict(decode_strategy="beam_search", num_beams=2,
                        beam_kv="gather"),
}


@pytest.mark.parametrize("kind", list(LOOP_KINDS), ids=list(LOOP_KINDS))
def test_generate_holds_at_most_its_byte_budget(kind, monkeypatch):
    """Calls at many prompt lengths each build a loop; the built loops
    hold at most `GENERATE_CACHE_BYTES` together (the loop used last
    kept), and a loop's count covers its caches."""
    model = GPTForPretraining("gpt-test", device="cpu", seed=5)
    cfg = model.config
    kw = dict(LOOP_KINDS[kind], max_new_tokens=3)
    model.generate(IDS[:1, :2], **kw)
    one = model.generate_cache_bytes()
    caches = (cfg.num_hidden_layers * 2 * cfg.num_attention_heads
              * 2 * cfg.head_dim * 4)          # prompt K/V alone, float32
    assert one >= caches
    budget = 3 * one
    monkeypatch.setattr(gen, "GENERATE_CACHE_BYTES", budget)
    sizes = []
    for plen in range(2, 12):
        model.generate(RNG.integers(1, 255, (1, plen)), **kw)
        loops = model._generate_graphs()[0]
        last = next(reversed(loops.values()))
        sizes.append(len(loops))
        assert model.generate_cache_bytes() <= max(
            budget, sum(t.untyped_storage().nbytes() for t in last.held))
        assert f"x{plen}+" in last.decode.name     # the last loop is kept
    assert max(sizes) < 10 and min(sizes[3:]) >= 1
    model.clear_generate_cache()
    assert model.generate_cache_bytes() == 0


@pytest.mark.parametrize("why", ["cleared", "evicted"])
@pytest.mark.parametrize("kind", list(LOOP_KINDS), ids=list(LOOP_KINDS))
def test_an_armed_rebuild_of_a_generate_step_raises(kind, why,
                                                    monkeypatch):
    """A decode step built again at one shape (its loop dropped from the
    cache) is a recompile: under an armed sentinel it raises."""
    model = GPTForPretraining("gpt-test", device="cpu", seed=6)
    kw = dict(LOOP_KINDS[kind], max_new_tokens=3)
    ids = IDS[:1, :4]
    model.generate(ids, **kw)
    name = next(reversed(model._generate_graphs()[0].values())).decode.name
    if why == "cleared":
        model.clear_generate_cache()
    else:
        monkeypatch.setattr(gen, "GENERATE_CACHE_BYTES", 0)
        model.generate(ids[:, :3], **kw)       # keeps only this loop
    with get_sentinel().armed():
        with pytest.raises(RecompileError, match=re.escape(name)):
            model.generate(ids, **kw)
    monkeypatch.setattr(gen, "GENERATE_CACHE_BYTES", 8 << 30)
    model.generate(ids, **kw)                  # disarmed: builds, warns
    with get_sentinel().armed():
        model.generate(ids, **kw)              # a hit replays, no build


@pytest.mark.parametrize("kind", list(LOOP_KINDS), ids=list(LOOP_KINDS))
def test_int8_weights_are_dequantized_once_a_loop(kind, monkeypatch):
    """With ``weight_quant="int8"`` a loop dequantizes the weights once,
    when it is built, into tensors it owns; its steps and later calls
    dequantize nothing."""
    model = GPTForPretraining("gpt-test", device="cpu", seed=7)
    quant = model.serving_weights("int8")
    calls = []
    real = gen.dequantize_leaf
    monkeypatch.setattr(gen, "dequantize_leaf",
                        lambda v: calls.append(1) or real(v))
    kw = dict(LOOP_KINDS[kind], max_new_tokens=4, weight_quant="int8")
    a = model.generate(IDS[:1, :4], **kw)
    assert len(calls) == len(quant)
    b = model.generate(IDS[:1, :4], **kw)
    assert len(calls) == len(quant)
    np.testing.assert_array_equal(a, b)
