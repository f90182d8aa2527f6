"""The port's dense slot Engine (``kv_mode="slots"``, the default without
a paged feature) against paddle_tpu's ``Engine(kv_mode="slots")``.

Both engines serve ``gpt-test`` in float32 on the same numpy-seeded
weights through the same submits, steps and cancels (the cases of
``tests/test_serving.py:55-194``) and must emit identical greedy tokens.
The mode resolves as the reference's does, with its validation errors;
the port's slot step runs one captured decode step across churn and
one prefill step a bucket, and reports the slot caches' bytes. The slot
decode and verify windows are held against the reference's model
methods on random caches, in float32.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch.serving import Engine, SlotKVCache

import _torch_serving as ts

JAX_MODEL, MODEL = ts.both_models(seed=17)
MAX_NEW = 4


def _both(**kw):
    """(reference engine, port engine), both in slot mode."""
    return (JaxEngine(JAX_MODEL, kv_mode="slots", **kw),
            Engine(MODEL, device="cpu", **kw))


def _stats_tokens(s):
    return getattr(s, "tokens_emitted", None) or s.tokens_generated


def test_greedy_parity_staggered_arrivals():
    rows = ts.rows(41, (6, 4, 2, 8))
    outs, stats = [], []
    for eng in _both(slots=2, max_len=8 + MAX_NEW, prefill_buckets=(8,)):
        h0 = eng.submit(rows[0], max_new_tokens=MAX_NEW)
        eng.step()
        eng.step()
        h1 = eng.submit(rows[1], max_new_tokens=MAX_NEW)
        h2 = eng.submit(rows[2], max_new_tokens=MAX_NEW)   # slots full
        eng.step()
        h3 = eng.submit(rows[3], max_new_tokens=MAX_NEW)
        outs.append([h.result() for h in (h0, h1, h2, h3)])
        stats.append(eng.stats())
    assert outs[1] == outs[0]
    assert len({tuple(o) for o in outs[1]}) == 4
    ref, port = stats
    assert port.kv_mode == "slots"
    assert port.decode_traces == ref.decode_traces == 1
    assert port.prefill_traces == ref.prefill_traces == 1
    assert port.completed == 4 and port.active_slots == 0
    assert port.queue_depth == 0 and port.free_slots == 2
    assert port.tokens_generated == _stats_tokens(ref) == 4 * MAX_NEW
    assert port.paged_attention_launches == 0


@pytest.mark.parametrize("kw,mode", [
    ({}, "slots"), (dict(kv_mode="paged"), "paged"),
    (dict(prefix_cache=True), "paged"), (dict(chunk_tokens=8), "paged"),
    (dict(kv_quant="int8"), "paged"), (dict(kv_pool_bytes=1 << 20), "paged")],
    ids=["none", "kv_mode", "prefix_cache", "chunk_tokens", "kv_quant",
         "kv_pool_bytes"])
def test_default_kv_mode_resolution(kw, mode):
    """None picks slots without a paged feature and paged with one. The
    reference agrees, except that it refuses ``kv_quant`` and
    ``kv_pool_bytes`` without ``kv_mode="paged"`` (the port picks paged
    there, as it did when it had no other mode)."""
    eng = Engine(MODEL, device="cpu", slots=2, max_len=16, **kw)
    assert eng.kv_mode == mode
    assert isinstance(eng.kv, SlotKVCache) == (mode == "slots")
    assert len(eng.submit([1, 2, 3], max_new_tokens=2).result()) == 2
    if "kv_quant" in kw or "kv_pool_bytes" in kw:
        with pytest.raises(ValueError, match="kv_mode='paged'"):
            JaxEngine(JAX_MODEL, slots=2, max_len=16, **kw)
    else:
        assert JaxEngine(JAX_MODEL, slots=2, max_len=16,
                         **kw).kv_mode == mode


def test_slot_recycling_after_eos():
    row_a, row_b = ts.rows(43, (4, 5))
    probe = Engine(MODEL, device="cpu", slots=1, max_len=8 + MAX_NEW,
                   prefill_buckets=(8,))
    eos = probe.submit(row_a, max_new_tokens=MAX_NEW).result()[0]
    outs = []
    for eng in _both(slots=1, max_len=8 + MAX_NEW, prefill_buckets=(8,)):
        ha = eng.submit(row_a, max_new_tokens=MAX_NEW, eos_token_id=eos)
        hb = eng.submit(row_b, max_new_tokens=MAX_NEW)   # waits for the slot
        assert eng.stats().queue_depth == 2
        eng.step()
        outs.append((ha.result(), hb.result()))
    assert outs[1] == outs[0]
    assert outs[1][0] == [eos] and len(outs[1][1]) == MAX_NEW
    s = eng.stats()
    assert s.completed == 2 and s.decode_traces == 1
    assert s.free_slots == 1 and not eng.kv.active.any()


def test_variable_length_buckets():
    rows = ts.rows(45, (2, 4, 7, 3))
    outs, stats = [], []
    for eng in _both(slots=4, max_len=8 + MAX_NEW, prefill_buckets=(4, 8)):
        handles = [eng.submit(r, max_new_tokens=MAX_NEW) for r in rows]
        outs.append([h.result() for h in handles])
        stats.append(eng.stats())
    assert outs[1] == outs[0]
    ref, port = stats
    assert port.decode_traces == 1
    assert port.prefill_traces == ref.prefill_traces == 2
    # slots x layers x 2 x heads x max_len x head_dim x 4 bytes
    assert port.kv_cache_bytes == ref.kv_cache_bytes == 4 * 2 * 2 * 4 * 12 \
        * 16 * 4


def test_one_decode_build_across_churn():
    """Six requests of other lengths and budgets through two slots, each
    submitted a step apart: one decode step, one prefill step a
    bucket."""
    rng = np.random.default_rng(47)
    outs = []
    for eng in _both(slots=2, max_len=12, prefill_buckets=(4, 8)):
        handles = []
        for i in range(6):
            row = rng.integers(1, 255, (2 + i % 5,)).astype("int64")
            handles.append(eng.submit(row, max_new_tokens=1 + i % 3))
            eng.step()
        outs.append([h.result() for h in handles])
        rng = np.random.default_rng(47)
    assert outs[1] == outs[0]
    s = eng.stats()
    assert (s.decode_traces, s.prefill_traces, s.completed) == (1, 2, 6)


def test_spec_k_in_slot_mode_is_greedy_identical():
    """A verify window of k + 1 = 4 lanes over the slot caches: the same
    greedy tokens as ``spec_k=0`` and as the reference's slot engine at
    ``spec_k=3``, on prompts the n-gram drafter finds matches in."""
    motif = np.asarray([7, 19, 3, 88], np.int64)
    rows = [np.tile(motif, 2), np.concatenate([motif, [5, 6]]),
            *ts.rows(49, (3, 6))]
    kw = dict(slots=2, max_len=8 + 10 + 3, prefill_buckets=(8,))
    outs = []
    for eng in (JaxEngine(JAX_MODEL, kv_mode="slots", spec_k=3, **kw),
                Engine(MODEL, device="cpu", spec_k=3, **kw),
                Engine(MODEL, device="cpu", **kw)):
        handles = [eng.submit(r, max_new_tokens=10) for r in rows]
        outs.append([h.result() for h in handles])
    assert outs[1] == outs[0] == outs[2]
    s = eng.stats()
    assert s.kv_mode == "slots" and s.decode_traces == 1


def test_spec_k_slot_engine_drafts_and_accepts():
    motif = np.asarray([7, 19, 3, 88], np.int64)
    eng = Engine(MODEL, device="cpu", slots=2, max_len=21,
                 prefill_buckets=(8,), spec_k=3)
    eng.submit(np.tile(motif, 2), max_new_tokens=10).result()
    s = eng.stats()
    assert s.spec_k == 3 and s.spec_draft_tokens > 0
    assert s.decode_steps <= 10 and s.decode_traces == 1


def test_weight_quant_int8_parity():
    rows = ts.rows(53, (6, 3, 5))
    outs = []
    for eng in _both(slots=2, max_len=16, prefill_buckets=(8,),
                     weight_quant="int8"):
        outs.append([eng.submit(r, max_new_tokens=6).result()
                     for r in rows])
    assert outs[1] == outs[0]


@pytest.mark.parametrize("kw,match", [
    (dict(kv_mode="dense"), "kv_mode must be"),
    (dict(kv_mode="slots", prefix_cache=True), "kv_mode='paged'"),
    (dict(kv_mode="slots", kv_quant="int8"), "kv_mode='paged'"),
    (dict(kv_mode="slots", kv_pool_bytes=1 << 20), "kv_mode='paged'"),
    (dict(kv_mode="slots", chunk_tokens=8), "kv_mode='paged'"),
    (dict(chunk_tokens=0), "chunk_tokens must be > 0"),
    (dict(chunk_tokens=8, spec_k=2), "spec_k"),
    (dict(kv_mode="paged", kv_pool_bytes=1 << 20, kv_pages=8), "not both")],
    ids=["mode", "prefix", "kv_quant", "pool_bytes", "chunk", "chunk0",
         "chunk_spec", "both_sizes"])
def test_validation_errors_match_reference(kw, match):
    for make in (lambda: JaxEngine(JAX_MODEL, slots=2, max_len=16, **kw),
                 lambda: Engine(MODEL, device="cpu", slots=2, max_len=16,
                                **kw)):
        with pytest.raises(ValueError, match=match):
            make()


def test_kv_cache_bytes_is_the_slot_cache():
    ref, eng = _both(slots=3, max_len=20, prefill_buckets=(8,))
    s = eng.stats()
    assert s.kv_cache_bytes == eng.kv.memory_bytes() \
        == ref.stats().kv_cache_bytes == 3 * 2 * 2 * 4 * 20 * 16 * 4
    assert eng.kv.caches[0][0].shape == (3, 4, 20, 16)
    # no page fields in slot mode
    assert (s.kv_page_size, s.kv_pages_total, s.kv_pages_in_use,
            s.kv_pool_bytes, s.kv_slot_pages) == (None,) * 5


def test_cancel_frees_the_slot():
    rows = ts.rows(51, (3, 3, 3))
    outs = []
    for eng in _both(slots=1, max_len=12, prefill_buckets=(4,)):
        h0 = eng.submit(rows[0], max_new_tokens=8)
        h1 = eng.submit(rows[1], max_new_tokens=MAX_NEW)
        h2 = eng.submit(rows[2], max_new_tokens=MAX_NEW)
        eng.step()
        eng.step()
        h0.cancel()
        h1.cancel()                  # still queued: never admitted
        outs.append(h2.result())
        s = eng.stats()
        assert s.cancelled == 2 and s.active_slots == 0
    assert outs[1] == outs[0]
    assert not eng.kv.active.any() and (eng.kv.valid_cols == 0).all()


def test_sampled_request_reproduces_from_its_seed():
    row, other = ts.rows(55, (6, 7))

    def sampled(neighbour):
        eng = Engine(MODEL, device="cpu", slots=2, max_len=16,
                     prefill_buckets=(8,), top_k=20)
        if neighbour:
            eng.submit(other, max_new_tokens=8)
        return eng.submit(row, max_new_tokens=8, decode_strategy="sampling",
                          temperature=0.8, top_p=0.9, seed=7).result()

    a = sampled(False)
    assert len(a) == 8 and all(0 <= t < 256 for t in a)
    assert sampled(True) == a


def _random_caches(rng, b, length):
    """The same random slot caches as paddle_tpu tensors and as the port's
    ``[B, H, L, D]`` float32 tensors."""
    cfg = MODEL.config
    shape = (b, cfg.num_attention_heads, length, cfg.head_dim)
    arrays = [(rng.standard_normal(shape).astype(np.float32),
               rng.standard_normal(shape).astype(np.float32))
              for _ in range(cfg.num_hidden_layers)]
    return ([(paddle.to_tensor(k), paddle.to_tensor(v)) for k, v in arrays],
            [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
             for k, v in arrays])


@pytest.mark.parametrize("w", [1, 3])
def test_slot_window_matches_reference_model(w):
    """`GPTForPretraining.verify_slots` (W = 1 is `decode_slots`) against
    the reference's on the same random caches: three rows at their own
    cursors, one with left padding; logits within 1e-4 of the largest
    and the written cache columns equal."""
    rng = np.random.default_rng(57 + w)
    b, length = 3, 16
    jc, pc = _random_caches(rng, b, length)
    tokens = rng.integers(1, 255, (b, w)).astype(np.int32)
    steps = np.asarray([5, 9, 12], np.int32)
    pads = np.asarray([0, 2, 0], np.int32)
    valid = np.ones((b, length), np.int32)
    valid[1, :2] = 0
    fn = JAX_MODEL.verify_slots if w > 1 else JAX_MODEL.decode_slots
    jt = paddle.to_tensor(tokens if w > 1 else tokens[:, 0][:, None])
    ref, ref_caches = fn(jt, paddle.to_tensor(steps), jc,
                         pads=paddle.to_tensor(pads),
                         valid_cols=paddle.to_tensor(valid))
    ref = np.asarray(ref._value)
    port_fn = MODEL.verify_slots if w > 1 else MODEL.decode_slots
    with torch.inference_mode():
        port = port_fn(
            torch.from_numpy(tokens.astype(np.int64)),
            torch.from_numpy(steps), pc, pads=torch.from_numpy(pads),
            valid_cols=torch.from_numpy(valid)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(port, ref, atol=1e-4 * scale, rtol=0)
    for (jk, _), (pk, _) in zip(ref_caches, pc):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk._value),
                                   atol=1e-5, rtol=1e-5)
