"""The port's paged Engine against paddle_tpu's ``Engine(kv_mode="paged")``.

Both engines serve the same ``gpt-test`` weights through the same
sequence of submits, steps and cancels — the lifecycle cases of
``tests/test_serving_paged.py:101-190`` plus EOS — and must emit
identical greedy tokens and agree on the page accounting. Sampled
requests cannot match the reference's JAX PRNG streams; they must yield
valid ids, reproducibly from their seed.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch.models import GPTForPretraining, load_paddle_tpu_state_dict
from paddle_tpu_torch.serving import Engine

paddle.seed(97)
JAX_MODEL = JaxGPT(JaxGPTModel(jax_gpt_config("gpt-test")))
JAX_MODEL.eval()
MODEL = load_paddle_tpu_state_dict(
    GPTForPretraining("gpt-test", device="cpu"),
    {k: np.asarray(v._value) for k, v in JAX_MODEL.state_dict().items()})
MAX_NEW = 4


def _both(**kw):
    """(reference engine, port engine) with the same configuration."""
    return (JaxEngine(JAX_MODEL, kv_mode="paged", **kw),
            Engine(MODEL, device="cpu", **kw))


def _rows(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, (n,)).astype("int64") for n in lens]


def _page_accounting_ok(s):
    return (s.kv_pages_in_use + s.kv_pages_free == s.kv_pages_total
            and sum(s.kv_slot_pages) == s.kv_pages_in_use)


def test_greedy_parity_staggered():
    rows = _rows(29, (6, 4, 2, 8))
    outs, stats = [], []
    for eng in _both(slots=2, max_len=8 + MAX_NEW, prefill_buckets=(8,),
                     page_size=4):
        h0 = eng.submit(rows[0], max_new_tokens=MAX_NEW)
        eng.step()
        h1 = eng.submit(rows[1], max_new_tokens=MAX_NEW)
        h2 = eng.submit(rows[2], max_new_tokens=MAX_NEW)
        eng.step()
        assert _page_accounting_ok(eng.stats())
        h3 = eng.submit(rows[3], max_new_tokens=MAX_NEW)
        outs.append([h.result() for h in (h0, h1, h2, h3)])
        stats.append(eng.stats())
    assert outs[1] == outs[0]
    for s in stats:
        assert s.completed == 4 and s.active_slots == 0
        assert s.kv_pages_in_use == 0 and s.kv_pages_free == s.kv_pages_total
        assert s.kv_slot_pages == (0, 0)
    assert (stats[1].decode_steps, stats[1].prefill_steps) == (
        stats[0].decode_steps, stats[0].prefill_steps)
    # on the CPU the plain version serves the decode step: no launches
    assert stats[1].paged_attention_launches == 0


def test_more_slots_than_dense_sizing():
    """A 7-page pool serves 3 of 4 two-page requests at once; the 4th
    stays queued (the pool is exhausted) until a release."""
    rows = _rows(37, (3, 3, 3, 3))
    outs, active = [], []
    for eng in _both(slots=4, max_len=12, prefill_buckets=(4,), page_size=4,
                     kv_pages=7):
        handles = [eng.submit(r, max_new_tokens=MAX_NEW) for r in rows]
        eng.step()
        s = eng.stats()
        active.append(s.active_slots)
        assert s.kv_pages_exhausted >= 1 and s.queue_depth == 1
        assert s.kv_pages_in_use == 6 and _page_accounting_ok(s)
        outs.append([h.result() for h in handles])
    assert active == [3, 3]
    assert outs[1] == outs[0]


def test_eviction_mid_partial_page():
    rows = _rows(41, (4, 5, 3))
    outs, stats = [], []
    for eng in _both(slots=2, max_len=16, prefill_buckets=(8,),
                     page_size=4):
        h_long = eng.submit(rows[0], max_new_tokens=8)
        h_vic = eng.submit(rows[1], max_new_tokens=8)
        eng.step()
        eng.step()   # victim write head at column 10: page 2, offset 2
        assert eng.stats().kv_pages_in_use == 8   # 2 x ceil((8 + 7) / 4)
        h_vic.cancel()
        eng.step()
        h_nxt = eng.submit(rows[2], max_new_tokens=MAX_NEW)
        outs.append((h_nxt.result(), h_long.result(), h_vic.partial))
        stats.append(eng.stats())
    assert outs[1] == outs[0]
    for s in stats:
        assert s.cancelled == 1 and s.kv_pages_in_use == 0


def test_page_size_not_dividing_bucket():
    rows = _rows(43, (5, 6))
    outs = []
    for eng in _both(slots=2, max_len=12, prefill_buckets=(6,), page_size=4):
        handles = [eng.submit(r, max_new_tokens=MAX_NEW) for r in rows]
        outs.append([h.result() for h in handles])
    assert outs[1] == outs[0]


def test_eos_frees_the_slot_at_once():
    rows = _rows(47, (5, 7, 3))
    probe = Engine(MODEL, device="cpu", slots=3, max_len=16,
                   prefill_buckets=(8,), page_size=4)
    free_run = [probe.submit(r, max_new_tokens=6).result() for r in rows]
    eos = free_run[1][2]          # row 1 ends early on its third token
    outs, stats = [], []
    for eng in _both(slots=3, max_len=16, prefill_buckets=(8,),
                     page_size=4):
        handles = [eng.submit(r, max_new_tokens=6, eos_token_id=eos)
                   for r in rows]
        outs.append([h.result() for h in handles])
        stats.append(eng.stats())
    assert outs[1] == outs[0]
    assert outs[1][1][-1] == eos and len(outs[1][1]) <= 3
    assert stats[1].completed == 3 and stats[1].kv_pages_in_use == 0
    assert stats[1].tokens_generated == sum(map(len, outs[1]))


def _sampled(seed, with_neighbour):
    eng = Engine(MODEL, device="cpu", slots=2, max_len=16,
                 prefill_buckets=(8,), page_size=4, top_k=20)
    row = _rows(53, (6,))[0]
    if with_neighbour:
        eng.submit(_rows(59, (7,))[0], max_new_tokens=8)
    h = eng.submit(row, max_new_tokens=8, decode_strategy="sampling",
                   temperature=0.8, top_p=0.9, seed=seed)
    return h.result()


def test_sampled_request_is_valid_and_reproducible_from_its_seed():
    a = _sampled(7, with_neighbour=False)
    assert len(a) == 8 and all(0 <= t < 256 for t in a)
    assert _sampled(7, with_neighbour=True) == a
    assert _sampled(7, with_neighbour=False) == a


def test_sampling_filters_match_reference():
    from paddle_tpu.models.generation import _filter_top_k, _filter_top_p
    from paddle_tpu_torch.models.generation import filter_top_k, filter_top_p

    rng = np.random.default_rng(61)
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    t = torch.from_numpy(logits)
    np.testing.assert_array_equal(filter_top_k(t, 7).numpy(),
                                  np.asarray(_filter_top_k(logits, 7)))
    p = np.array([[0.3], [0.9], [1.0]], np.float32)
    np.testing.assert_array_equal(
        filter_top_p(t, torch.from_numpy(p)).numpy(),
        np.asarray(_filter_top_p(logits, p)))


def test_requests_the_pool_can_never_hold_are_refused_at_submit():
    eng = Engine(MODEL, device="cpu", slots=2, max_len=16,
                 prefill_buckets=(8,), page_size=4, kv_pages=2)
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(np.arange(1, 6), max_new_tokens=8)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(1, 6), max_new_tokens=9)
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(np.arange(1, 10), max_new_tokens=2)
