"""The port's radix prefix cache (``Engine(prefix_cache=True)``) against
paddle_tpu's, case by case after ``tests/test_prefix_cache.py``.

Both engines serve ``gpt-test`` in float32 on the same numpy-seeded
weights through the same traffic at page size 4, and must emit identical
greedy tokens (identical too to the port's engine without the cache),
match the same page-granular spans (``prefix_tokens_saved``), cache the
same pages with K/V equal within float32 tolerance, and leave the pool
whole: after the traffic only the tree holds pages, one reference each,
and once it lets them go no page and no reference is left. The armed
recompile sentinel holds one decode step across hits, misses and
evictions. The tail prefill over the page view is held against the
reference's model method on a random pool.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch.observability import get_registry, get_sentinel
from paddle_tpu_torch.serving import Engine

import _torch_serving as ts

JAX_MODEL, MODEL = ts.both_models(seed=23)
PS = 4
MAX_NEW = 4


def _kw(slots=2, max_len=24, buckets=(4, 8, 16), **kw):
    kw.setdefault("page_size", PS)
    return dict(slots=slots, max_len=max_len, prefill_buckets=buckets,
                prefix_cache=True, **kw)


def _both(**kw):
    """(reference engine, port engine) with the prefix cache."""
    return (JaxEngine(JAX_MODEL, **_kw(**kw)),
            Engine(MODEL, device="cpu", **_kw(**kw)))


def _sys_rows(seed, n=4, sys_len=9):
    """``n`` prompts behind one system prompt of ``sys_len`` tokens (not
    page aligned: the cached run is ``sys_len // PS`` pages)."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, 255, (sys_len,)).astype("int64")
    return [np.concatenate([sys_p, rng.integers(1, 255, (k,)).astype("int64")])
            for k in rng.integers(2, 7, n)]


def _plain(rows, mn=MAX_NEW, **kw):
    """The port's engine without the cache on ``rows``, one at a time."""
    eng = Engine(MODEL, device="cpu", **{**_kw(**kw), "prefix_cache": False})
    return [eng.submit(r, max_new_tokens=mn).result() for r in rows]


def _tree_pages(eng):
    """``{token path: page}`` of every node of the engine's tree."""
    out, stack = {}, [((), eng.prefix.root)]
    while stack:
        path, node = stack.pop()
        for key, child in node.children.items():
            out[path + (key,)] = int(child.page)
            stack.append((path + (key,), child))
    return out


def _same_cache(ref, eng):
    """The two trees hold the same token runs, and the K/V of each run's
    page agree within float32 tolerance in every layer."""
    rp, pp = _tree_pages(ref), _tree_pages(eng)
    assert set(rp) == set(pp)
    for (jk, jv), (pk, pv) in zip(ref.kv.caches, eng.kv.caches):
        jk, jv = np.asarray(jk), np.asarray(jv)
        for path in rp:
            np.testing.assert_allclose(pk[pp[path]].numpy(), jk[rp[path]],
                                       atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(pv[pp[path]].numpy(), jv[rp[path]],
                                       atol=1e-4, rtol=1e-4)


def _prefix_stats(s):
    return (s.prefix_hits, s.prefix_tokens_saved, s.prefix_cached_pages,
            s.kv_pages_in_use)


def test_outputs_identical_across_arrival_orders():
    """For three arrival orders, the port's outputs equal the reference's
    and the port's own without the cache, with one decode step under the
    armed sentinel."""
    rows = _sys_rows(3)
    ref = JaxEngine(JAX_MODEL, **_kw())
    want = [ref.submit(r, max_new_tokens=MAX_NEW).result() for r in rows]
    assert want == _plain(rows)
    for order in ([0, 1, 2, 3], [3, 2, 1, 0], [2, 0, 3, 1]):
        eng = Engine(MODEL, device="cpu", **_kw())
        with get_sentinel().armed():
            handles = [(i, eng.submit(rows[i], max_new_tokens=MAX_NEW))
                       for i in order]
            for i, h in handles:
                assert h.result() == want[i], (order, i)
        s = eng.stats()
        assert s.decode_traces == 1 and s.prefix_hits >= 1
        ts.assert_pool_whole(eng)


def test_partial_match_non_page_aligned_boundary():
    rng = np.random.default_rng(5)
    common = rng.integers(1, 255, (10,)).astype("int64")
    a = np.concatenate([common, rng.integers(1, 255, (3,)).astype("int64")])
    b = np.concatenate([common, rng.integers(1, 255, (5,)).astype("int64")])
    outs, stats = [], []
    for eng in _both():
        outs.append([eng.submit(r, max_new_tokens=MAX_NEW).result()
                     for r in (a, b)])
        stats.append(eng.stats())
    assert outs[1] == outs[0] == _plain([a, b])
    # page granular: 2 full pages = 8 tokens, never 10
    assert stats[1].prefix_hits == stats[0].prefix_hits == 1
    assert stats[1].prefix_tokens_saved == stats[0].prefix_tokens_saved == 8


def test_full_prompt_cached_still_prefills_one_token():
    row = ts.rows(7, (8,))[0]                    # two whole pages
    outs, stats = [], []
    for eng in _both():
        outs.append([eng.submit(row, max_new_tokens=MAX_NEW).result()
                     for _ in range(2)])
        stats.append(eng.stats())
    assert outs[1] == outs[0] and outs[1][0] == outs[1][1]
    assert _prefix_stats(stats[1])[:2] == _prefix_stats(stats[0])[:2] == (1, 4)


def test_divergence_after_shared_prefix_cow_boundary():
    """Two live requests share two pages read-only and write their tails
    and decode columns to pages of their own."""
    rng = np.random.default_rng(9)
    common = rng.integers(1, 255, (8,)).astype("int64")
    a = np.concatenate([common, rng.integers(1, 255, (4,)).astype("int64")])
    b = np.concatenate([common, rng.integers(1, 255, (4,)).astype("int64")])
    outs = []
    for eng in _both():
        ha = eng.submit(a, max_new_tokens=6)
        eng.step()                     # a admitted: its prefix is cached
        hb = eng.submit(b, max_new_tokens=6)
        eng.step()
        if isinstance(eng, Engine):
            sa, sb = ha._req.slot, hb._req.slot
            shared = eng.kv.slot_row_pages(sa)[:2]
            assert eng.kv.slot_row_pages(sb)[:2] == shared
            assert all(eng.kv.readers(p) == 3 for p in shared)  # tree + 2
            assert not set(eng.kv.slot_row_pages(sa)[2:]) & set(
                eng.kv.slot_row_pages(sb)[2:])
        outs.append([ha.result(), hb.result()])
    assert outs[1] == outs[0] == _plain([a, b], mn=6)
    s = eng.stats()
    assert (s.prefix_hits, s.prefix_tokens_saved, s.decode_traces) == (1, 8, 1)
    ts.assert_pool_whole(eng)


def test_refcount_early_finishing_sharer_keeps_reader_alive():
    rng = np.random.default_rng(11)
    donor_p = rng.integers(1, 255, (12,)).astype("int64")
    sharer_p = np.concatenate([donor_p[:8],
                               rng.integers(1, 255, (2,)).astype("int64")])
    outs = []
    for eng in _both():
        donor = eng.submit(donor_p, max_new_tokens=8)
        eng.step()
        sharer = eng.submit(sharer_p, max_new_tokens=2)
        out_s = sharer.result()            # finishes well before the donor
        if isinstance(eng, Engine):
            assert not donor._req.done
        outs.append([out_s, donor.result()])
        s = eng.stats()
        assert s.prefix_hits == 1 and s.active_slots == 0
        assert s.kv_pages_in_use == s.prefix_cached_pages
    assert outs[1] == outs[0]
    assert outs[1][1] == _plain([donor_p], mn=8)[0]
    ts.assert_pool_whole(eng)


def test_eviction_under_exhaustion_then_readmission():
    """Under pool pressure the oldest unread cached pages go; an evicted
    prefix prefills again on readmission."""
    rng = np.random.default_rng(13)
    a = rng.integers(1, 255, (7,)).astype("int64")
    rows = [rng.integers(1, 255, (8,)).astype("int64") for _ in range(3)]
    outs, stats = [], []
    for eng in _both(max_len=12, buckets=(4, 8), kv_pages=7):
        out = [eng.submit(a, max_new_tokens=MAX_NEW).result()]
        assert eng.stats().prefix_cached_pages >= 1
        handles = [eng.submit(r, max_new_tokens=MAX_NEW) for r in rows]
        out += [h.result() for h in handles]
        s = eng.stats()
        assert s.prefix_evicted_pages >= 1
        hits = s.prefix_hits
        out.append(eng.submit(a, max_new_tokens=MAX_NEW).result())
        s = eng.stats()
        assert s.prefix_hits == hits           # a missed: its page was gone
        assert s.decode_traces == 1
        outs.append(out)
        stats.append(s)
    assert outs[1] == outs[0]
    assert stats[1].prefix_evicted_pages == stats[0].prefix_evicted_pages
    ts.assert_pool_whole(eng)


def test_exhaustion_requeues_and_unwinds_match_refs():
    """A request whose match survives but whose private rest does not fit
    goes back to the queue head with the match's references dropped, and
    admits once pages return."""
    rng = np.random.default_rng(15)
    a = rng.integers(1, 255, (8,)).astype("int64")
    b = rng.integers(1, 255, (8,)).astype("int64")
    c = np.concatenate([a[:4], rng.integers(1, 255, (4,)).astype("int64")])
    outs = []
    for eng in _both(slots=3, max_len=12, buckets=(4, 8), kv_pages=6):
        ha = eng.submit(a, max_new_tokens=MAX_NEW)
        hb = eng.submit(b, max_new_tokens=MAX_NEW)
        eng.step()                  # both admitted: 6 of 6 pages
        hc = eng.submit(c, max_new_tokens=MAX_NEW)
        eng.step()                  # c matches a's page, cannot reserve
        s = eng.stats()
        assert s.kv_pages_exhausted >= 1 and s.queue_depth == 1
        if isinstance(eng, Engine):
            # the match's reference was dropped again: tree + a's slot
            page = eng.kv.slot_row_pages(ha._req.slot)[0]
            assert eng.kv.readers(page) == 2
        outs.append([h.result() for h in (ha, hb, hc)])
        s = eng.stats()
        assert s.completed == 3 and s.kv_pages_in_use == s.prefix_cached_pages
    assert outs[1] == outs[0] == _plain([a, b, c], max_len=12,
                                         buckets=(4, 8))
    ts.assert_pool_whole(eng)


def test_cancel_around_admission_leaves_pool_clean():
    row = ts.rows(17, (6,))[0]
    outs = []
    for eng in _both(slots=1, max_len=12, buckets=(8,)):
        h1 = eng.submit(row, max_new_tokens=MAX_NEW)
        h1.cancel()                  # still queued: dropped, no pages
        while eng.step():
            pass
        assert eng.stats().prefix_cached_pages == 0
        h2 = eng.submit(row, max_new_tokens=MAX_NEW)
        eng.step()                   # admitted, one token out
        h2.cancel()
        while eng.step():
            pass
        s = eng.stats()
        assert s.cancelled == 2
        assert s.kv_pages_in_use == s.prefix_cached_pages == 1   # 6 // 4
        outs.append(eng.submit(row, max_new_tokens=MAX_NEW).result())
        assert eng.stats().prefix_hits == 1
    assert outs[1] == outs[0]
    ts.assert_pool_whole(eng)


def test_full_table_reservation_tail_scatter_past_window():
    """A hit whose reservation fills the whole block table while its tail
    bucket runs past the logical window: the pad columns beyond it go to
    the sentinel page, not onto the row's last page."""
    rng = np.random.default_rng(23)
    base = rng.integers(1, 255, (40,)).astype("int64")
    victim = np.concatenate([base, rng.integers(1, 255, (2,)).astype("int64")])
    outs = []
    for eng in _both(slots=1, max_len=48, buckets=(16, 44), page_size=8):
        outs.append([eng.submit(r, max_new_tokens=4).result()
                     for r in (base, victim)])
        assert eng.stats().prefix_hits == 1
    assert outs[1] == outs[0]
    assert outs[1] == _plain([base, victim], slots=1, max_len=48,
                             buckets=(16, 44), page_size=8)
    ts.assert_pool_whole(eng)


def test_prefix_cache_requires_paged_mode():
    for make in (JaxEngine, lambda m, **kw: Engine(m, device="cpu", **kw)):
        with pytest.raises(ValueError, match="paged"):
            make(JAX_MODEL if make is JaxEngine else MODEL, slots=1,
                 max_len=8, kv_mode="slots", prefix_cache=True)


def test_prefix_metrics_reach_the_registry():
    """The prefix families under the reference's names, labeled by
    engine; the hit rate over admissions."""
    rows = _sys_rows(19, n=3, sys_len=8)
    eng = Engine(MODEL, device="cpu", **_kw())
    for r in rows:
        eng.submit(r, max_new_tokens=MAX_NEW).result()
    s = eng.stats()
    assert s.prefix_lookups == 3 and s.prefix_hits == 2
    assert s.prefix_hit_rate == pytest.approx(2 / 3)
    assert s.prefix_tokens_saved == 16
    # the read-only peek matches the system prompt's two pages, no more
    probe = np.concatenate([rows[0][:8], [7, 7, 7, 7, 7]])
    stamps = [n.last_used for n in eng.prefix.root.children.values()]
    assert eng.prefix.match_len(probe) == 8
    assert [n.last_used for n in eng.prefix.root.children.values()] == stamps
    assert eng.prefix.cached_tokens() == PS * s.prefix_cached_pages
    eid = eng.metrics.engine_id
    reg = get_registry()
    assert reg.get("serving_prefix_hits_total").value(engine=eid) == 2
    assert reg.get("serving_prefix_tokens_saved_total").value(
        engine=eid) == 16


def test_pages_and_tokens_saved_equal_the_reference():
    """After the same traffic behind two system prompts, the two engines
    agree on every prefix counter and on the pool, and their trees hold
    the same token runs with K/V equal within float32 tolerance."""
    rows = _sys_rows(29, n=3, sys_len=9) + _sys_rows(31, n=3, sys_len=13)
    order = [0, 3, 1, 4, 2, 5]
    outs, stats, engines = [], [], _both(slots=3, max_len=32,
                                          buckets=(8, 16, 24))
    for eng in engines:
        handles = [eng.submit(rows[i], max_new_tokens=MAX_NEW)
                   for i in order[:3]]
        eng.step()
        handles += [eng.submit(rows[i], max_new_tokens=MAX_NEW)
                    for i in order[3:]]
        outs.append([h.result() for h in handles])
        stats.append(eng.stats())
    assert outs[1] == outs[0]
    ref, port = stats
    assert _prefix_stats(port) == _prefix_stats(ref)
    assert port.prefix_lookups == ref.prefix_lookups == 6
    _same_cache(*engines)
    ts.assert_pool_whole(engines[1])


def test_tail_prefill_matches_reference_model():
    """`GPTForPretraining.prefill_paged` against the reference's on the same
    random pool: two rows, one behind a cached prefix of 2 pages and one
    with none, right-padded tails; the last real token's logits within
    1e-4 of the largest, and the written tail columns equal."""
    rng = np.random.default_rng(37)
    cfg = MODEL.config
    pages, pmax, s = 12, 5, 8
    shape = (pages + 1, cfg.num_attention_heads, PS, cfg.head_dim)
    arrays = [(rng.standard_normal(shape).astype(np.float32),
               rng.standard_normal(shape).astype(np.float32))
              for _ in range(cfg.num_hidden_layers)]
    bt = np.full((2, pmax), pages, np.int32)
    bt[0, :5] = [3, 7, 1, 9, 0]
    bt[1, :3] = [2, 5, 11]
    col0 = np.asarray([8, 0], np.int32)
    tail = np.asarray([6, 5], np.int32)
    ids = np.zeros((2, s), np.int64)
    for r in range(2):
        ids[r, :tail[r]] = rng.integers(1, 255, (tail[r],))
    jp = [(paddle.to_tensor(k), paddle.to_tensor(v)) for k, v in arrays]
    ref, ref_pools = JAX_MODEL.prefill_paged(
        paddle.to_tensor(ids), jp, paddle.to_tensor(bt),
        paddle.to_tensor(col0), paddle.to_tensor(tail))
    ref = np.asarray(ref._value)
    pools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
             for k, v in arrays]
    with torch.inference_mode():
        port = MODEL.prefill_paged(
            torch.from_numpy(ids), pools, torch.from_numpy(bt),
            torch.from_numpy(col0), torch.from_numpy(tail)).numpy()
    assert port.shape == ref.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(port, ref, atol=1e-4 * np.abs(ref).max(),
                               rtol=0)
    for (jk, jv), (pk, pv) in zip(ref_pools, pools):
        # every page but the sentinel: the tails went to pages 1, 9, 2, 5
        for mine, theirs in ((pk, jk), (pv, jv)):
            np.testing.assert_allclose(mine[:pages].numpy(),
                                       np.asarray(theirs._value)[:pages],
                                       atol=1e-5, rtol=1e-5)
        assert not np.array_equal(pk[9].numpy(), arrays[0][0][9])
