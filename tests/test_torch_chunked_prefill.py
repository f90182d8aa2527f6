"""The port's chunked prefill (``Engine(chunk_tokens=n)``) and
`Engine.embed` against paddle_tpu's, after ``tests/test_chunked_prefill.
py:67-383``.

Both engines serve ``gpt-test`` in float32 on the same numpy-seeded
weights: a long prompt admits in chunks, each in one mixed step with
every live slot's decode, and the greedy tokens equal the reference's
at two chunk sizes and the port's own whole-prompt admission; sampled
chunked streams equal the port's whole-prompt ones bit for bit (the
first token is the same draw of the request's generator). The mixed step
registers in the decode family without counting (``decode_traces ==
1`` under the armed sentinel), its decode half reads a block table whose
chunking row is the sentinel page, and the pages a chunked admission
writes equal a whole one's. FCFS holds behind a chunking request, and a
cancel mid-chunk returns its slot and pages. `embed` returns the
reference's vectors within float32 tolerance and leaves the pool empty.
"""
import time

import numpy as np
import pytest

from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch.observability import get_registry, get_sentinel
from paddle_tpu_torch.serving import DeadlineExceededError, Engine

import _torch_serving as ts

JAX_MODEL, MODEL = ts.both_models(seed=29)
PS = 4
MAX_NEW = 4
#: one long prompt (several chunks) and one short (a single chunk)
LONG, SHORT = ts.rows(23, (27, 4))


def _kw(**kw):
    kw.setdefault("page_size", PS)
    kw.setdefault("prefill_buckets", (8, 32))
    kw.setdefault("max_len", 40)
    kw.setdefault("slots", 2)
    kw.setdefault("kv_mode", "paged")
    return kw


def _engine(chunk_tokens=None, **kw):
    return Engine(MODEL, device="cpu", chunk_tokens=chunk_tokens, **_kw(**kw))


def _chunks(n, ct):
    """Mixed steps a prompt of ``n`` tokens takes at chunk ``ct`` (0: it
    admits whole)."""
    return -(-n // ct) if n > ct else 0


def _whole(rows, mn=MAX_NEW, **kw):
    """The port's whole-prompt admission of ``rows``, one at a time."""
    eng = _engine(**kw)
    return [eng.submit(r, max_new_tokens=mn).result() for r in rows]


def test_greedy_parity_across_chunk_sizes():
    want = _whole([LONG, SHORT])
    for ct in (5, 8):
        outs = []
        for eng in (JaxEngine(JAX_MODEL, chunk_tokens=ct, **_kw()),
                    _engine(chunk_tokens=ct)):
            with get_sentinel().armed():
                hl = eng.submit(LONG, max_new_tokens=MAX_NEW)
                hs = eng.submit(SHORT, max_new_tokens=MAX_NEW)
                outs.append([hl.result(), hs.result()])
            s = eng.stats()
            assert s.prefill_chunk_steps == (_chunks(len(LONG), ct)
                                             + _chunks(len(SHORT), ct))
            assert s.chunk_tokens == ct and s.decode_traces == 1
        assert outs[1] == outs[0] == want, ct
        ts.assert_pool_whole(eng)


def test_sampled_chunked_streams_equal_whole_admission_bit_for_bit():
    kw = dict(decode_strategy="sampling", temperature=0.8, seed=11,
              max_new_tokens=8)
    want = _engine().submit(LONG, **kw).result()
    for ct in (5, 8):
        eng = _engine(chunk_tokens=ct)
        assert eng.submit(LONG, **kw).result() == want
        assert eng.stats().prefill_chunk_steps == _chunks(len(LONG), ct)


def test_decode_piggybacks_every_chunk_step():
    """A live stream emits one token in every mixed step while the long
    prompt is mid-chunk, and its tokens are those of a run without the
    long prompt beside it."""
    eng = _engine(chunk_tokens=5)
    hs = eng.submit(SHORT, max_new_tokens=16)
    eng.step()                                  # SHORT admitted: token 1
    hl = eng.submit(LONG, max_new_tokens=MAX_NEW)
    during = []
    while not hl._req.emitted:
        before = len(hs._req.emitted)
        eng.step()
        during.append(len(hs._req.emitted) - before)
    assert during == [1] * _chunks(len(LONG), 5)
    assert hl.result() == _whole([LONG])[0]
    assert hs.result() == _whole([SHORT], mn=16)[0]
    s = eng.stats()
    assert s.prefill_chunk_steps == _chunks(len(LONG), 5)
    assert s.decode_traces == 1 and s.prefill_chunk_active == 0
    eid = eng.metrics.engine_id
    reg = get_registry()
    assert reg.get("serving_prefill_chunk_steps_total").value(
        engine=eid) == s.prefill_chunk_steps
    assert reg.get("serving_prefill_chunk_active").value(engine=eid) == 0
    ts.assert_pool_whole(eng)


def test_mixed_step_joins_the_decode_family_with_the_sentinel_row():
    """The mixed step is built once, named ``mix{ct}`` in the decode
    family and not counted; its decode half's block table points the
    chunking slot's row at the sentinel page."""
    eng = _engine(chunk_tokens=5)
    hs = eng.submit(SHORT, max_new_tokens=12)
    eng.step()
    hl = eng.submit(LONG, max_new_tokens=MAX_NEW)
    with get_sentinel().armed():
        eng.step()
        slot = hl._req.slot
        assert eng._chunk_req is hl._req
        view = eng._chunk_fn.static["block_table"]
        assert (view[slot] == eng.kv.pool.sentinel).all()
        assert (eng.kv.block_table[slot] != eng.kv.pool.sentinel).any()
        assert (view[hs._req.slot].numpy()
                == eng.kv.block_table[hs._req.slot]).all()
        hl.result()
        hs.result()
    eid = eng.metrics.engine_id
    assert eng._chunk_fn.name == f"serving.decode[{eid}][mix5]"
    assert get_sentinel().trace_count(eng._chunk_fn.name) == 1
    assert eng.stats().decode_traces == 1


def _written(eng, h, valid):
    """The K/V of the first ``valid`` logical columns of ``h``'s slot,
    every layer, once it has emitted two tokens."""
    while len(h._req.emitted) < 2:
        eng.step()
    pages = eng.kv.slot_row_pages(h._req.slot)
    out = []
    for k, v in eng.kv.caches:
        for t in (k, v):
            a = np.asarray(t)[pages]                 # [P, H, ps, D]
            out.append(a.transpose(1, 0, 2, 3).reshape(
                a.shape[1], -1, a.shape[3])[:, :valid])
    return out


def test_chunked_kv_pages_equal_whole_admission():
    """The pages a chunked admission writes hold a whole admission's K/V
    (both unpadded, through the prefix cache's layout) over the prompt
    and the first decode column, and the reference's chunked pages."""
    valid = len(LONG) + 1
    snaps, toks = [], []
    for chunked in (False, True):
        eng = _engine(chunk_tokens=5 if chunked else None,
                      prefix_cache=True, slots=1)
        h = eng.submit(LONG, max_new_tokens=MAX_NEW)
        snaps.append(_written(eng, h, valid))
        toks.append(h.result())
    ref = JaxEngine(JAX_MODEL, chunk_tokens=5, **_kw(prefix_cache=True,
                                                     slots=1))
    h = ref.submit(LONG, max_new_tokens=MAX_NEW)
    while len(h._req.emitted) < 2:
        ref.step()
    pages = ref.kv.slot_row_pages(h._req.slot)
    ref_snap = []
    for k, v in ref.kv.caches:
        for t in (k, v):
            a = np.asarray(t)[pages]
            ref_snap.append(a.transpose(1, 0, 2, 3).reshape(
                a.shape[1], -1, a.shape[3])[:, :valid])
    toks.append(h.result())
    assert toks[0] == toks[1] == toks[2]
    for whole, chunked, theirs in zip(*snaps, ref_snap):
        np.testing.assert_allclose(chunked, whole, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(chunked, theirs, atol=1e-4, rtol=1e-4)


def test_prefix_hit_prefills_only_the_tail():
    longer = np.concatenate([LONG, ts.rows(3, (6,))[0]])
    kw = dict(prefix_cache=True, slots=1, max_len=48,
              prefill_buckets=(8, 40))
    outs, stats = [], []
    for eng in (JaxEngine(JAX_MODEL, chunk_tokens=5, **_kw(**kw)),
                _engine(chunk_tokens=5, **kw)):
        outs.append([eng.submit(LONG, max_new_tokens=MAX_NEW).result()])
        first = eng.stats().prefill_chunk_steps
        assert first == -(-len(LONG) // 5)
        outs[-1].append(eng.submit(longer, max_new_tokens=MAX_NEW).result())
        s = eng.stats()
        assert s.prefix_hits == 1
        tail = len(longer) - s.prefix_tokens_saved
        assert s.prefill_chunk_steps - first == -(-tail // 5)
        stats.append(_chunk_stats(s))
    assert outs[1] == outs[0]
    assert stats[1] == stats[0]
    ts.assert_pool_whole(eng)


def _chunk_stats(s):
    return (s.prefill_chunk_steps, s.prefix_tokens_saved, s.prefix_hits)


def test_fcfs_held_while_chunking():
    eng = _engine(chunk_tokens=5, slots=2)
    hl = eng.submit(LONG, max_new_tokens=MAX_NEW)
    eng.step()                                 # chunking begins
    assert eng._chunk_req is hl._req
    assert hl._req.prefill_chunks == _chunks(len(LONG), 5)
    assert hl._req.chunk_pos == 5
    hs = eng.submit(SHORT, max_new_tokens=MAX_NEW)
    while eng._chunk_req is not None:
        assert hs._req.state == "queued"       # held behind the chunk
        eng.step()
    assert [hl.result(), hs.result()] == _whole([LONG, SHORT])
    ts.assert_pool_whole(eng)


def test_chunk_waits_for_a_free_slot():
    eng = _engine(chunk_tokens=5, slots=1)
    hs = eng.submit(SHORT, max_new_tokens=MAX_NEW)
    eng.step()
    hl = eng.submit(LONG, max_new_tokens=MAX_NEW)
    eng.step()
    assert eng._chunk_req is None and hl._req.state == "queued"
    assert [hs.result(), hl.result()] == _whole([SHORT, LONG])
    assert eng.stats().prefill_chunk_steps == _chunks(len(LONG), 5)
    ts.assert_pool_whole(eng)


def test_cancel_mid_chunk_returns_slot_and_pages():
    eng = _engine(chunk_tokens=5, slots=1)
    hl = eng.submit(LONG, max_new_tokens=MAX_NEW)
    eng.step()
    assert eng._chunk_req is not None and eng.kv.pages_in_use > 0
    hl.cancel()
    assert eng._chunk_req is None
    assert eng.kv.pages_in_use == 0 and eng.scheduler.free_slots == 1
    assert hl.result() == []
    s = eng.stats()
    assert s.cancelled == 1 and s.prefill_chunk_active == 0
    assert eng.submit(SHORT, max_new_tokens=MAX_NEW).result() \
        == _whole([SHORT])[0]
    ts.assert_pool_whole(eng)


def test_deadline_mid_chunk_fails_typed():
    """A deadline that passes while the prompt is mid-chunk fails the
    request typed at the next step's sweep and returns its slot and its
    whole reservation."""
    e = _engine(chunk_tokens=5, slots=1)
    h = e.submit(LONG, max_new_tokens=MAX_NEW, deadline_s=0.20)
    e.step()
    assert e._chunk_req is not None
    time.sleep(0.25)
    e.step()                                   # the sweep fires
    with pytest.raises(DeadlineExceededError, match="mid-chunked-prefill"):
        h.result()
    assert e._chunk_req is None and e.scheduler.free_slots == 1
    ts.assert_pool_whole(e)
    assert e.stats().deadline_exceeded == 1
    assert h.timeline.terminal_cause == "deadline"
    e.close()


def test_feasibility_prices_chunked_service_waves():
    """A chunking engine observes the prefill histogram once a chunk, so
    the feasibility estimate scales its prefill term by the arrival's
    chunk count: on the same observations the port's estimate and its
    parts equal the reference's `control.feasibility_estimate`."""
    from paddle_tpu.serving.control import feasibility_estimate

    ref, e = JaxEngine(JAX_MODEL, chunk_tokens=5, **_kw()), _engine(
        chunk_tokens=5)
    for _ in range(8):
        ref.metrics.observe_prefill(0.05)
        ref.metrics.observe_decode_step(0.01)
        e.metrics.observe("h_prefill", 0.05)
        e.metrics.observe("h_decode", 0.01)
    for n in (len(LONG), 3):
        want, dw = feasibility_estimate(ref, MAX_NEW, prompt_tokens=n)
        got, dg = e._feasibility_estimate(MAX_NEW, prompt_tokens=n)
        assert got == pytest.approx(want)
        for k in ("prefill_chunks", "prefill_s", "decode_step_s",
                  "backlog_s"):
            assert dg[k] == pytest.approx(dw[k]), k
    assert e._feasibility_estimate(MAX_NEW, len(LONG))[1][
        "prefill_chunks"] == -(-len(LONG) // 5)
    ref.close()
    e.close()


@pytest.mark.parametrize("kw,match", [
    (dict(chunk_tokens=0), "chunk_tokens must be > 0"),
    (dict(chunk_tokens=8, kv_mode="slots"), "kv_mode='paged'"),
    (dict(chunk_tokens=8, spec_k=2), "spec_k")],
    ids=["zero", "slots", "spec_k"])
def test_chunk_knob_validation(kw, match):
    for make in (lambda: JaxEngine(JAX_MODEL, **_kw(**kw)),
                 lambda: Engine(MODEL, device="cpu", **_kw(**kw))):
        with pytest.raises(ValueError, match=match):
            make()


def test_fp8_pages_compose_with_chunking():
    outs = []
    for eng in (JaxEngine(JAX_MODEL, chunk_tokens=5, **_kw(kv_quant="fp8")),
                _engine(chunk_tokens=5, kv_quant="fp8")):
        outs.append([eng.submit(r, max_new_tokens=MAX_NEW).result()
                     for r in (LONG, SHORT)])
        s = eng.stats()
        assert s.prefill_chunk_steps > 0 and s.kv_quant == "fp8"
    assert outs[1] == outs[0]
    ts.assert_pool_whole(eng)


def test_embed_matches_reference_and_leaves_the_pool_empty():
    """Final-token ``ln_f`` hidden states, chunked and whole, within
    float32 tolerance of the reference's; deterministic; the slot and
    pages released."""
    ref = JaxEngine(JAX_MODEL, chunk_tokens=5, **_kw())
    want = ref.embed([LONG, SHORT])
    for ct in (5, None):
        eng = _engine(chunk_tokens=ct)
        got = eng.embed([LONG, SHORT])
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == (64,)
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                       rtol=0)
        assert eng.kv.pages_in_use == 0
        assert eng.scheduler.free_slots == eng.slots
        assert eng.stats().embed_prompts == 2
    np.testing.assert_array_equal(eng.embed([LONG])[0], got[0])
    assert not np.array_equal(got[0], got[1])
    ts.assert_pool_whole(eng)


def test_embed_interleaves_with_live_decode():
    eng = _engine(chunk_tokens=5)
    h = eng.submit(SHORT, max_new_tokens=8)
    eng.step()
    vec = eng.embed([LONG])[0]
    assert vec.shape == (64,)
    assert h.result() == _whole([SHORT], mn=8)[0]
    assert eng.stats().embed_prompts == 1
    ts.assert_pool_whole(eng)


def test_embed_requires_paged_mode():
    for eng in (JaxEngine(JAX_MODEL, slots=2, max_len=40,
                          prefill_buckets=(8, 32)),
                Engine(MODEL, device="cpu", slots=2, max_len=40,
                       prefill_buckets=(8, 32))):
        with pytest.raises(RuntimeError, match="paged"):
            eng.embed([SHORT])
