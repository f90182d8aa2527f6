"""The port's speculative drafting against paddle_tpu's, and the
Engine's ``draft_model=`` hook after ``tests/test_speculative.py:
140-330``.

`NgramDrafter` (``draft`` and the sampled ``draft_with_q``),
`CallableDrafter`, `normalize_draft` and `longest_accept` are host-side
numpy in both packages; on the same seeded contexts they must give
identical outputs. The engine cases serve ``gpt-test`` in float32 on the
same numpy-seeded weights as paddle_tpu's model: a drafter given as
``draft_model=`` (an oracle of the reference's greedy stream, an
always-wrong one, an object whose drafts are too long) rides the verify
window, and the greedy tokens equal the reference's; an EOS inside an
accepted window ends the request there; a full rollback every step
leaves shared prefix pages' references as they were; a deadline or an
injected step error mid-verify drains the pool.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import speculative as jspec
from paddle_tpu_torch.observability import get_sentinel
from paddle_tpu_torch.serving import (DeadlineExceededError, Engine,
                                      FaultInjector)
from paddle_tpu_torch.serving import speculative as spec

import _torch_serving as ts

JAX_MODEL, MODEL = ts.both_models(seed=137)
MAX_NEW, PS = 4, 4


def _contexts(seed):
    """Seeded contexts: random over a small vocabulary (many partial
    matches), a cycle with a noisy prefix (full-length matches), a
    context of one token, and one with no repeated token."""
    rng = np.random.default_rng(seed)
    cyc = np.tile(rng.integers(0, 9, (4,)), 6)
    return [rng.integers(0, 6, (40,)),
            np.concatenate([rng.integers(0, 50, (7,)), cyc]),
            np.array([3]),
            np.arange(20)]


@pytest.mark.parametrize("max_ngram", [1, 3])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_ngram_draft_matches_reference(max_ngram, k):
    mine = spec.NgramDrafter(max_ngram=max_ngram)
    ref = jspec.NgramDrafter(max_ngram=max_ngram)
    for seed in range(4):
        for ctx in _contexts(seed):
            got, want = mine.draft(ctx, k), ref.draft(ctx, k)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 4])
def test_ngram_draft_with_q_matches_reference(k):
    """The sampled proposal: the same tokens from the same seed, and the
    same floor-smoothed empirical rows."""
    mine = spec.NgramDrafter(max_ngram=3, q_floor=0.05)
    ref = jspec.NgramDrafter(max_ngram=3, q_floor=0.05)
    for seed in range(4):
        for ctx in _contexts(seed):
            for draw in ((seed, 0, 0), (seed, 7, 0), 123):
                got = mine.draft_with_q(ctx, k, 60, seed=draw)
                want = ref.draft_with_q(ctx, k, 60, seed=draw)
                np.testing.assert_array_equal(got[0], want[0])
                if want[1] is None:
                    assert got[1] is None
                else:
                    np.testing.assert_array_equal(got[1], want[1])


def test_drafter_rejects_bad_arguments_as_the_reference():
    for kw in (dict(max_ngram=0), dict(min_ngram=3, max_ngram=2),
               dict(q_floor=0.0), dict(q_floor=1.0)):
        with pytest.raises(ValueError):
            jspec.NgramDrafter(**kw)
        with pytest.raises(ValueError):
            spec.NgramDrafter(**kw)


@pytest.mark.parametrize("out,k", [
    ([5, 6, 7], 2), (np.array([[1, 2]]), 4), ([], 3),
    (([4, 5, 6], [0.5, 0.25, 0.125]), 2),
    (([4, 5], np.full((2, 8), 0.125)), 3),
    (([9], 0.75), 1), (([], None), 2)],
    ids=["clip", "2d", "empty", "q_per_token", "q_rows", "q_scalar",
         "empty_tuple"])
def test_normalize_draft_matches_reference(out, k):
    got_t, got_q = spec.normalize_draft(out, k)
    want_t, want_q = jspec.normalize_draft(out, k)
    np.testing.assert_array_equal(got_t, want_t)
    assert got_t.dtype == want_t.dtype
    if want_q is None:
        assert got_q is None
    else:
        np.testing.assert_array_equal(got_q, want_q)


def test_longest_accept_matches_reference():
    rng = np.random.default_rng(17)
    for _ in range(200):
        w = int(rng.integers(1, 7))
        drafts = rng.integers(0, 3, (w,))
        verified = rng.integers(0, 3, (w,))
        nd = int(rng.integers(0, w))
        assert (spec.longest_accept(drafts, verified, nd)
                == jspec.longest_accept(drafts, verified, nd))


@pytest.mark.parametrize("k", [1, 3])
def test_callable_drafter_matches_reference(k):
    """A bare callable through `CallableDrafter`: token lists, 2-D
    arrays and ``(tokens, q)`` tuples, clipped to k, as the
    reference's."""
    outs = [lambda ctx, k: list(range(10, 10 + 2 * k)),
            lambda ctx, k: np.arange(6).reshape(2, 3),
            lambda ctx, k: (np.array([7, 8]), np.array([0.5, 0.25]))]
    for fn in outs:
        got = spec.CallableDrafter(fn).draft(np.arange(5), k)
        want = jspec.CallableDrafter(fn).draft(np.arange(5), k)
        if isinstance(want, tuple):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# -- the Engine's draft_model= hook ------------------------------------------
def _ref_row(row, mn=MAX_NEW):
    return np.asarray(JAX_MODEL.generate(paddle.to_tensor(row[None, :]),
                                         max_new_tokens=mn)._value)[0]


def _oracle(ref, prompt_len):
    """Proposes the true greedy continuation: every draft accepted."""
    def fn(ctx, k):
        done = len(ctx) - prompt_len
        return ref[done:done + k]
    return fn


def test_spec_eos_mid_accepted_window_and_draft_model_hook():
    """An EOS inside the accepted window ends the emission at the EOS
    (included) and frees the slot; the oracle given as ``draft_model=``
    accepts everything, and the tokens equal the reference engine's."""
    rng = np.random.default_rng(33)
    row, ref, e = None, None, None
    for _ in range(12):     # a continuation that switches tokens
        cand = rng.integers(1, 255, (int(rng.integers(3, 7)),)).astype(
            "int64")
        cref = _ref_row(cand)
        sw = [j for j in range(1, MAX_NEW)
              if cref[j] != cref[0] and cref[j] not in cref[:j]]
        if sw:
            row, ref, e = cand, cref, sw[0]
            break
    assert ref is not None, "no token-switching continuation found"
    eos = int(ref[e])
    kw = dict(slots=1, max_len=8 + MAX_NEW + 4, prefill_buckets=(8,),
              spec_k=4, kv_mode="paged", page_size=PS,
              draft_model=_oracle(ref, len(row)))
    want = JaxEngine(JAX_MODEL, **kw).submit(
        row, max_new_tokens=MAX_NEW, eos_token_id=eos).result()
    eng = Engine(MODEL, device="cpu", **kw)
    with get_sentinel().armed():
        got = eng.submit(row, max_new_tokens=MAX_NEW,
                         eos_token_id=eos).result()
    np.testing.assert_array_equal(np.asarray(got), ref[:e + 1])
    assert got == list(want)
    s = eng.stats()
    assert s.active_slots == 0 and s.kv_pages_in_use == 0
    assert s.spec_accept_rate == 1.0 and s.decode_traces == 1
    assert s.decode_steps < MAX_NEW - 1 or e < 2


def test_spec_rollback_leaves_shared_prefix_pages_untouched():
    """An always-wrong drafter rolls back every step while the slot maps
    shared prefix pages read-only: their references do not move, the
    cached prefix serves the next sharer exactly, and at idle only the
    tree's own references remain."""
    rng = np.random.default_rng(35)
    donor_p = rng.integers(1, 255, (12,)).astype("int64")
    sharer_p = np.concatenate([donor_p[:8],
                               rng.integers(1, 255, (2,)).astype("int64")])
    ref_d, ref_s = _ref_row(donor_p), _ref_row(sharer_p)

    def anti_oracle(ctx, k):
        for p, ref in ((donor_p, ref_d), (sharer_p, ref_s)):
            if len(ctx) >= len(p) and np.array_equal(ctx[:len(p)], p):
                done = len(ctx) - len(p)
                nxt = int(ref[done]) if done < len(ref) else 0
                return [(nxt % 254) + 1] * k
        return [1] * k

    eng = Engine(MODEL, slots=2, max_len=24, prefill_buckets=(4, 8, 16),
                 prefix_cache=True, page_size=PS, spec_k=3,
                 draft_model=anti_oracle, device="cpu")
    np.testing.assert_array_equal(
        np.asarray(eng.submit(donor_p, max_new_tokens=MAX_NEW).result()),
        ref_d)
    shared = [n.page for n in eng.prefix.match(sharer_p)]
    assert len(shared) == 2                  # 8 matched tokens / PS
    assert all(eng.kv.readers(p) == 1 for p in shared)   # the tree only
    h = eng.submit(sharer_p, max_new_tokens=MAX_NEW)
    eng.step()                               # admitted: maps the pages
    assert all(eng.kv.readers(p) == 2 for p in shared)
    eng.step()                               # one full-rollback verify
    assert all(eng.kv.readers(p) == 2 for p in shared)
    np.testing.assert_array_equal(np.asarray(h.result()), ref_s)
    s = eng.stats()
    assert all(eng.kv.readers(p) == 1 for p in shared)
    assert s.kv_pages_in_use == s.prefix_cached_pages
    assert s.spec_draft_tokens > 0 and s.spec_accepted_tokens == 0
    ts.assert_pool_whole(eng)


def test_spec_deadline_expiry_mid_verify_drains_pool():
    """A deadline that expires between verify steps (an injected clock
    skew) fails the request typed with its partial tokens kept, and the
    reservation, the k verify lanes' pages included, returns."""
    rng = np.random.default_rng(37)
    row = rng.integers(1, 255, (5,)).astype("int64")
    inj = FaultInjector().add("clock_skew", skew_s=1e6, at_step=2)
    eng = Engine(MODEL, slots=1, max_len=8 + 8 + 2, prefill_buckets=(8,),
                 kv_mode="paged", page_size=PS, spec_k=2,
                 fault_injector=inj, device="cpu")
    h = eng.submit(row, max_new_tokens=8, deadline_s=30.0)
    with pytest.raises(DeadlineExceededError):
        h.result()
    assert len(h.partial) >= 1
    assert h.partial == list(_ref_row(row, 8)[:len(h.partial)])
    assert eng.kv.pages_in_use == 0
    assert eng.stats().deadline_exceeded == 1


def test_spec_step_error_mid_verify_drains_pool_and_fails_typed():
    """A failure inside a verify dispatch takes the engine's death path:
    every handle fails with the cause, the pool drains, more work is
    refused."""
    rng = np.random.default_rng(39)
    rows = [rng.integers(1, 255, (4,)).astype("int64") for _ in range(2)]
    inj = FaultInjector().add("step_error", at_step=1, phase="decode")
    eng = Engine(MODEL, slots=2, max_len=8 + MAX_NEW + 2,
                 prefill_buckets=(8,), kv_mode="paged", page_size=PS,
                 spec_k=2, fault_injector=inj, device="cpu")
    handles = [eng.submit(r, max_new_tokens=MAX_NEW) for r in rows]
    for h in handles:
        with pytest.raises(RuntimeError):
            h.result()
    assert eng.kv.pages_in_use == 0
    assert inj.fired and inj.fired[0][0] == "step_error"
    with pytest.raises(RuntimeError, match="died"):
        eng.submit(rows[0], max_new_tokens=2)


def test_spec_overlong_draft_model_output_is_clipped():
    """A ``draft_model=`` object whose ``draft`` ignores k costs lanes,
    not the engine: the window takes at most k of its tokens."""
    rng = np.random.default_rng(49)
    row = rng.integers(1, 255, (5,)).astype("int64")

    class Greedy8:
        def draft(self, ctx, k):
            return list(range(1, 9))

    eng = Engine(MODEL, slots=1, max_len=8 + MAX_NEW + 2,
                 prefill_buckets=(8,), spec_k=2, draft_model=Greedy8(),
                 device="cpu")
    np.testing.assert_array_equal(
        np.asarray(eng.submit(row, max_new_tokens=MAX_NEW).result()),
        _ref_row(row))
    s = eng.stats()
    assert s.spec_draft_tokens <= 2 * s.decode_steps
