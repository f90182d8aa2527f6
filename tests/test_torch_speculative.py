"""The port's speculative drafting against paddle_tpu's.

`NgramDrafter` (``draft`` and the sampled ``draft_with_q``),
`normalize_draft` and `longest_accept` are host-side numpy in both
packages; on the same seeded contexts they must give identical outputs.
"""
import numpy as np
import pytest

from paddle_tpu.serving import speculative as jspec
from paddle_tpu_torch.serving import speculative as spec


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
