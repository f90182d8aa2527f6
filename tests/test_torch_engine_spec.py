"""Quantized-KV and speculative serving: the port's Engine against
paddle_tpu's ``Engine(kv_mode="paged", kv_quant=..., spec_k=...)``.

Both engines serve the same ``gpt-test`` weights through the same
staggered submits at page size 4, where every verify window of k + 1 = 4
lanes crosses a page boundary unless its cursor sits on one, and must
emit identical greedy tokens for ``kv_quant`` in {int8, fp8} and
``spec_k`` in {0, 3}, with every page back in the pool. In the port, the
speculative streams equal the plain ones, an EOS inside an accepted
window ends the request there, a sampled request that drafts nothing
draws bit for bit as with ``spec_k=0``, and sampled speculative output
is distributed as plain sampled decode (two-sample chi-square).
The reference's engines compile, so each configuration runs once, in a
module-scoped fixture.
"""
import numpy as np
import pytest
import torch
from scipy.stats import chi2

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving.paged import pages_in_budget as jax_pages_in_budget
from paddle_tpu_torch.models import GPTForPretraining, load_paddle_tpu_state_dict
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving.paged import pages_in_budget

paddle.seed(131)
JAX_MODEL = JaxGPT(JaxGPTModel(jax_gpt_config("gpt-test")))
JAX_MODEL.eval()
MODEL = load_paddle_tpu_state_dict(
    GPTForPretraining("gpt-test", device="cpu"),
    {k: np.asarray(v._value) for k, v in JAX_MODEL.state_dict().items()})
MAX_NEW, SPEC_K, PS = 10, 3, 4
CONFIGS = [(q, k) for q in ("int8", "fp8") for k in (0, SPEC_K)]
ENGINE_KW = dict(slots=2, max_len=8 + MAX_NEW + SPEC_K, prefill_buckets=(8,),
                 page_size=PS)


def _rows(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, (n,)).astype("int64") for n in lens]


ROWS = _rows(29, (6, 4, 2, 8, 5))


def _serve(eng, eos=None):
    """Staggered traffic: one request, a step, two more, a step, the
    rest. Returns the outputs, the stats and the page accounting seen
    after every step."""
    whole = []
    kw = dict(max_new_tokens=MAX_NEW, eos_token_id=eos)
    handles = [eng.submit(ROWS[0], **kw)]
    eng.step()
    whole.append(_whole(eng.stats()))
    handles += [eng.submit(r, **kw) for r in ROWS[1:3]]
    eng.step()
    whole.append(_whole(eng.stats()))
    handles += [eng.submit(r, **kw) for r in ROWS[3:]]
    while eng.step():
        whole.append(_whole(eng.stats()))
    return [h.result() for h in handles], eng.stats(), whole


def _whole(s):
    return (s.kv_pages_in_use + s.kv_pages_free == s.kv_pages_total
            and sum(s.kv_slot_pages) == s.kv_pages_in_use)


@pytest.fixture(scope="module")
def runs():
    """(reference, port) results of every configuration, served once."""
    out = {}
    for q, k in CONFIGS:
        out[(q, k)] = (
            _serve(JaxEngine(JAX_MODEL, kv_mode="paged", kv_quant=q,
                             spec_k=k, **ENGINE_KW)),
            _serve(Engine(MODEL, device="cpu", kv_quant=q, spec_k=k,
                          **ENGINE_KW)))
    return out


@pytest.mark.parametrize("q,k", CONFIGS, ids=lambda v: str(v))
def test_greedy_streams_match_reference(runs, q, k):
    (ref, ref_stats, _), (got, stats, _) = runs[(q, k)]
    assert got == ref
    assert all(len(o) == MAX_NEW for o in got)
    assert (stats.decode_steps, stats.prefill_steps) == (
        ref_stats.decode_steps, ref_stats.prefill_steps)
    assert (stats.spec_draft_tokens, stats.spec_accepted_tokens) == (
        ref_stats.spec_draft_tokens, ref_stats.spec_accepted_tokens)
    assert stats.kv_quant == ref_stats.kv_quant == q
    assert stats.kv_pool_bytes == ref_stats.kv_pool_bytes
    assert stats.spec_k == k
    # on the CPU the plain version serves every step: no launches
    assert stats.paged_attention_launches == 0


@pytest.mark.parametrize("q,k", CONFIGS, ids=lambda v: str(v))
def test_page_accounting_is_whole_after_every_step(runs, q, k):
    _, (_, stats, whole) = runs[(q, k)]
    assert all(whole)
    assert stats.completed == len(ROWS) and stats.active_slots == 0
    assert stats.kv_pages_in_use == 0
    assert stats.kv_pages_free == stats.kv_pages_total
    assert stats.kv_slot_pages == (0, 0)


@pytest.mark.parametrize("q", ["int8", "fp8"])
def test_spec_streams_equal_plain_streams_in_the_port(runs, q):
    _, (plain, plain_stats, _) = runs[(q, 0)]
    _, (spec, stats, _) = runs[(q, SPEC_K)]
    assert spec == plain
    # greedy random-weight streams loop, and the drafter rides the loops
    assert stats.spec_accepted_greedy > 0
    assert stats.decode_steps < plain_stats.decode_steps
    assert stats.spec_drafted_sampled == stats.spec_accepted_sampled == 0
    assert stats.spec_accept_rate == (stats.spec_accepted_tokens
                                      / stats.spec_draft_tokens)


class _Oracle:
    """A drafter that proposes each request's known greedy continuation,
    so every window accepts all of its drafts."""

    def __init__(self, streams):
        self.streams = streams

    def draft(self, ctx, k):
        for row, stream in zip(ROWS, self.streams):
            n = len(ctx) - len(row)
            if (n >= 0 and np.array_equal(ctx[:len(row)], row)
                    and list(ctx[len(row):]) == stream[:n]):
                return np.asarray(stream[n:n + k], np.int32)
        return np.zeros((0,), np.int32)


def test_eos_inside_an_accepted_window_frees_the_slot(runs):
    """With every draft accepted, windows emit k + 1 = 4 tokens: the
    first request's EOS, at its first occurrence inside such a window,
    ends the request there (the window's later tokens are not emitted),
    frees its slot and pages, and the reference does the same."""
    _, (free, _, _) = runs[("int8", SPEC_K)]
    eos = 10
    cut = free[0].index(eos)
    assert cut % (SPEC_K + 1) != 0, "the EOS must not end its window"
    oracle = _Oracle(free)
    port = Engine(MODEL, device="cpu", kv_quant="int8", spec_k=SPEC_K,
                  **ENGINE_KW)
    port._drafter = oracle
    ref = JaxEngine(JAX_MODEL, kv_mode="paged", kv_quant="int8",
                    spec_k=SPEC_K, draft_model=oracle.draft, **ENGINE_KW)
    outs = []
    for eng in (port, ref):
        got, stats, whole = _serve(eng, eos=eos)
        outs.append(got)
        assert all(whole) and stats.completed == len(ROWS)
        assert stats.kv_pages_in_use == 0 and stats.active_slots == 0
        assert stats.spec_accepted_greedy == stats.spec_drafted_greedy > 0
    assert outs[0] == outs[1]
    assert outs[0][0] == free[0][:cut + 1]
    for got, want in zip(outs[0], free):
        assert got == (want[:want.index(eos) + 1] if eos in want else want)


def _sampled(spec_k, drafter=None, seed=11):
    eng = Engine(MODEL, device="cpu", kv_quant="int8", spec_k=spec_k,
                 top_k=20, **ENGINE_KW)
    if drafter is not None:
        eng._drafter = drafter
    eng.submit(ROWS[1], max_new_tokens=MAX_NEW)       # a greedy neighbour
    h = eng.submit(ROWS[0], max_new_tokens=MAX_NEW,
                   decode_strategy="sampling", temperature=0.7, top_p=0.9,
                   seed=seed)
    return h.result(), eng.stats()


class _NoDraft:
    """A drafter that never proposes anything."""

    def draft(self, ctx, k):
        return np.zeros((0,), np.int32)

    def draft_with_q(self, ctx, k, vocab_size, seed=None):
        return np.zeros((0,), np.int32), None


def test_sampled_request_that_drafts_nothing_draws_as_without_spec():
    plain, _ = _sampled(0)
    got, stats = _sampled(SPEC_K, drafter=_NoDraft())
    assert got == plain
    assert stats.spec_draft_tokens == 0
    # with the n-gram drafter the request drafts and stays reproducible
    a, sa = _sampled(SPEC_K)
    b, _ = _sampled(SPEC_K)
    assert a == b and len(a) == MAX_NEW and all(0 <= t < 256 for t in a)
    assert sa.spec_drafted_sampled > 0


def _chi2_two_sample(a, b):
    """Two-sample chi-square statistic over pooled token counts ->
    (stat, df); bins empty in both samples leave the df."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mask = (a + b) > 0
    a, b = a[mask], b[mask]
    k1, k2 = np.sqrt(b.sum() / a.sum()), np.sqrt(a.sum() / b.sum())
    return float(((k1 * a - k2 * b) ** 2 / (a + b)).sum()), int(mask.sum()) - 1


class _Cycler:
    """A deterministic drafter (point-mass q): the motif's continuation."""

    def __init__(self, motif):
        self.motif = motif

    def draft_with_q(self, ctx, k, vocab_size, seed=None):
        return np.array([self.motif[(len(ctx) + i) % len(self.motif)]
                         for i in range(k)], np.int32)


def test_sampled_spec_output_is_distributed_as_plain_sampled_decode():
    """Pooled emitted-token frequencies over 300 seeds on a 13-token
    vocabulary: plain sampled decode against spec_k=3 with the n-gram
    drafter's sampled proposals, and against a deterministic point-mass
    drafter; a biased accept rule would move mass toward the drafts.
    alpha = 0.001 (tests/test_spec_sampling.py:167-257)."""
    vocab, max_new, seeds = 13, 6, range(300)
    model = GPTForPretraining(
        GPTConfig(vocab, 32, 2, 2, 64, 64, use_flash_attention=False),
        device="cpu", seed=211)
    motif = np.asarray([3, 11, 5], np.int64)
    prompt = np.tile(motif, 2)                   # the n-gram drafter matches

    def counts(spec_k, drafter=None):
        eng = Engine(model, device="cpu", slots=8,
                     max_len=8 + max_new + 3, prefill_buckets=(8,),
                     page_size=4, kv_quant="int8", spec_k=spec_k)
        if drafter is not None:
            eng._drafter = drafter
        handles = [eng.submit(prompt, max_new_tokens=max_new,
                              decode_strategy="sampling", temperature=1.0,
                              seed=int(s)) for s in seeds]
        c = np.zeros(vocab, np.int64)
        for h in handles:
            c += np.bincount(h.result(), minlength=vocab)[:vocab]
        return c, eng.stats()

    off, _ = counts(0)
    for name, drafter in (("ngram", None), ("point-mass", _Cycler(motif))):
        on, stats = counts(3, drafter)
        assert off.sum() == on.sum() == len(seeds) * max_new
        assert stats.spec_drafted_sampled > 0
        assert 0 < stats.spec_accepted_sampled < stats.spec_drafted_sampled
        stat, df = _chi2_two_sample(off, on)
        crit = chi2.ppf(0.999, df)
        assert stat < crit, (f"{name}: chi2={stat:.1f} >= {crit:.1f} "
                             f"(df={df})\noff={off}\non ={on}")


@pytest.mark.parametrize("q", [None, "int8", "fp8"])
def test_pool_bytes_and_pages_in_budget_match_reference(q):
    """The pool's stored bytes, and the pages a byte budget buys: int8
    and fp8 pages of head_dim 16 hold 4 * 16 / (16 + 4) = 3.2x the f32
    pages."""
    budget = 200_000
    got = pages_in_budget(MODEL, budget, page_size=PS, kv_quant=q)
    assert got == jax_pages_in_budget(JAX_MODEL, budget, page_size=PS,
                                      kv_quant=q)
    if q is not None:
        assert got / pages_in_budget(MODEL, budget, page_size=PS) > 3.0
    eng = Engine(MODEL, device="cpu", kv_quant=q, **ENGINE_KW)
    ref = JaxEngine(JAX_MODEL, kv_mode="paged", kv_quant=q, **ENGINE_KW)
    assert eng.stats().kv_pool_bytes == ref.stats().kv_pool_bytes
    assert eng.stats().kv_bytes_per_token == ref.stats().kv_bytes_per_token
    if q is not None:
        assert eng.kv.caches[0][0].dtype == {
            "int8": torch.int8, "fp8": torch.float8_e4m3fn}[q]
        assert eng.kv.scales[0][0].shape == (eng.kv.pages_total + 1, 4, PS)


def test_spec_lanes_count_against_max_len_and_pages():
    eng = Engine(MODEL, device="cpu", kv_quant="int8", spec_k=SPEC_K,
                 **ENGINE_KW)
    with pytest.raises(ValueError, match="speculative verify lanes"):
        eng.submit(ROWS[0], max_new_tokens=MAX_NEW + 1)
    # 4 pages hold bucket 8 + 8 decode writes, not the 3 lanes past them
    Engine(MODEL, device="cpu", kv_pages=4, **ENGINE_KW).submit(
        ROWS[0], max_new_tokens=9)
    small = Engine(MODEL, device="cpu", spec_k=SPEC_K, kv_pages=4,
                   **ENGINE_KW)
    with pytest.raises(ValueError, match="KV pages"):
        small.submit(ROWS[0], max_new_tokens=9)
    with pytest.raises(ValueError, match="spec_k"):
        Engine(MODEL, device="cpu", spec_k=-1, **ENGINE_KW)
    with pytest.raises(ValueError, match="kv_quant"):
        Engine(MODEL, device="cpu", kv_quant="int4", **ENGINE_KW)
