"""``Engine(dtype=)``: the KV cache in a float dtype of its own, against
paddle_tpu's ``Engine(dtype=)``.

Both engines serve ``gpt-test`` on the same numpy-seeded weights through
the same submits, on the page pool (``kv_mode="paged"``) and on the
dense slot caches, with the KV stored in float32, bfloat16 or float16
while the model computes in float32. The reference casts each K/V write
to the cache's dtype and widens what it reads (``paged_kv.py:106``,
:131; ``paged_attention.py:140-150``); so does the port (its writers,
and the paged kernel's plain version, B3). Greedy streams are identical
token for token in every case here: where the pages are float32 the two
compute the same float32 math, and on 16-bit pages both round the same
float32 values to the same 16-bit ones at this size (a tie within a
16-bit rounding would let them part; none occurs on these seeds). The
caches hold the asked dtype, ``stats()`` reports the pool's bytes at
that dtype as the reference does, and `pages_in_budget` gives the
reference's page count for each dtype.

A float16 model (the reference's parameters loaded as float16 by
`models.convert`) serves on float16 pages and on float32 ones, each
against the reference's float16 model on the same pages.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving.paged import pages_in_budget as jax_pages_in_budget
from paddle_tpu_torch.models import (GPTForPretraining,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving.paged import pages_in_budget

import _torch_serving as ts

JAX_MODEL, MODEL = ts.both_models(seed=26)
MAX_NEW = 6
DTYPES = ("float32", "bfloat16", "float16")


def _serve(eng, rows):
    handles = [eng.submit(r, max_new_tokens=MAX_NEW) for r in rows]
    return [h.result() for h in handles]


def _kw(kv_mode):
    kw = dict(slots=2, max_len=16 + MAX_NEW, prefill_buckets=(8, 16),
              kv_mode=kv_mode)
    if kv_mode == "paged":
        kw["page_size"] = 4
    return kw


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_mode", ["paged", "slots"])
def test_streams_match_the_reference_per_kv_dtype(kv_mode, dtype):
    rows = ts.rows(60, (5, 13, 7, 16))
    ref = JaxEngine(JAX_MODEL, dtype=dtype, **_kw(kv_mode))
    port = Engine(MODEL, device="cpu", dtype=dtype, **_kw(kv_mode))
    want, got = _serve(ref, rows), _serve(port, rows)
    assert got == want
    assert len({tuple(o) for o in got}) == len(rows)
    for k, v in port.kv.caches:
        assert k.dtype == v.dtype == getattr(torch, dtype)
    rs, ps = ref.stats(), port.stats()
    assert ps.kv_cache_bytes == rs.kv_cache_bytes
    assert ps.decode_traces == 1
    if kv_mode == "paged":
        assert ps.kv_pool_bytes == rs.kv_pool_bytes
        assert ps.kv_bytes_per_token == rs.kv_bytes_per_token
        ts.assert_pool_whole(port)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_pages_in_budget_counts_bytes_at_the_stored_dtype(dtype, kv_quant):
    budget = 3 << 20
    want = jax_pages_in_budget(JAX_MODEL, budget, page_size=8, dtype=dtype,
                               kv_quant=kv_quant)
    got = pages_in_budget(MODEL, budget, page_size=8, dtype=dtype,
                          kv_quant=kv_quant)
    assert got == want
    eng = Engine(MODEL, device="cpu", slots=2, max_len=24, page_size=8,
                 kv_pool_bytes=budget, dtype=dtype, kv_quant=kv_quant)
    assert eng.kv.pages_total == want
    assert eng.stats().kv_pool_bytes <= budget


def test_a_sixteen_bit_pool_holds_twice_the_pages_of_float32():
    budget = 4 << 20
    n32, n16, nbf = (pages_in_budget(MODEL, budget, page_size=8, dtype=d)
                     for d in DTYPES)
    assert n16 == nbf and abs(n16 - 2 * n32) <= 1


def _float16_models():
    """The reference's gpt-test cast to float16 (``Layer.to``) after its
    seeded float32 weights, and the port's, loaded from the reference's
    float16 arrays through `load_paddle_tpu_state_dict`."""
    jm = JaxGPT(JaxGPTModel(jax_gpt_config("gpt-test")))
    jm.eval()
    jm.set_state_dict(ts.seeded_arrays(jm, 26))
    jm.to(dtype="float16")
    half = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    assert half["gpt.embeddings.word_embeddings.weight"].dtype == np.float16
    port = load_paddle_tpu_state_dict(
        GPTForPretraining("gpt-test", device="cpu", dtype="float16"), half)
    return jm, port


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_a_float16_model_serves_from_its_pages(dtype):
    """A float16 model on float16 pages (``dtype=None``: the model's)
    and on float32 pages, each stream held against the reference's
    float16 model on the same pages."""
    jm, pm = _float16_models()
    assert {p.dtype for p in pm.parameters()} == {torch.float16}
    rows = ts.rows(61, (6, 11, 3))
    ref = JaxEngine(jm, dtype=dtype, **_kw("paged"))
    port = Engine(pm, device="cpu", dtype=dtype, **_kw("paged"))
    want, got = _serve(ref, rows), _serve(port, rows)
    assert got == want
    pages = port.kv.caches[0][0].dtype
    assert pages == (torch.float16 if dtype is None else torch.float32)
    assert port.stats().kv_pool_bytes == ref.stats().kv_pool_bytes
