"""The port's GPT against paddle_tpu's on the same weights.

paddle_tpu's ``gpt-test`` model (eval mode, so dropout is off) is exported
as numpy arrays and loaded into the port with
`load_paddle_tpu_state_dict`. The masked prefill and the paged decode
step then get the same numpy-seeded inputs in both packages; logits
(and the K/V they write) agree in float32 at atol 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu_torch.models import GPTForPretraining, load_paddle_tpu_state_dict
from paddle_tpu_torch.models.gpt import GPT_CONFIGS, unpack_qkv_pair_major

ATOL = 1e-4


def _jax_model(seed=97):
    paddle.seed(seed)
    model = JaxGPT(JaxGPTModel(jax_gpt_config("gpt-test")))
    model.eval()
    return model


JAX_MODEL = _jax_model()
ARRAYS = {k: np.asarray(v._value) for k, v in JAX_MODEL.state_dict().items()}


def _port_model():
    return load_paddle_tpu_state_dict(
        GPTForPretraining("gpt-test", device="cpu"), ARRAYS)


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def test_configs_match_the_reference_catalog():
    from paddle_tpu.models.gpt import GPT_CONFIGS as JAX_CONFIGS

    assert set(GPT_CONFIGS) == set(JAX_CONFIGS)
    for name, cfg in GPT_CONFIGS.items():
        assert vars(cfg) == vars(JAX_CONFIGS[name]), name
        assert cfg.num_params() == JAX_CONFIGS[name].num_params()


def test_pair_major_unpack_matches_reference():
    from paddle_tpu.models.gpt import _unpack_qkv_pair_major

    rng = np.random.default_rng(1)
    for heads in (4, 3):
        qkv = rng.standard_normal((2, 5, 3 * heads * 8)).astype(np.float32)
        ref = _unpack_qkv_pair_major(qkv, heads, 8)
        got = unpack_qkv_pair_major(torch.from_numpy(qkv), heads, 8)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_prefill_logits_with_left_pad_mask_match():
    model = _port_model()
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 255, (2, 8)).astype(np.int64)
    amask = np.ones((2, 8), np.int32)
    amask[0, :3] = 0
    ids[0, :3] = 0
    j_logits, j_caches = JAX_MODEL.prefill(
        paddle.to_tensor(ids), JAX_MODEL.gen_static_cache(2, 8),
        pad_mask=paddle.to_tensor(amask))
    with torch.inference_mode():
        logits, caches = model.prefill(
            torch.from_numpy(ids), model.gen_static_cache(2, 8),
            pad_mask=torch.from_numpy(amask))
    assert logits.shape == (2, 1, 256)
    np.testing.assert_allclose(logits.numpy(), _np(j_logits), atol=ATOL,
                               rtol=0)
    for (k, v), (jk, jv) in zip(caches, j_caches):
        np.testing.assert_allclose(k.numpy(), _np(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(v.numpy(), _np(jv), atol=ATOL, rtol=0)


def test_decode_slots_paged_logits_match():
    """Three slots at ragged depths (one with left pads, one parked on
    the sentinel page) over pools holding numpy-seeded K/V."""
    model = _port_model()
    rng = np.random.default_rng(11)
    cfg = model.config
    ps, max_pages, pages = 4, 4, 12
    shape = (pages + 1, cfg.num_attention_heads, ps, cfg.head_dim)
    pools = [(rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal(shape).astype(np.float32))
             for _ in range(cfg.num_hidden_layers)]
    bt = np.full((3, max_pages), pages, np.int32)
    bt[0] = rng.permutation(pages)[:max_pages]
    bt[1, :3] = rng.permutation(pages)[:3]
    steps = np.array([13, 9, 0], np.int32)
    pads = np.array([2, 0, 0], np.int32)
    vc = np.ones((3, max_pages * ps), np.int32)
    vc[0, :2] = 0
    vc[2] = 0
    tok = rng.integers(1, 255, (3,)).astype(np.int64)
    j_logits, j_pools = JAX_MODEL.decode_slots_paged(
        paddle.to_tensor(tok[:, None]), paddle.to_tensor(steps),
        [(paddle.to_tensor(k), paddle.to_tensor(v)) for k, v in pools],
        paddle.to_tensor(bt), pads=paddle.to_tensor(pads),
        valid_cols=paddle.to_tensor(vc))
    t_pools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
               for k, v in pools]
    with torch.inference_mode():
        logits = model.decode_slots_paged(
            torch.from_numpy(tok[:, None]), torch.from_numpy(steps),
            t_pools, torch.from_numpy(bt), pads=torch.from_numpy(pads),
            valid_cols=torch.from_numpy(vc))
    assert logits.shape == (3, 1, 256)
    # the parked row (never read by the engine) averages its table, all
    # sentinel pages, as the reference does
    np.testing.assert_allclose(logits.numpy(), _np(j_logits), atol=ATOL,
                               rtol=0)
    for (k, v), (jk, jv) in zip(t_pools, j_pools):
        np.testing.assert_allclose(k.numpy()[:pages], _np(jk)[:pages],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(v.numpy()[:pages], _np(jv)[:pages],
                                   atol=ATOL, rtol=0)


def test_state_dict_without_qkv_layout_is_refused():
    arrays = {k: v for k, v in ARRAYS.items() if "qkv_layout" not in k}
    with pytest.raises(ValueError, match="head-major"):
        load_paddle_tpu_state_dict(
            GPTForPretraining("gpt-test", device="cpu"), arrays)


@pytest.mark.parametrize("edit", ["missing", "unexpected", "shape", "layout"])
def test_mismatched_state_dict_is_refused(edit):
    arrays = dict(ARRAYS)
    if edit == "missing":
        del arrays["gpt.ln_f.bias"]
    elif edit == "unexpected":
        arrays["gpt.extra.weight"] = np.zeros(3, np.float32)
    elif edit == "shape":
        arrays["gpt.ln_f.bias"] = np.zeros(3, np.float32)
    else:
        arrays["gpt.h.0.attn.qkv_layout"] = np.asarray(2, np.int32)
    with pytest.raises(ValueError):
        load_paddle_tpu_state_dict(
            GPTForPretraining("gpt-test", device="cpu"), arrays)


def test_random_weights_are_reproducible_from_the_seed():
    a = GPTForPretraining("gpt-test", device="cpu", seed=3).state_dict()
    b = GPTForPretraining("gpt-test", device="cpu", seed=3).state_dict()
    c = GPTForPretraining("gpt-test", device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["gpt.h.0.attn.qkv_proj.weight"],
                           c["gpt.h.0.attn.qkv_proj.weight"])
    assert torch.equal(a["gpt.h.0.ln_1.weight"], torch.ones(64))


def test_bfloat16_model_and_cache_checks():
    model = GPTForPretraining("gpt-test", device="cpu", dtype="bfloat16")
    assert model.dtype is torch.bfloat16
    k, v = model.gen_page_pool(3, 8)[0]
    assert k.shape == (3, 4, 8, 16) and k.dtype is torch.bfloat16
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model.gen_static_cache(1, 65)
