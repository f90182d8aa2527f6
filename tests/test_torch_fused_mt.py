"""The port's fused serving stack (`incubate.nn.FusedMultiTransformer`,
`functional.fused_multi_transformer`) and the fused attention's
``cache_kv`` against paddle_tpu's.

The counterparts of the reference's own tests in tests/test_decoding.py
(:38-123 prefill then decode against the full forward, the
``pre_caches`` prefix, the validations and the no-cache path; :217-246
the ``time_step`` bound and the decode step's ``attn_mask``; :269
``nranks``; :497 ``trans_qkvw=False``) run on the port, and the three
modes run beside the reference on the same weights (its state dict
loaded through `models.convert`) and inputs: outputs and caches within
1e-5 of their largest |value| (float32; the decode rows against the
full forward within the reference test's own 2e-5).
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.incubate.nn import FusedMultiTransformer as JFMT
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu_torch.incubate.nn import (FusedMultiTransformer,
                                          FusedTransformerEncoderLayer)
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models import export_paddle_tpu_state_dict

import _torch_layers as tl

REL = 1e-5
DECODE_TOL = dict(rtol=2e-5, atol=2e-5)


def _stacks(num_layers=2, embed=32, heads=4, ffn=64, seed=7, **kw):
    """The reference's stack with every parameter drawn at std 0.1 (as
    test_decoding.py's ``_rand_stack``) and the port's with its
    weights."""
    paddle_tpu.seed(seed)
    j = JFMT(embed, heads, ffn, dropout_rate=0.0, num_layers=num_layers,
             **kw)
    for p in j.parameters():
        p.set_value(paddle_tpu.randn(p.shape, dtype="float32") * 0.1)
    j.eval()
    port = FusedMultiTransformer(embed, heads, ffn, num_layers=num_layers,
                                 device="cpu", **kw)
    return j, tl.port_of(j, port)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        "float32")


def _causal(s):
    return np.triu(np.full((s, s), -1e9, "float32"), k=1)[None, None]


def _ts(t):
    return torch.tensor([t], dtype=torch.int32)


def _jts(t):
    return paddle_tpu.to_tensor([t], dtype="int32")


def test_three_modes_match_reference():
    """No cache (causal mask), prefill of 3 tokens, then decode steps 3-5:
    the port's outputs and caches are the reference's."""
    j, port = _stacks()
    x = _x(2, 6, 32)
    with jautograd.no_grad():
        jfull = j(tl.jtensor(x), attn_mask=tl.jtensor(_causal(6)))
        jc = j.gen_cache(2, 8)
        jouts = [j(tl.jtensor(x[:, :3]), caches=jc)]
        jc = jouts[0][1]
        for t in range(3, 6):
            jouts.append(j(tl.jtensor(x[:, t:t + 1]), caches=jc,
                           time_step=_jts(t)))
            jc = jouts[-1][1]
    with torch.no_grad():
        full = port(tl.t(x), attn_mask=tl.t(_causal(6)))
        c = port.gen_cache(2, 8)
        outs = []
        for t in range(2, 6):        # the prefill of 3, then 3 steps
            o, back = (port(tl.t(x[:, :3]), caches=c) if t == 2 else
                       port(tl.t(x[:, t:t + 1]), caches=c, time_step=_ts(t)))
            assert all(a is b for a, b in zip(back, c))   # in place
            outs.append((o, [a.clone() for a in back]))
    tl.close_to_scale(full.numpy(), np.asarray(jfull._value), REL)
    for (o, caches), (jo, jcaches) in zip(outs, jouts):
        tl.close_to_scale(o.numpy(), np.asarray(jo._value), REL)
        for a, b in zip(caches, jcaches):
            tl.close_to_scale(a.numpy(), np.asarray(b._value), REL)


def test_prefill_then_decode_matches_full():
    """test_decoding.py:38-64 on the port."""
    b, s, prompt = 2, 6, 3
    _, stack = _stacks()
    x = tl.t(_x(b, s, 32))
    with torch.no_grad():
        full = stack(x, attn_mask=tl.t(_causal(s)))
        caches = stack.gen_cache(b, 8)
        out_pre, caches = stack(x[:, :prompt], caches=caches)
        np.testing.assert_allclose(out_pre.numpy(), full[:, :prompt].numpy(),
                                   **DECODE_TOL)
        for t in range(prompt, s):
            step_out, caches = stack(x[:, t:t + 1], caches=caches,
                                     time_step=_ts(t))
            np.testing.assert_allclose(step_out.numpy(),
                                       full[:, t:t + 1].numpy(),
                                       **DECODE_TOL)
    assert not caches[0][:, :, :, s:].any()


def test_pre_caches_prefix():
    """test_decoding.py:67-96: a prefix prefilled alone and carved out as
    ``pre_caches`` continues as one prefill over the whole text."""
    b, c, s = 1, 2, 4
    _, stack = _stacks(seed=11)
    x = _x(b, c + s, 32)
    with torch.no_grad():
        out_a, caches_a = stack(tl.t(x), caches=stack.gen_cache(b, 10))
        _, caches_p = stack(tl.t(x[:, :c]), caches=stack.gen_cache(b, 10))
        pre = [cache[:, :, :, :c] for cache in caches_p]
        out_b, caches_b = stack(tl.t(x[:, c:]), caches=stack.gen_cache(b, 10),
                                pre_caches=pre)
    np.testing.assert_allclose(out_b.numpy(), out_a[:, c:].numpy(),
                               **DECODE_TOL)
    np.testing.assert_allclose(caches_b[0][:, :, :, :c + s].numpy(),
                               caches_a[0][:, :, :, :c + s].numpy(),
                               **DECODE_TOL)


def test_validation_no_cache_and_time_step_bound():
    """test_decoding.py:99-123 and :217-228: decode needs caches and one
    token; the no-cache path returns a bare tensor; a ``time_step`` past
    the cache is refused."""
    _, stack = _stacks()
    x = torch.randn(1, 2, 32)
    with pytest.raises(ValueError, match="time_step requires cache_kvs"):
        stack(x, time_step=_ts(0))
    with pytest.raises(ValueError, match="seq_len 1"):
        stack(x, caches=stack.gen_cache(1, 4), time_step=_ts(0))
    with torch.no_grad():
        y = stack(torch.randn(1, 4, 32))
        assert isinstance(y, torch.Tensor) and y.shape == (1, 4, 32)
        caches = stack.gen_cache(1, 4)
        one = torch.randn(1, 1, 32)
        _, caches = stack(one, caches=caches, time_step=_ts(3))
        _, caches = stack(one, caches=caches, time_step=3)
        with pytest.raises(ValueError, match="out of range"):
            stack(one, caches=caches, time_step=_ts(4))


def test_decode_honors_attn_mask():
    """test_decoding.py:231-246: a -1e9 additive mask over a cache slot
    changes the decode step, as the reference's does."""
    j, stack = _stacks(seed=13)
    x = _x(1, 3, 32)
    m = np.zeros((1, 1, 1, 4), "float32")
    m[..., 0] = -1e9
    with torch.no_grad():
        _, caches = stack(tl.t(x[:, :2]), caches=stack.gen_cache(1, 4))
        plain, _ = stack(tl.t(x[:, 2:3]), caches=caches, time_step=_ts(2))
        masked, _ = stack(tl.t(x[:, 2:3]), caches=caches, time_step=_ts(2),
                          attn_mask=tl.t(m))
    assert not np.allclose(plain.numpy(), masked.numpy())
    with jautograd.no_grad():
        _, jc = j(tl.jtensor(x[:, :2]), caches=j.gen_cache(1, 4))
        jmasked, _ = j(tl.jtensor(x[:, 2:3]), caches=jc, time_step=_jts(2),
                       attn_mask=tl.jtensor(m))
    tl.close_to_scale(masked.numpy(), np.asarray(jmasked._value), REL)


def test_nranks_refused_by_name():
    """test_decoding.py:269: the reference refuses ``nranks > 1``; the
    port names the queue item that owns it."""
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        FusedMultiTransformer(16, 2, 32, num_layers=1, nranks=4,
                              device="cpu")
    with pytest.raises(ValueError, match="pre-LN"):
        FusedMultiTransformer(16, 2, 32, normalize_before=False,
                              device="cpu")


def test_trans_qkvw_false_and_state_dict_round_trip():
    """test_decoding.py:497-530: ``trans_qkvw=False`` holds ``[M, 3, H,
    D]`` weights and computes what the transposed layout computes; the
    functional form agrees with the reference's on its weight lists; the
    state dict goes back key for key."""
    j, a = _stacks(num_layers=1, embed=16, heads=2, ffn=32, seed=41,
                   trans_qkvw=False)
    assert tuple(a.qkv_weights[0].shape) == (16, 3, 2, 8)
    b = FusedMultiTransformer(16, 2, 32, num_layers=1, device="cpu").eval()
    assert tuple(b.qkv_weights[0].shape) == (3, 2, 8, 16)
    with torch.no_grad():
        for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
            pb.copy_(pa.permute(1, 2, 3, 0) if name.startswith("qkv_w")
                     else pa)
    x = _x(2, 5, 16)
    with torch.no_grad():
        ya, yb = a(tl.t(x)), b(tl.t(x))
    np.testing.assert_allclose(ya.numpy(), yb.numpy(), rtol=1e-5,
                               atol=1e-5)
    with jautograd.no_grad():
        kinds = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
                 "linear_weights", "linear_biases", "ffn_ln_scales",
                 "ffn_ln_biases", "ffn1_weights", "ffn1_biases",
                 "ffn2_weights", "ffn2_biases")
        jfun = JIF.fused_multi_transformer(
            tl.jtensor(x), *(list(getattr(j, k)) for k in kinds),
            trans_qkvw=False)
    fun = IF.fused_multi_transformer(
        tl.t(x), *(list(getattr(a, k)) for k in kinds), trans_qkvw=False)
    tl.close_to_scale(fun.detach().numpy(), np.asarray(jfun._value), REL)
    back = export_paddle_tpu_state_dict(a)
    want = tl.arrays(j)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_gen_cache_and_init():
    stack = FusedMultiTransformer(16, 2, 32, num_layers=3, device="cpu",
                                  dtype=torch.bfloat16)
    caches = stack.gen_cache(2, 7)
    assert len(caches) == 3 and caches[0].shape == (2, 2, 2, 7, 8)
    assert caches[0].dtype == torch.bfloat16 and not caches[0].any()
    from paddle_tpu_torch.nn import init_weights
    init_weights(stack, 0, 0.02)
    assert all(0.01 < float(w.detach().float().std()) < 0.03
               for w in stack.qkv_weights)
    assert all(not b.any() for b in stack.qkv_biases)
    assert all((s == 1).all() for s in stack.ln_scales)


def test_fused_attention_cache_kv_matches_reference():
    """`fused_multi_head_attention(cache_kv=)`: the step's keys and values
    appended to ``[2, B, L, H, D]``; the layer's ``cache=`` is the same
    argument. Post-LN, 2 heads of 16, a 4-token cache, 3 new tokens."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 32)).astype("float32")
    w = (rng.standard_normal((3, 2, 16, 32)) * 0.2).astype("float32")
    lw = (rng.standard_normal((32, 32)) * 0.2).astype("float32")
    bias = rng.standard_normal((3, 2, 16)).astype("float32")
    cache = rng.standard_normal((2, 2, 4, 2, 16)).astype("float32")
    kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0, training=False)
    with jautograd.no_grad():
        want = JIF.fused_multi_head_attention(
            tl.jtensor(x), tl.jtensor(w), tl.jtensor(lw),
            qkv_bias=tl.jtensor(bias), cache_kv=tl.jtensor(cache), **kw)
    got = IF.fused_multi_head_attention(tl.t(x), tl.t(w), tl.t(lw),
                                        qkv_bias=tl.t(bias),
                                        cache_kv=tl.t(cache), **kw)
    tl.close_to_scale(got.numpy(), np.asarray(want._value), REL)
    layer = FusedTransformerEncoderLayer(32, 2, 64, dropout_rate=0.0,
                                         device="cpu").eval()
    with torch.no_grad():
        layer.fused_attn.qkv_weight.copy_(tl.t(w))
        layer.fused_attn.linear_weight.copy_(tl.t(lw))
        layer.ffn.linear1_weight.zero_()
        layer.ffn.linear2_weight.zero_()
        out = layer.fused_attn(tl.t(x), cache=tl.t(cache))
    plain = IF.fused_multi_head_attention(tl.t(x), tl.t(w), tl.t(lw),
                                          qkv_bias=torch.zeros(3, 2, 16),
                                          cache_kv=tl.t(cache), **kw)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=0,
                               atol=1e-6)
