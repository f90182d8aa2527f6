"""The port's decoder side of `nn.transformer` against paddle_tpu's:
`MultiHeadAttention`'s caches and ``need_weights``, the encoder's cache,
`TransformerDecoderLayer`, `TransformerDecoder` and `Transformer`.

Weights come from paddle_tpu's layers built from a seed and load into the
port's (`models.convert`); inputs from numpy seeds. Float32 throughout;
outputs within 1e-5 of their largest |value|, grads within 1e-5 of the
largest |grad| (the key projections' biases have a true gradient of 0,
so their round-off is held at that scale).

- `Transformer` at S=128 runs attention in the flash branches on both
  sides: the reference's Pallas kernels in interpret mode with their
  gates open, the port's plain versions (the encoder's self-attention in
  the qkv-direct branch, the decoder's causal self-attention under
  `generate_square_subsequent_mask`'s -inf bias and its cross-attention
  in the general one);
- incremental decode: `TransformerDecoder.gen_cache` (a `Cache` and a
  `StaticCache` a layer) fed one token a step gives the full causal
  forward's rows, in the port and in the reference alike.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import kernels as jkernels
from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as pF
from paddle_tpu_torch.nn import transformer as ptr

import _torch_layers as tl

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

REL = 1e-5
B, E, H = 2, 32, 4


@pytest.fixture
def pallas_interpret(monkeypatch):
    """paddle_tpu's Pallas kernels in interpret mode with their gates
    open (the fallback counters reset before and after)."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    monkeypatch.setattr(jkernels, "pallas_available", lambda: True)
    jkernels.reset_kernel_fallback_counters()
    yield
    jkernels.reset_kernel_fallback_counters()


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        "float32")


def _j(module, *args, **kw):
    """The reference module's call under no_grad, its tensors as numpy
    (nested tuples and namedtuples kept)."""
    with jautograd.no_grad():
        return _np(module(*(tl.jtensor(a) if isinstance(a, np.ndarray)
                            else a for a in args), **kw))


def _np(out):
    if out is None:
        return None
    if isinstance(out, tuple):
        return type(out)(*map(_np, out)) if hasattr(out, "_fields") \
            else tuple(map(_np, out))
    if isinstance(out, list):
        return [_np(o) for o in out]
    return np.asarray(out._value) if hasattr(out, "_value") \
        else out.detach().numpy()


def _pair(jcls, pcls, *args, seed=1, **kw):
    paddle_tpu.seed(seed)
    jmod = jcls(*args, **kw)
    jmod.eval()
    return jmod, tl.port_of(jmod, pcls(*args, **kw, device="cpu"))


def _nested_close(got, want):
    if want is None:
        assert got is None
    elif isinstance(want, (tuple, list)):
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _nested_close(g, w)
    else:
        tl.close_to_scale(got, want, REL)


def test_mha_need_weights_caches_and_compute_kv():
    jmha, mha = _pair(jnn.MultiHeadAttention, pnn.MultiHeadAttention, E, H,
                      need_weights=True)
    q, mem = _x(B, 3, E), _x(B, 5, E, seed=1)
    got = _np(mha(tl.t(q)))
    assert len(got) == 2 and got[1] is None
    _nested_close(got, _j(jmha, q))
    jmha.need_weights = mha.need_weights = False
    # a StaticCache over the memory: (out, the same cache)
    jst = jmha.gen_cache(tl.jtensor(mem), tl.jtensor(mem),
                         type=jmha.StaticCache)
    st = mha.gen_cache(tl.t(mem), tl.t(mem), type=mha.StaticCache)
    _nested_close(_np(st), _np(jst))
    _nested_close(_np(mha(tl.t(q), tl.t(mem), tl.t(mem), cache=st)),
                  _j(jmha, q, mem, mem, cache=jst))
    _nested_close(_np(mha.compute_kv(tl.t(mem), tl.t(mem))),
                  _np(jmha.compute_kv(tl.jtensor(mem), tl.jtensor(mem))))
    # an empty Cache grows a step at a time; one given as (k, v) is kept
    jc, c = jmha.gen_cache(tl.jtensor(q)), mha.gen_cache(tl.t(q))
    assert tuple(c.k.shape) == (B, 0, H, E // H) and c.k.dtype == \
        torch.float32
    for i in range(3):
        step = q[:, i:i + 1]
        got = mha(tl.t(step), cache=c)
        with jautograd.no_grad():
            want = jmha(tl.jtensor(step), cache=jc)
        _nested_close(_np(got), _np(want))
        c, jc = got[1], want[1]
    assert tuple(c.k.shape) == (B, 3, H, E // H)
    given = mha.gen_cache(c.k, c.v)
    assert isinstance(given, mha.Cache) and given.k is c.k


def test_pre_ln_decoder_layer_matches_reference():
    """The pre-LN layer (the post-LN one runs in the Transformer test)
    under a causal -inf mask and a bool memory mask."""
    jlayer, layer = _pair(jnn.TransformerDecoderLayer,
                          pnn.TransformerDecoderLayer, E, H, 64,
                          dropout=0.0, normalize_before=True)
    tgt, mem = _x(B, 6, E), _x(B, 7, E, seed=1)
    causal = np.triu(np.full((6, 6), -np.inf, "float32"), 1)
    mem_mask = np.ones((B, 1, 6, 7), bool)
    mem_mask[1, :, :, 5:] = False
    want = tl.jax_loss_grads(jlayer, lambda o: (o ** 2).mean(),
                             tl.jtensor(tgt), tl.jtensor(mem),
                             tgt_mask=tl.jtensor(causal),
                             memory_mask=tl.jtensor(mem_mask))
    got = tl.torch_loss_grads(layer, lambda o: (o ** 2).mean(), tl.t(tgt),
                              tl.t(mem), tgt_mask=tl.t(causal),
                              memory_mask=tl.t(mem_mask))
    tl.close_to_scale(got[1], want[1], REL)
    tl.grads_close(got[2], want[2], REL)


def test_transformer_at_128_through_the_flash_branches(pallas_interpret,
                                                       monkeypatch):
    """d_model 128 (2 heads of 64), one encoder and one decoder layer,
    src 256 and tgt 128 tokens: the encoder's self-attention takes the
    qkv-direct branch, the decoder's two attentions the general flash
    branch (the causal one under the -inf mask), on both sides."""
    paddle_tpu.seed(3)
    jtr = jnn.Transformer(128, 2, 1, 1, 256, dropout=0.0)
    jtr.eval()
    tr = tl.port_of(jtr, pnn.Transformer(128, 2, 1, 1, 256, dropout=0.0,
                                         device="cpu"))
    mask = tr.generate_square_subsequent_mask(128)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jtr.generate_square_subsequent_mask(128)
                                 ._value))
    assert np.isneginf(mask.numpy()[0, 1]) and mask.numpy()[1, 1] == 0
    calls = {"flash": 0, "qkv3": 0}
    for mod, name, key in ((pF, "flash_attention", "flash"),
                           (ptr, "flash_attention_qkv3", "qkv3")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _k=key, **k:
                            calls.__setitem__(_k, calls[_k] + 1)
                            or _r(*a, **k))
    src, tgt = _x(B, 256, 128), _x(B, 128, 128, seed=1)
    # a random projection of the output: the mean square of the final
    # LayerNorm's output is 1 whatever the weights, so its gradients
    # would be round-off
    w = _x(B, 128, 128, seed=2)
    want = tl.jax_loss_grads(jtr, lambda o: (o * w).mean(),
                             tl.jtensor(src), tl.jtensor(tgt),
                             tgt_mask=tl.jtensor(mask.numpy()))
    got = tl.torch_loss_grads(tr, lambda o: (o * tl.t(w)).mean(), tl.t(src),
                              tl.t(tgt), tgt_mask=mask)
    assert jkernels.kernel_fallback_counters() == {}
    assert calls == {"flash": 2, "qkv3": 1}
    assert np.isfinite(got[1]).all()
    tl.close_to_scale(got[1], want[1], REL)
    tl.grads_close(got[2], want[2], REL)


def test_incremental_decode_matches_the_full_forward():
    """Two post-LN decoder layers: `gen_cache` then one token a step gives
    the full causal forward's rows (float32, 1e-5 of their scale); the
    reference's incremental steps give the same rows."""
    jdec, dec = _pair(
        lambda *a, **k: jnn.TransformerDecoder(
            jnn.TransformerDecoderLayer(*a, **k), 2),
        lambda *a, device, **k: pnn.TransformerDecoder(
            pnn.TransformerDecoderLayer(*a, device=device, **k), 2),
        E, H, 64, dropout=0.0)
    tgt, mem = _x(B, 8, E), _x(B, 5, E, seed=1)
    causal = np.triu(np.full((8, 8), -np.inf, "float32"), 1)
    with torch.no_grad():
        full = dec(tl.t(tgt), tl.t(mem), tgt_mask=tl.t(causal)).numpy()
        cache = dec.gen_cache(tl.t(mem))
        assert [type(c).__name__ for c in cache[0]] == ["Cache",
                                                        "StaticCache"]
        rows = []
        for i in range(8):
            out, cache = dec(tl.t(tgt[:, i:i + 1]), tl.t(mem), cache=cache)
            rows.append(out.numpy())
    tl.close_to_scale(np.concatenate(rows, 1), full, REL)
    jcache = jdec.gen_cache(tl.jtensor(mem))
    jrows = []
    with jautograd.no_grad():
        for i in range(8):
            out, jcache = jdec(tl.jtensor(tgt[:, i:i + 1]), tl.jtensor(mem),
                               cache=jcache)
            jrows.append(np.asarray(out._value))
    tl.close_to_scale(np.concatenate(rows, 1), np.concatenate(jrows, 1), REL)
    zipped = dec.gen_cache(tl.t(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


def test_encoder_with_cache_matches_reference():
    """A pre-LN `TransformerEncoder` (final LayerNorm) with its
    incremental caches, two steps of three tokens, against the
    reference's."""
    jenc, enc = _pair(
        lambda *a, **k: jnn.TransformerEncoder(
            jnn.TransformerEncoderLayer(*a, **k), 2, jnn.LayerNorm(E)),
        lambda *a, device, **k: pnn.TransformerEncoder(
            pnn.TransformerEncoderLayer(*a, device=device, **k), 2,
            pnn.LayerNorm(E, device=device)),
        E, H, 64, dropout=0.0, normalize_before=True)
    src = _x(B, 6, E)
    cache, jcache = enc.gen_cache(tl.t(src)), jenc.gen_cache(tl.jtensor(src))
    for i in (0, 3):
        with torch.no_grad():
            out, cache = enc(tl.t(src[:, i:i + 3]), cache=cache)
        with jautograd.no_grad():
            jout, jcache = jenc(tl.jtensor(src[:, i:i + 3]), cache=jcache)
        tl.close_to_scale(out.numpy(), np.asarray(jout._value), REL)
        _nested_close(_np(cache), _np(jcache))
    tl.close_to_scale(_np(enc(tl.t(src))), _j(jenc, src), REL)
