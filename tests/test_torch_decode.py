"""The port's beam search (`nn.BeamSearchDecoder`, `nn.dynamic_decode`)
and `nn.functional.gather_tree` against paddle_tpu's, with the same
weights (`models.load_layer_state_dict`) and numpy inputs.

Each decode's ids and lengths are equal to the reference's and its
log-probs within ATOL (1e-4; sums of up to 8 float32 log-softmax values
of order 3). The reference's cell runs under one ``jax.jit`` a step (op
by op, its every growing cache shape compiles each op anew); the
reference models are built once for the module.

- an `LSTMCell` decoder (embedding, cell, output projection) over 8
  steps, batch-major and ``output_time_major``;
- the same decoder whose output bias favours the end token: every beam
  finishes before ``max_step_num`` and the loop stops early (lengths
  below the steps run);
- ties: an output projection of zeros makes every candidate of a row
  equal, and both packages keep the lowest flat indices (``lax.top_k``'s
  order; the port's stable sort), the -1e9 starts of the dead beams
  included;
- a 2-layer `TransformerDecoder` with its caches (`gen_cache`: a
  `Cache` and a `StaticCache` a layer, tiled and reordered with the
  beams), one query a step from an encoder memory, over 3 steps;
- `gather_tree` on random parents, `tile_beam_merge_with_batch`, and
  the reordering of a state tree with a leaf that is not ``B * k``
  long.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit.api import functional_call as jfunctional_call
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import decode as pdecode
from paddle_tpu_torch.nn import functional as F

import _torch_fns as tf

ATOL = 1e-4
B, V, E, H, K = 2, 12, 8, 8, 3
D_MODEL, HEADS, FFN, S = 16, 2, 32, 5


class _JStep(jnn.Layer):
    def __init__(self, inner, call):
        super().__init__()
        self.inner = inner
        self._call = call

    def forward(self, x, states):
        return self._call(self.inner, x, states)


def _jitted_cell(jlayer, call):
    """``call(jlayer, x, states) -> (y, states)`` of the reference under
    one ``jax.jit`` an input shape, on ``jlayer``'s parameters."""
    step = _JStep(jlayer, call)
    params = {n: p._value for n, p in step.named_parameters()}

    def raw(p, x, states):
        with jautograd.no_grad():
            return jfunctional_call(step, p, x, states)

    jraw = jax.jit(raw)
    return lambda x, states: jraw(params, x, states)


def _decode_both(jparts, pparts, jinits, pinits, steps, end=V - 1, **kw):
    """Both packages' ``dynamic_decode`` of ``(cell, embedding, output)``
    from their inits: ``(ids, log_probs, lengths)`` as numpy, each."""
    jcell, jemb, jout = jparts
    pcell, pemb, pout = pparts
    jdec = jnn.BeamSearchDecoder(jcell, 0, end, K, embedding_fn=jemb,
                                 output_fn=jout)
    with jautograd.no_grad():
        want = jnn.dynamic_decode(jdec, inits=jinits, max_step_num=steps,
                                  return_length=True, **kw)
    pdec = pnn.BeamSearchDecoder(pcell, 0, end, K, embedding_fn=pemb,
                                 output_fn=pout)
    with torch.no_grad():
        got = pnn.dynamic_decode(pdec, inits=pinits, max_step_num=steps,
                                 return_length=True, **kw)
    return ([np.asarray(t._value) for t in want],
            [t.numpy() for t in got])


def _held(want, got):
    (wi, wl, wn), (gi, gl, gn) = want, got
    assert gi.dtype == np.int64 and gn.dtype == np.int32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_allclose(gl, wl, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def lstm():
    """The reference's LSTM decoder parts and the port's twins."""
    with tf.state_kept():
        jparts = [jnn.LSTMCell(E, H), jnn.Embedding(V, E), jnn.Linear(H, V)]
        pparts = [tf.twin(jparts[0], lambda: pnn.LSTMCell(E, H,
                                                          device="cpu")),
                  tf.twin(jparts[1], lambda: pnn.Embedding(V, E,
                                                           device="cpu")),
                  tf.twin(jparts[2], lambda: pnn.Linear(H, V,
                                                        device="cpu"))]
    jparts[0] = _jitted_cell(jparts[0], lambda c, x, s: c(x, s))
    h0 = [tf.randn((B, H), 1 + i) for i in range(2)]
    inits = (tuple(JTensor(jnp.asarray(h)) for h in h0),
             tuple(torch.from_numpy(h) for h in h0))
    return jparts, pparts, inits


@pytest.mark.parametrize("time_major", [False, True])
def test_lstm_cell_decoder(lstm, time_major):
    jparts, pparts, (jinits, pinits) = lstm
    want, got = _decode_both(jparts, pparts, jinits, pinits, 8,
                             output_time_major=time_major)
    assert got[0].shape == ((8, B, K) if time_major else (B, 8, K))
    _held(want, got)


def test_decode_that_finishes_early(lstm):
    jparts, pparts, (jinits, pinits) = lstm
    end = 5
    jout, pout = jnn.Linear(H, V), pnn.Linear(H, V, device="cpu")
    bias = np.zeros(V, np.float32)
    bias[end] = 3.0
    jout.weight._value = jnp.asarray(jparts[2].weight._value)
    jout.bias._value = jnp.asarray(bias)
    with torch.no_grad():
        pout.weight.copy_(pparts[2].weight)
        pout.bias.copy_(torch.from_numpy(bias))
    want, got = _decode_both([jparts[0], jparts[1], jout],
                             [pparts[0], pparts[1], pout], jinits, pinits,
                             20, end=end)
    _held(want, got)
    steps = got[0].shape[1]
    assert steps < 20 and (got[2] < steps).any()
    assert (got[0][:, -1, :] == end).all()


def test_ties_keep_the_lowest_indices(lstm):
    jparts, pparts, (jinits, pinits) = lstm
    jout, pout = jnn.Linear(H, V), pnn.Linear(H, V, device="cpu")
    jout.weight._value = jnp.zeros((H, V))
    jout.bias._value = jnp.zeros((V,))
    with torch.no_grad():
        pout.weight.zero_()
        pout.bias.zero_()
    want, got = _decode_both([jparts[0], jparts[1], jout],
                             [pparts[0], pparts[1], pout], jinits, pinits, 4)
    _held(want, got)
    # each step keeps beam 0's tokens 0..K-1 (the lowest flat indices):
    # every beam descends from beam 0, whose token was 0
    want_ids = np.zeros((B, 4, K), np.int64)
    want_ids[:, -1] = np.arange(K)
    np.testing.assert_array_equal(got[0], want_ids)


def _transformer_cell(decoder):
    def cell(x, states):
        memory, cache = states
        y, cache = decoder(x.reshape([x.shape[0], 1, x.shape[1]]), memory,
                           cache=cache)
        return y.reshape([y.shape[0], y.shape[2]]), (memory, cache)
    return cell


def test_transformer_decoder_with_caches():
    with tf.state_kept():
        jdec = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
            D_MODEL, HEADS, FFN, dropout=0.0), 2)
        jemb, jout = jnn.Embedding(V, D_MODEL), jnn.Linear(D_MODEL, V)
        pdec = tf.twin(jdec, lambda: pnn.TransformerDecoder(
            pnn.TransformerDecoderLayer(D_MODEL, HEADS, FFN, dropout=0.0,
                                        device="cpu"), 2))
        pemb = tf.twin(jemb, lambda: pnn.Embedding(V, D_MODEL, device="cpu"))
        pout = tf.twin(jout, lambda: pnn.Linear(D_MODEL, V, device="cpu"))
    jdec.eval()
    pdec.eval()
    mem = tf.randn((B, S, D_MODEL), 3)
    jmem, pmem = JTensor(jnp.asarray(mem)), torch.from_numpy(mem)
    jstep = _jitted_cell(jdec, lambda d, x, s: d(x, s[0], cache=s[1]))
    jcell = _transformer_cell(lambda x, m, cache: jstep(x, (m, cache)))
    pcell = _transformer_cell(pdec)
    want, got = _decode_both(
        [jcell, jemb, jout], [pcell, pemb, pout],
        (jmem, jdec.gen_cache(jmem)), (pmem, pdec.gen_cache(pmem)), 3)
    _held(want, got)


def test_gather_tree():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, V, (6, B, K)).astype(np.int64)
    parents = rng.integers(0, K, (6, B, K)).astype(np.int64)
    want = JF.gather_tree(JTensor(jnp.asarray(ids)),
                          JTensor(jnp.asarray(parents)))
    got = F.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._value))


def test_tile_and_reorder():
    x = torch.arange(6).reshape(2, 3)
    tiled = pnn.BeamSearchDecoder.tile_beam_merge_with_batch(x, 2)
    assert tiled.tolist() == [[0, 1, 2], [0, 1, 2], [3, 4, 5], [3, 4, 5]]
    parent = torch.tensor([[1, 1], [0, 1]])
    beams = torch.arange(4)[:, None].float()
    state = {"beams": beams, "other": torch.zeros(3), "scalar": torch.ones(())}
    out = torch.utils._pytree.tree_map(
        lambda s: pdecode._reorder_beams(s, parent, 2, 2), state)
    assert out["beams"][:, 0].tolist() == [1.0, 1.0, 2.0, 3.0]
    assert out["other"] is state["other"] and out["scalar"] is state["scalar"]
