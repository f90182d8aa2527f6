"""The port's recurrent layers (`nn.rnn`) against paddle_tpu's, on the
same numpy inputs, with the reference's weights carried across by
`models.load_layer_state_dict`.

Each case runs forward and backward: every output and final state, the
grads of ``sum_i sum(leaf_i * r_i)`` over the parameters and the input,
within REL (2e-5) of each tensor's largest |value| (float32; the fused
op sums the gate products in another order, and errors grow through
the steps). Covered:

- every cell (`SimpleRNNCell` tanh and relu, `LSTMCell`, `GRUCell`)
  for one step with and without states given, and over each `RNN`
  and a time-major `BiRNN` (its backward half the reversed loop), with
  ``sequence_length`` (frozen states, unmasked outputs);
- `SimpleRNN` (tanh, relu), `LSTM` and `GRU` at 2 layers, forward and
  bidirectional: ``time_major`` with initial states;
  ``bias_*_attr=False`` with ``sequence_length`` (unsorted lengths,
  one row of length 0: zero outputs past a row's length, its state
  frozen, ``h_n`` in the caller's row order). The reference's stacks
  fail without biases (a None bias enters their scan), so there the
  reference runs with biases drawn as zeros and holds every grad but
  theirs;
- the gate orders: the fused `LSTM` and `GRU` equal the cells' own
  formulas run step by step (`RNN` over the cell);
- dropout: at p=0 in training (batch-major, no states given) the
  reference's pass; at p>0 the stack
  runs a fused call a layer with `functional.dropout` between, which,
  with the dropout made the identity, gives the reference's pass at
  p=0, and whose masks come from the port's generator (the same seed,
  the same output bit for bit; another seed, another output).
"""
import numpy as np
import pytest
import torch

from paddle_tpu import ParamAttr as JParamAttr
from paddle_tpu import nn as jnn
from paddle_tpu.nn.initializer import Constant as JConstant
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import load_layer_state_dict
from paddle_tpu_torch.core.random import rng_guard, step_generator
from paddle_tpu_torch.nn import rnn as prnn

import _torch_fns as tf

REL = 2e-5
B, T, I, H = 3, 6, 5, 4
LENGTHS = np.array([4, 6, 0], np.int64)


@pytest.fixture(autouse=True)
def _state_kept():
    with tf.state_kept():
        yield


def _x(*shape, seed=0):
    return tf.randn(shape, seed)


def _pair(jcls, pcls, *args, **kw):
    jlayer = jcls(*args, **kw)
    return jlayer, tf.twin(jlayer, lambda: pcls(*args, **kw, device="cpu"))


CELLS = {
    "simple_tanh": ("SimpleRNNCell", {}),
    "simple_relu": ("SimpleRNNCell", {"activation": "relu"}),
    "lstm": ("LSTMCell", {}),
    "gru": ("GRUCell", {}),
}


def _states(name, seed):
    h = _x(B, H, seed=seed)
    return (h, _x(B, H, seed=seed + 1)) if name == "lstm" else h


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_step(cell, given):
    cls, kw = CELLS[cell]
    j, p = _pair(getattr(jnn, cls), getattr(pnn, cls), I, H, **kw)
    extra = {"states": _states(cell, 3)} if given else {}
    tf.step_held(tf.port_layer_step(p, None, [_x(B, I)], False, extra),
                 tf.ref_layer_step(j, None, [_x(B, I)], False, extra), REL,
                 cell)
    init = p.get_initial_states(torch.zeros(B, I))
    shapes = [tuple(t.shape) for t in tf.pleaves(init)]
    assert shapes == [(B, H)] * len(p.state_shape)


@pytest.mark.parametrize("cell", list(CELLS))
def test_rnn_and_birnn_over_each_cell(cell):
    cls, kw = CELLS[cell]
    jcells = [getattr(jnn, cls)(I, H, **kw) for _ in range(3)]
    pcells = [tf.twin(jc, lambda: getattr(pnn, cls)(I, H, **kw,
                                                     device="cpu"))
              for jc in jcells]
    x = _x(B, T, I)
    seq = {"sequence_length": LENGTHS}
    tf.step_held(tf.port_layer_step(pnn.RNN(pcells[0]), None, [x], False,
                                    seq),
                 tf.ref_layer_step(jnn.RNN(jcells[0]), None, [x], False,
                                   seq), REL, f"RNN {cell}")
    xt = np.ascontiguousarray(x.transpose(1, 0, 2))
    tf.step_held(
        tf.port_layer_step(pnn.BiRNN(pcells[1], pcells[2], time_major=True),
                           None, [xt], False, seq),
        tf.ref_layer_step(jnn.BiRNN(jcells[1], jcells[2], time_major=True),
                          None, [xt], False, seq), REL,
        f"time-major BiRNN {cell}")


STACKS = {
    "simple_tanh": ("SimpleRNN", {}),
    "simple_relu": ("SimpleRNN", {"activation": "relu"}),
    "lstm": ("LSTM", {}),
    "gru": ("GRU", {}),
}
VARIANTS = ("time_major_states", "no_bias_lengths")


def _stack_case(stack, direction, variant, **extra_kw):
    cls, kw = STACKS[stack]
    kw = dict(kw, num_layers=2, direction=direction, **extra_kw)
    nd = 1 if direction == "forward" else 2
    x, call = _x(B, T, I), {}
    if variant == "time_major_states":
        kw["time_major"] = True
        x = np.ascontiguousarray(x.transpose(1, 0, 2))
        h0 = _x(2 * nd, B, H, seed=5)
        call["initial_states"] = ((h0, _x(2 * nd, B, H, seed=6))
                                  if stack == "lstm" else h0)
    elif variant == "no_bias_lengths":
        call["sequence_length"] = LENGTHS
        zero = JParamAttr(initializer=JConstant(0.0))
        j = getattr(jnn, cls)(I, H, **kw, bias_ih_attr=zero,
                              bias_hh_attr=zero)
        with rng_guard(step_generator(0, "cpu")):
            p = getattr(pnn, cls)(I, H, **kw, bias_ih_attr=False,
                                  bias_hh_attr=False, device="cpu")
        load_layer_state_dict(p, {n: a for n, a in tf.tl.arrays(j).items()
                                  if "bias" not in n})
        return j, p, x, call
    j, p = _pair(getattr(jnn, cls), getattr(pnn, cls), I, H, **kw)
    return j, p, x, call


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("stack", list(STACKS))
def test_stack(stack, direction, variant):
    j, p, x, call = _stack_case(stack, direction, variant)
    got = tf.port_layer_step(p, None, [x], False, call)
    tf.step_held(got, tf.ref_layer_step(j, None, [x], False, call), REL,
                 f"{stack} {direction} {variant}", names=p)
    if variant == "no_bias_lengths":
        out = got[1][0]
        for row, n in enumerate(LENGTHS):
            assert not out[row, n:].any(), (row, "output past its length")
        assert not [n for n, _ in p.named_parameters() if "bias" in n]


@pytest.mark.parametrize("stack", ["lstm", "gru"])
def test_fused_stack_is_the_cells_formulas(stack):
    """The fused op's gate order and update rule are the cells': a
    1-layer stack against `RNN` over the cell with the same weights."""
    cls, cell_cls = {"lstm": ("LSTM", "LSTMCell"),
                     "gru": ("GRU", "GRUCell")}[stack]
    with rng_guard(step_generator(3, "cpu")):
        fused = getattr(pnn, cls)(I, H, device="cpu")
        cell = getattr(pnn, cell_cls)(I, H, device="cpu")
    with torch.no_grad():
        for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            getattr(cell, n).copy_(getattr(fused, f"{n}_l0"))
    x = torch.from_numpy(_x(B, T, I))
    y, h = fused(x)
    y2, h2 = pnn.RNN(cell)(x)
    torch.testing.assert_close(y, y2, rtol=0, atol=1e-6)
    for a, b in zip(tf.pleaves(h), tf.pleaves(h2)):
        torch.testing.assert_close(a[0], b, rtol=0, atol=1e-6)


def test_dropout_zero_in_training_is_the_eval_pass():
    j, p, x, call = _stack_case("lstm", "bidirect", "plain", dropout=0.0)
    tf.step_held(tf.port_layer_step(p, None, [x], True, call),
                 tf.ref_layer_step(j, None, [x], False, call), REL,
                 "dropout 0")


@pytest.mark.parametrize("stack", ["lstm", "gru"])
def test_dropout_runs_a_layer_at_a_time(stack, monkeypatch):
    """At p > 0 in training, each layer is one fused call with the
    port's dropout between: with that dropout the identity, the
    reference's pass at p = 0 (bidirectional, with lengths)."""
    calls = []
    real = prnn._RNNBase._fused

    def counted(self, *args):
        calls.append(args[3])                      # layers in the call
        return real(self, *args)

    monkeypatch.setattr(prnn._RNNBase, "_fused", counted)
    monkeypatch.setattr(prnn.F, "dropout", lambda x, p, training: x)
    j, p, x, call = _stack_case(stack, "bidirect", "no_bias_lengths")
    p.dropout = 0.5
    got = tf.port_layer_step(p, None, [x], True, call)
    assert calls == [1, 1]
    tf.step_held(got, tf.ref_layer_step(j, None, [x], False, call), REL,
                 "a layer at a time", names=p)


def test_dropout_masks_come_from_the_port_generator():
    with rng_guard(step_generator(0, "cpu")):
        p = pnn.LSTM(I, H, num_layers=3, dropout=0.5, device="cpu")
    x = torch.from_numpy(_x(B, T, I))

    def run(seed):
        with rng_guard(step_generator(seed, "cpu")), torch.no_grad():
            return p(x)[0]

    p.train()
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    p.eval()
    with torch.no_grad():
        want = p(x)[0]
    assert torch.equal(run(1), want)


def test_direction_and_activation_are_checked():
    with pytest.raises(ValueError):
        pnn.LSTM(I, H, direction="backward", device="cpu")
    with pytest.raises(ValueError):
        pnn.SimpleRNN(I, H, activation="gelu", device="cpu")
