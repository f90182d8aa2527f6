"""Recurrent layers: the cells (`SimpleRNNCell`, `LSTMCell`, `GRUCell`
on `RNNCellBase`), `RNN` and `BiRNN` over any cell, and the stacks
`SimpleRNN`, `LSTM` and `GRU`.

Counterpart: ``paddle_tpu/nn/rnn.py``. Weights keep the reference's
layout and gate orders, which are PyTorch's own: ``weight_ih [G*H, I]``,
``weight_hh [G*H, H]``, LSTM gates i, f, g, o (``:129-138``), GRU gates
r, z, c with the reset applied to the hidden product and ``h' = z*h +
(1-z)*c`` (``:179-188``). Every weight and bias is drawn ``U(-1/sqrt(H),
1/sqrt(H))`` unless its attr says otherwise (``:27-30``);
``bias_*_attr=False`` leaves a bias out (the math then adds none).

- The cells compute one step from their formulas. ``get_initial_states``
  fills ``state_shape`` for the batch; with no ``dtype`` the states take
  the input's floating dtype (the reference's are float32 whatever the
  input: the same on float32 inputs).
- `RNN` runs a cell step by step (``:238-270``). Past a row's
  ``sequence_length`` its state freezes (``_freeze_states``); its outputs
  there stay as the cell gave them.
- The stacks (``:289-447``) name their parameters
  ``weight_ih_l{n}[_reverse]``, ``weight_hh_...``, ``bias_ih_...`` and
  ``bias_hh_...``. Each runs as PyTorch's fused recurrent op, the one
  ``torch.nn.LSTM`` calls (``torch._VF.lstm``/``gru``/``rnn_tanh``/
  ``rnn_relu``: cuDNN on a card), the counterpart of the reference's
  compiled scan. With ``sequence_length`` the op runs on the packed
  sequence, so that past a row's length its state freezes and its
  outputs are zero (the reference's masked scan, ``:339-343``), and the
  reverse direction starts at the row's own last step; ``h_n`` comes
  back in the caller's row order. A row of length 0 keeps its initial
  state and zero outputs. Between layers, in training, dropout runs
  through `functional.dropout` (the port's generator, not cuDNN's
  state): the stack then runs one fused call a layer. The initial
  states default to zeros of the input's dtype. The separate weight
  tensors are handed to the op as a list; on a card cuDNN copies them
  into one buffer on every call. Nothing falls back: an input the fused
  op refuses raises.
"""
from __future__ import annotations

import math

import torch
from torch import _VF
from torch.nn.utils import rnn as _packing

from . import functional as F
from .functional.common import _torch_dtype
from .initializer import Uniform
from .layer import Layer


def _std_init(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return Uniform(-k, k)


def _affine(x, w, b):
    y = x @ w.T
    return y if b is None else y + b


def _check_activation(activation):
    if activation not in ("tanh", "relu"):
        raise ValueError(f"Unknown activation {activation!r} "
                         f"(supported: tanh, relu)")


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        b = int(batch_ref.shape[batch_dim_idx])
        if dtype is not None:
            dt = _torch_dtype(dtype)
        elif batch_ref.is_floating_point():
            dt = batch_ref.dtype
        else:
            dt = torch.float32
        shapes = (self.state_shape if shape is None
                  else (shape if isinstance(shape[0], (tuple, list))
                        else (shape,)))
        states = tuple(torch.full((b,) + tuple(s), init_value, dtype=dt,
                                  device=batch_ref.device) for s in shapes)
        return states if len(states) > 1 else states[0]

    def _create_weights(self, gates, input_size, hidden_size, attrs):
        w_ih, w_hh, b_ih, b_hh = attrs
        init = _std_init(hidden_size)
        n = gates * hidden_size
        self.weight_ih = self.create_parameter(
            [n, input_size], attr=w_ih, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [n, hidden_size], attr=w_hh, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [n], attr=b_ih, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [n], attr=b_hh, is_bias=True, default_initializer=init)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        _check_activation(activation)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        self._create_weights(1, input_size, hidden_size,
                             (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                              bias_hh_attr))

    @staticmethod
    def _step(act, x, h, w_ih, w_hh, b_ih, b_hh):
        z = _affine(x, w_ih, b_ih) + _affine(h, w_hh, b_hh)
        return torch.tanh(z) if act == "tanh" else torch.relu(z)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = self._step(self.activation, inputs, states, self.weight_ih,
                         self.weight_hh, self.bias_ih, self.bias_hh)
        return out, out

    @property
    def state_shape(self):
        return ((self.hidden_size,),)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._create_weights(4, input_size, hidden_size,
                             (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                              bias_hh_attr))

    @staticmethod
    def _step(x, h, c, w_ih, w_hh, b_ih, b_hh):
        gates = _affine(x, w_ih, b_ih) + _affine(h, w_hh, b_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(new_c), new_c

    def forward(self, inputs, states=None):
        h, c = self.get_initial_states(inputs) if states is None else states
        new_h, new_c = self._step(inputs, h, c, self.weight_ih,
                                  self.weight_hh, self.bias_ih, self.bias_hh)
        return new_h, (new_h, new_c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._create_weights(3, input_size, hidden_size,
                             (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                              bias_hh_attr))

    @staticmethod
    def _step(x, h, w_ih, w_hh, b_ih, b_hh):
        xr, xz, xc = _affine(x, w_ih, b_ih).chunk(3, dim=-1)
        hr, hz, hc = _affine(h, w_hh, b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        c = torch.tanh(xc + r * hc)
        return z * h + (1.0 - z) * c

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        new_h = self._step(inputs, states, self.weight_ih, self.weight_hh,
                           self.bias_ih, self.bias_hh)
        return new_h, new_h

    @property
    def state_shape(self):
        return ((self.hidden_size,),)


def _step_mask(sequence_length, steps, device):
    """``[B, T]`` float mask, 1 where ``t < length``."""
    seq = torch.as_tensor(sequence_length, device=device).long()
    return (torch.arange(steps, device=device)[None, :]
            < seq[:, None]).float()


def _freeze_states(new, old, m):
    """``m*new + (1-m)*old`` over a nested state (the reference's
    ``_maybe_copy`` step rule); ``old`` None means zeros."""
    if isinstance(new, (tuple, list)):
        olds = old if old is not None else [None] * len(new)
        return type(new)(_freeze_states(n, o, m) for n, o in zip(new, olds))
    mv = m.to(new.dtype)
    if old is None:
        return new * mv
    return new * mv + old * (1.0 - mv)


class RNN(Layer):
    """Runs ``cell`` step by step over time (forward or reversed)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        t_axis = 0 if self.time_major else 1
        steps = int(inputs.shape[t_axis])
        mask = None
        if sequence_length is not None:
            mask = _step_mask(sequence_length, steps, inputs.device)
        states = initial_states
        if mask is not None and states is None:
            # rows already past their length freeze to the cell's own
            # initial state, made before the loop as the reference does
            x0 = inputs[0] if self.time_major else inputs[:, 0]
            get_init = getattr(self.cell, "get_initial_states", None)
            if get_init is not None:
                states = get_init(x0)
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        outs = []
        for t in order:
            x_t = inputs[t] if self.time_major else inputs[:, t]
            y, new_states = self.cell(x_t, states)
            if mask is not None:
                new_states = _freeze_states(new_states, states,
                                            mask[:, t].unsqueeze(-1))
            states = new_states
            outs.append(y)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=t_axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, s_fw, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, s_bw, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


#: the fused op of each mode and its number of gates
_MODES = {"RNN_TANH": (_VF.rnn_tanh, 1), "RNN_RELU": (_VF.rnn_relu, 1),
          "LSTM": (_VF.lstm, 4), "GRU": (_VF.gru, 3)}


class _RNNBase(Layer):
    """Multi-layer, optionally bidirectional, fused recurrent stack."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction {direction!r}: one of 'forward', "
                             "'bidirect', 'bidirectional'")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirect = direction != "forward"
        self.num_directions = 2 if self.bidirect else 1
        gates = _MODES[mode][1] * hidden_size
        init = _std_init(hidden_size)
        self._weight_names = []
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 \
                else hidden_size * self.num_directions
            for d in range(self.num_directions):
                suffix = f"_l{layer}" + ("_reverse" if d else "")
                names = [f"weight_ih{suffix}", f"weight_hh{suffix}",
                         f"bias_ih{suffix}", f"bias_hh{suffix}"]
                shapes = [[gates, in_dim], [gates, hidden_size], [gates],
                          [gates]]
                attrs = [weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr]
                for i, (n, s, a) in enumerate(zip(names, shapes, attrs)):
                    self.add_parameter(n, self.create_parameter(
                        s, attr=a, is_bias=i >= 2, default_initializer=init))
                self._weight_names.append(names)

    def _flat_weights(self, first, count):
        """The op's weight list for ``count`` (layer, direction) entries
        from ``first``: ``[w_ih, w_hh, b_ih, b_hh]`` each (a missing bias
        as zeros, unless every bias is missing) and whether it has
        biases."""
        entries = [[getattr(self, n) for n in names] for names in
                   self._weight_names[first:first + count]]
        has_biases = any(t is not None for e in entries for t in e[2:])
        flat = []
        for w_ih, w_hh, b_ih, b_hh in entries:
            flat += [w_ih, w_hh]
            if has_biases:
                flat += [b if b is not None else w_ih.new_zeros(w_ih.shape[0])
                         for b in (b_ih, b_hh)]
        return flat, has_biases

    def _fused(self, x, hx, first, num_layers, lengths):
        """One call of the fused op over ``num_layers`` layers from layer
        ``first``: ``x [B, T, I]`` batch-major, ``hx`` the initial
        state(s) ``[L*D, B, H]``, ``lengths`` (CPU int64, or None) the
        rows' lengths. Returns ``(y [B, T, D*H], [h_n(, c_n)])``."""
        op = _MODES[self.mode][0]
        weights, has_biases = self._flat_weights(
            first * self.num_directions, num_layers * self.num_directions)
        lstm = self.mode == "LSTM"
        train = torch.is_grad_enabled()
        if lengths is None:
            out = op(x, tuple(hx) if lstm else hx[0], weights, has_biases,
                     num_layers, 0.0, train, self.bidirect, True)
            return out[0], list(out[1:])
        packed = _packing.pack_padded_sequence(
            x, lengths.clamp(min=1), batch_first=True, enforce_sorted=False)
        order = packed.sorted_indices
        hs = [h.index_select(1, order) for h in hx]
        out = op(packed.data, packed.batch_sizes, tuple(hs) if lstm else hs[0],
                 weights, has_biases, num_layers, 0.0, train, self.bidirect)
        y = _packing.pad_packed_sequence(
            _packing.PackedSequence(out[0], packed.batch_sizes, order,
                                    packed.unsorted_indices),
            batch_first=True, total_length=x.shape[1])[0]
        hn = [h.index_select(1, packed.unsorted_indices) for h in out[1:]]
        empty = lengths == 0
        if bool(empty.any()):           # rows of length 0: h0, zero outputs
            e = empty.to(x.device)
            y = y.masked_fill(e[:, None, None], 0.0)
            hn = [torch.where(e[None, :, None], h0, h)
                  for h0, h in zip(hx, hn)]
        return y, hn

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        b, steps = int(x.shape[0]), int(x.shape[1])
        n_states = self.num_layers * self.num_directions
        lstm = self.mode == "LSTM"
        if initial_states is None:
            zeros = x.new_zeros((n_states, b, self.hidden_size))
            hx = [zeros, zeros] if lstm else [zeros]
        else:
            hx = list(initial_states) if lstm else [initial_states]
        lengths = None
        if sequence_length is not None:
            lengths = torch.as_tensor(sequence_length).to(
                "cpu", torch.int64).clamp(0, steps)
        if self.dropout and self.training and self.num_layers > 1:
            nd = self.num_directions
            outs = [[] for _ in hx]
            for layer in range(self.num_layers):
                part = [h[layer * nd:(layer + 1) * nd] for h in hx]
                x, hn = self._fused(x, part, layer, 1, lengths)
                for o, h in zip(outs, hn):
                    o.append(h)
                if layer < self.num_layers - 1:
                    x = F.dropout(x, p=self.dropout, training=True)
            hn = [torch.cat(o, dim=0) for o in outs]
        else:
            x, hn = self._fused(x, hx, 0, self.num_layers, lengths)
        out = x.transpose(0, 1) if self.time_major else x
        return out, (tuple(hn) if lstm else hn[0])


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        _check_activation(activation)
        super().__init__("RNN_TANH" if activation == "tanh" else "RNN_RELU",
                         input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation, **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]
