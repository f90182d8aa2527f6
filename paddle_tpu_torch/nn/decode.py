"""Seq2seq decoding: `BeamSearchDecoder` and `dynamic_decode`.

Counterpart: ``paddle_tpu/nn/decode.py``. The decoder wraps a step cell
``cell(inputs, states) -> (outputs, new_states)`` whose outputs (after
``output_fn``) are vocabulary logits; ``embedding_fn`` maps the step's
token ids to the cell's inputs.

- ``initialize`` (``:47-56``): every beam starts from ``start_token``,
  only beam 0 live (log-prob 0, the others -1e9, so that copies of one
  beam do not fill the top k), the states tiled ``k`` times along the
  batch (`tile_beam_merge_with_batch`).
- `dynamic_decode` (``:67-120``) runs a host loop of steps
  (`beam_search_step`): the log-softmax of the logits in float32; a
  finished beam extends only with ``end_token``, at no cost
  (``:90-92``); the top k of the ``k * V`` totals of each row, then the
  parent beam and the token; the lengths count the steps before a beam
  finished. Ties go to the lower flat index, as ``lax.top_k`` gives
  them: the first k entries of a stable descending sort
  (``torch.topk`` makes no such promise on a card, and ties are real
  here, at the -1e9 starts). Every state leaf whose first dim is ``B *
  k`` is reordered by the parents (`_reorder_beams`), over any tree
  ``torch.utils._pytree`` walks (tuples, lists, dicts and named tuples
  such as `MultiHeadAttention.Cache` and ``StaticCache``). One host
  read a step asks whether every beam finished. Then
  `functional.gather_tree` follows the parents back from the last step.
  Returns ``(ids [B, T, k], log_probs [B, k])`` (``[T, B, k]`` with
  ``output_time_major``), and the lengths ``[B, k]`` with
  ``return_length``.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree

from .functional.extra import gather_tree


def _first_leaf(tree):
    return _pytree.tree_leaves(tree)[0]


class BeamSearchDecoder:
    """Beam search over ``cell``'s steps (module docstring)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(t, beam_size):
        """``[B, ...] -> [B * beam, ...]``, each batch row repeated."""
        return t.repeat_interleave(beam_size, dim=0)

    def initialize(self, initial_states, batch_size):
        k = self.beam_size
        device = _first_leaf(initial_states).device
        ids = torch.full((batch_size, k), self.start_token,
                         dtype=torch.int64, device=device)
        log_probs = torch.full((batch_size, k), -1e9, device=device)
        log_probs[:, 0] = 0.0
        finished = torch.zeros((batch_size, k), dtype=torch.bool,
                               device=device)
        states = _pytree.tree_map(
            lambda s: self.tile_beam_merge_with_batch(s, k), initial_states)
        return ids, log_probs, finished, states

    def step(self, inputs, states):
        emb = self.embedding_fn(inputs) if self.embedding_fn else inputs
        out = self.cell(emb, states)
        outputs, new_states = out if isinstance(out, tuple) else (out, states)
        if self.output_fn is not None:
            outputs = self.output_fn(outputs)
        return outputs, new_states


def beam_search_step(logits, log_probs, finished, lengths, end_token):
    """One selection of `dynamic_decode` (``:86-102``): from the step's
    ``logits [B*k, V]`` and the beams' ``log_probs [B, k]``, ``finished``
    and ``lengths``, the new ``(log_probs, finished, lengths, parent,
    token, totals)``; ``totals [B, k*V]`` are the candidates' scores the
    top k was taken from."""
    b, k = log_probs.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    vocab = logp.shape[-1]
    logp = logp.reshape(b, k, vocab)
    pad = torch.full((vocab,), -1e9, device=logp.device)
    pad[end_token] = 0.0
    logp = torch.where(finished[:, :, None], pad, logp)
    totals = (log_probs[:, :, None] + logp).reshape(b, k * vocab)
    top_v, top_i = torch.sort(totals, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[:, :k], top_i[:, :k]
    parent = top_i // vocab
    token = top_i % vocab
    finished = finished.gather(1, parent) | (token == end_token)
    lengths = lengths.gather(1, parent) + (~finished).to(lengths.dtype)
    return top_v, finished, lengths, parent, token, totals


def dynamic_decode(decoder, inits=None, max_step_num=20, batch_size=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every beam finishes or ``max_step_num``
    steps (module docstring)."""
    k = decoder.beam_size
    if batch_size is None:
        batch_size = int(_first_leaf(inits).shape[0])
    ids, log_probs, finished, states = decoder.initialize(inits, batch_size)
    lengths = torch.zeros((batch_size, k), dtype=torch.int32,
                          device=ids.device)
    cur_ids = ids
    step_ids, parents = [], []
    for _ in range(max_step_num):
        logits, states = decoder.step(cur_ids.reshape(-1), states)
        log_probs, finished, lengths, parent, token, _ = beam_search_step(
            logits, log_probs, finished, lengths, decoder.end_token)
        states = _pytree.tree_map(
            lambda s: _reorder_beams(s, parent, batch_size, k), states)
        step_ids.append(token)
        parents.append(parent)
        cur_ids = token
        if bool(finished.all()):
            break
    out = gather_tree(torch.stack(step_ids), torch.stack(parents))
    if not output_time_major:
        out = out.transpose(0, 1)
    rets = (out, log_probs)
    if return_length:
        rets = rets + (lengths,)
    return rets


def _reorder_beams(s, parent, batch_size, k):
    """``s``'s beams in the order of ``parent [B, k]`` when its first dim
    is ``B * k``; any other leaf as it is."""
    if not isinstance(s, torch.Tensor) or s.dim() == 0 \
            or s.shape[0] != batch_size * k:
        return s
    flat = (parent + torch.arange(batch_size, device=parent.device)[:, None]
            * k).reshape(-1)
    return s.index_select(0, flat.to(s.device))


__all__ = ["BeamSearchDecoder", "dynamic_decode"]
