"""BERT/ERNIE-style bidirectional encoders: pretraining and classification.

Counterpart: ``paddle_tpu/models/bert.py``. Each encoder layer's
attention takes one of the port's kernels under the reference's gates
(the Hopper kernels on a card, their plain versions on the CPU):

- unfused layers (`nn.TransformerEncoderLayer`): a masked batch (an
  ``attention_mask`` of shape ``[B, 1, 1, S]``, bool key padding or
  additive) runs ``nn.functional.scaled_dot_product_attention`` into the
  general flash kernels (B2); an unmasked batch at ``S % 128 == 0`` takes
  the qkv-direct branch of `nn.MultiHeadAttention`, the which-major qkv3
  kernels (B5);
- ``fuse=True`` (`incubate.nn.FusedTransformerEncoderLayer`, reference
  :88-97): an unmasked batch runs the pair-major qkv kernels (B1) on a
  pair-major shuffle of ``qkv_weight``, a masked one B2. Its layers drop
  activations too (``act_dropout_rate`` defaults to the hidden dropout),
  where the unfused ones do not.

The reference's parameter names and layouts are kept (``Linear`` weights
``[in, out]``), so a ``paddle_tpu`` state dict loads key for key
(`models.convert`). The MLM decoder is tied to the word embedding: one
tensor, listed once by ``named_parameters`` (as the reference's
``named_parameters`` lists it once, ``nn/layer.py:149-158``), so
``torch.func.functional_call`` in `distributed.SpmdTrainStep` ties it too
and its gradient sums both uses.

A model is built in eval mode with parameters that do not require grad;
training runs it through `distributed.SpmdTrainStep` (call
``model.train()`` for dropout).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import ops
from ..device import resolve_device, resolve_dtype
from ..incubate.nn import FusedTransformerEncoderLayer
from ..nn import (Dropout, Embedding, LayerNorm, Linear,
                  TransformerEncoderLayer, init_weights)
from ..nn import functional as F


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    pad_token_id: int = 0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    def num_params(self, include_embeddings=True):
        """Matrix parameters of the encoder layers (and the embedding
        tables), the convention of `GPTConfig.num_params` that the MFU
        figures use."""
        h, f = self.hidden_size, self.intermediate_size
        n = self.num_hidden_layers * (4 * h * h + 2 * h * f)
        if include_embeddings:
            n += (self.vocab_size + self.max_position_embeddings
                  + self.type_vocab_size) * h
        return n


BERT_CONFIGS = {
    "bert-base": dict(hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072),
    # Devlin et al. 2018, BERT-Large: 24 layers, h 1024, 16 heads
    "bert-large": dict(hidden_size=1024, num_hidden_layers=24,
                       num_attention_heads=16, intermediate_size=4096),
    "bert-test": dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      max_position_embeddings=64, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0),
}


def bert_config(name: str) -> BertConfig:
    return BertConfig(**BERT_CONFIGS[name])


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, h, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, h,
                                             **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, h, **kw)
        self.layer_norm = LayerNorm(h, epsilon=1e-12, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        """Word + position + token-type embeddings, LayerNorm, dropout.
        Positions default to ``0..S-1``, token types to 0."""
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


def _init_weights(model, seed, std):
    """Random init (`nn.init_weights`); the model in eval mode with
    parameters that do not require grad."""
    init_weights(model, seed, std)
    model.requires_grad_(False)
    model.eval()


def _resolve(config, device, dtype):
    cfg = bert_config(config) if isinstance(config, str) else config
    return cfg, resolve_device(device), resolve_dtype(dtype)


class BertModel(nn.Module):
    """Embeddings, ``num_hidden_layers`` post-LN encoder layers (GELU,
    LayerNorm eps 1e-5; unfused: ``act_dropout`` 0; ``fuse=True``: the
    fused layers) and the pooler ``tanh(Linear(x[:, 0]))``. ``config``:
    a `BertConfig` or a `BERT_CONFIGS` name. ``device``: ``None`` means
    ``cuda`` (raises without a GPU). Weights are random from ``seed``;
    `models.convert` loads real ones."""

    def __init__(self, config, fuse=False, *, device=None, dtype="float32",
                 seed=0):
        super().__init__()
        cfg, dev, dt = _resolve(config, device, dtype)
        self.config = cfg
        kw = dict(device=dev, dtype=dt)
        self.embeddings = BertEmbeddings(cfg, **kw)
        if fuse:
            layers = [FusedTransformerEncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, dropout_rate=cfg.hidden_dropout_prob,
                activation=cfg.hidden_act,
                attn_dropout_rate=cfg.attention_probs_dropout_prob, **kw)
                for _ in range(cfg.num_hidden_layers)]
        else:
            layers = [TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, dropout=cfg.hidden_dropout_prob,
                activation=cfg.hidden_act,
                attn_dropout=cfg.attention_probs_dropout_prob,
                act_dropout=0.0, **kw)
                for _ in range(cfg.num_hidden_layers)]
        self.encoder_layers = nn.ModuleList(layers)
        self.pooler_dense = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        _init_weights(self, seed, cfg.initializer_range)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """``(sequence [B, S, h], pooled [B, h])``."""
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder_layers:
            x = layer(x, src_mask=attention_mask)
        return x, torch.tanh(self.pooler_dense(x[:, 0]))


class BertPretrainingHeads(nn.Module):
    """MLM head ``LN(gelu(transform(h))) @ W_emb^T + decoder_bias``
    (LayerNorm eps 1e-12; ``W_emb`` the tied word embedding) and the NSP
    head ``seq_relationship(pooled)``."""

    def __init__(self, cfg: BertConfig, embedding_weights, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.transform = Linear(h, h, **kw)
        self.activation = getattr(F, cfg.hidden_act)
        self.layer_norm = LayerNorm(h, epsilon=1e-12, **kw)
        self.decoder_weight = embedding_weights               # tied
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))
        self.seq_relationship = Linear(h, 2, **kw)

    def forward(self, sequence_output, pooled_output):
        h = self.layer_norm(self.activation(self.transform(sequence_output)))
        logits = ops.matmul(h, self.decoder_weight,
                            transpose_y=True) + self.decoder_bias
        return logits, self.seq_relationship(pooled_output)


class BertForPretraining(nn.Module):
    """`BertModel` plus `BertPretrainingHeads`: ``forward`` returns the
    MLM logits ``[B, S, V]`` and the NSP logits ``[B, 2]``. ``config``,
    ``fuse``, ``device``, ``dtype`` as for `BertModel` (the reference
    takes the `BertModel` itself); the whole model is drawn from ``seed``
    by one generator, the heads after the encoder."""

    def __init__(self, config, fuse=False, *, device=None, dtype="float32",
                 seed=0):
        super().__init__()
        self.bert = BertModel(config, fuse, device=device, dtype=dtype,
                              seed=seed)
        cfg = self.bert.config
        w = self.bert.embeddings.word_embeddings.weight
        self.cls = BertPretrainingHeads(cfg, w, device=w.device,
                                        dtype=w.dtype)
        _init_weights(self, seed, cfg.initializer_range)

    @property
    def config(self) -> BertConfig:
        return self.bert.config

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        return self.cls(seq, pooled)


class BertForSequenceClassification(nn.Module):
    """`BertModel` plus dropout and a ``Linear(h, num_classes)`` on the
    pooled output (dropout defaults to ``hidden_dropout_prob``)."""

    def __init__(self, config, num_classes=2, dropout=None, *, device=None,
                 dtype="float32", seed=0):
        super().__init__()
        self.bert = BertModel(config, device=device, dtype=dtype, seed=seed)
        cfg = self.bert.config
        w = self.bert.embeddings.word_embeddings.weight
        self.dropout = Dropout(cfg.hidden_dropout_prob if dropout is None
                               else dropout)
        self.classifier = Linear(cfg.hidden_size, num_classes,
                                 device=w.device, dtype=w.dtype)
        _init_weights(self, seed, cfg.initializer_range)

    @property
    def config(self) -> BertConfig:
        return self.bert.config

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))


__all__ = ["BertConfig", "BERT_CONFIGS", "bert_config", "BertEmbeddings",
           "BertModel", "BertPretrainingHeads", "BertForPretraining",
           "BertForSequenceClassification"]
