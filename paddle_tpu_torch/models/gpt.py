"""GPT decoder-only language models: training and paged serving.

Counterpart: ``paddle_tpu/models/gpt.py``. Ported so far:

- training (``forward`` of every block, :104-174, :808-874, :951-1025,
  :1272-1278; `GPTPretrainingCriterion`, :1389-1397): dropout modules,
  and the attention's flash branch, which feeds the fused qkv projection
  as it is to `kernels.flash_attention.flash_attention_qkv` (the Hopper
  kernels on a card) under the reference's own conditions, else
  `nn.functional.scaled_dot_product_attention` (the general flash
  kernels where its gate takes the mask and shape, else the
  composition);
- serving, as the paged engine runs it: the masked prompt pass
  (`GPTModel.prefill`), the one-token-per-slot paged decode step
  (`GPTModel.decode_slots_paged`) and the speculative verify window of
  ``W = k + 1`` tokens per slot (`GPTModel.verify_slots_paged`), over
  float or quantized (int8 / fp8 pages with f32 scales) pools, plus the
  weight-tied LM head and the cache/pool/scale constructors.

Two layouts are kept from the reference so that a ``paddle_tpu``
state dict loads key for key (`models.convert`):

- `nn.Linear` stores ``W`` as ``[in, out]`` (paddle_tpu's layout).
- The fused qkv projection's output columns are PAIR-MAJOR
  (``[pair0: q(2d)|k(2d)|v(2d), pair1: ...]``, one whole group for an
  odd head count); `unpack_qkv_pair_major` is the one place that reads
  it (``gpt.py:725-738``).

A model is built in eval mode with parameters that do not require grad
(the engine serves it as it is). Training runs it through
`distributed.SpmdTrainStep`, which swaps in parameter tensors of its own
(``torch.func.functional_call``); call ``model.train()`` for dropout.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..device import PAGE_DTYPES, resolve_device, resolve_dtype
from ..kernels import flash_attention_qkv_enabled, paged_kv
from ..kernels.flash_attention import flash_attention_qkv
from ..kernels.paged_attention import paged_decode_attention
from ..nn import Dropout, Embedding, LayerNorm, Linear, init_weights
from ..nn.functional import (cross_entropy, mt_attention_core,
                             scaled_dot_product_attention)


@dataclass
class GPTConfig:
    vocab_size: int = 50304            # padded to a multiple of 128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    use_flash_attention: bool = True

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    def num_params(self, include_embeddings=True):
        h, l, v = self.hidden_size, self.num_hidden_layers, self.vocab_size
        per_layer = 4 * h * h + 2 * h * self.intermediate_size
        n = l * per_layer
        if include_embeddings:
            n += v * h + self.max_position_embeddings * h
        return n


GPT_CONFIGS = {
    # name: (vocab, hidden, layers, heads, ffn, max_pos)
    "gpt2-124m": GPTConfig(50304, 768, 12, 12, 3072, 1024),
    "gpt2-medium": GPTConfig(50304, 1024, 24, 16, 4096, 1024),
    "gpt2-large": GPTConfig(50304, 1280, 36, 20, 5120, 1024),
    "gpt3-1.3b": GPTConfig(50304, 2048, 24, 16, 8192, 2048),
    "gpt3-2.7b": GPTConfig(50304, 2560, 32, 32, 10240, 2048),
    "gpt3-6.7b": GPTConfig(50304, 4096, 32, 32, 16384, 2048),
    "gpt3-13b": GPTConfig(50304, 5120, 40, 40, 20480, 2048),
    # tiny config for tests / dry runs
    "gpt-test": GPTConfig(256, 64, 2, 4, 128, 64, use_flash_attention=False),
}


def gpt_config(name: str) -> GPTConfig:
    return GPT_CONFIGS[name]


def unpack_qkv_pair_major(qkv, n_heads, head_dim):
    """Inverse of the pair-major qkv packing: ``[B, S, 3*H*D]`` -> three
    head-major ``[B, S, H, D]`` tensors."""
    b, s = qkv.shape[0], qkv.shape[1]
    pairs = n_heads // 2 if n_heads % 2 == 0 else 1
    per = n_heads // pairs
    x5 = qkv.reshape(b, s, pairs, 3, per * head_dim)
    return tuple(x5[:, :, :, i].reshape(b, s, n_heads, head_dim)
                 for i in range(3))


class GPTAttention(nn.Module):
    """Causal self-attention with one fused (pair-major) qkv projection."""

    def __init__(self, config: GPTConfig, *, device, dtype):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        self.qkv_proj = Linear(h, 3 * h, device=device, dtype=dtype)
        self.out_proj = Linear(h, h, device=device, dtype=dtype)
        self.attn_dropout_p = config.attention_probs_dropout_prob
        self.use_flash = config.use_flash_attention
        self.resid_dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x, attn_mask=None):
        """Training and full-sequence attention over ``x [B, S, h]``:
        causal without a mask, else ``attn_mask`` (bool or additive).

        With ``use_flash_attention``, no mask and a shape the gate takes,
        the projection feeds `flash_attention_qkv` as it is (``gpt.py:
        136-148``). Otherwise the unpacked q, k, v go to
        `scaled_dot_product_attention` with ``use_flash`` (:149-171):
        with a mask or a shape the qkv gate refuses, the general flash
        kernels where that gate takes them, else the composition."""
        b, s, h = x.shape
        dropout_p = self.attn_dropout_p if self.training else 0.0
        qkv = self.qkv_proj(x)
        if self.use_flash and flash_attention_qkv_enabled(
                qkv, self.num_heads, attn_mask, dropout_p):
            out = flash_attention_qkv(qkv, self.num_heads, is_causal=True,
                                      dropout_p=dropout_p)
            return self.resid_dropout(self.out_proj(out))
        q, k, v = unpack_qkv_pair_major(qkv, self.num_heads, self.head_dim)
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
            is_causal=attn_mask is None, training=self.training,
            use_flash=self.use_flash)
        return self.resid_dropout(self.out_proj(out.reshape(b, s, h)))

    def _heads(self, x):
        """x -> head-major q, k, v ``[B, H, S, D]``."""
        q, k, v = unpack_qkv_pair_major(self.qkv_proj(x), self.num_heads,
                                        self.head_dim)
        return (q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                v.permute(0, 2, 1, 3))

    def forward_prefill(self, x, k_cache, v_cache, pad_mask=None):
        """Prompt pass: causal attention over ``x [B, S, h]`` and the
        prompt K/V written into cache columns ``[0, S)`` in place.
        ``pad_mask [B, S]`` (1 = real token) excludes left-pad columns
        from every query's view. This is the reference's masked branch
        (``gpt.py:228-245``), which the engine always takes."""
        s = x.shape[1]
        qh, kh, vh = self._heads(x)
        k_cache[:, :, :s] = kh.to(k_cache.dtype)
        v_cache[:, :, :s] = vh.to(v_cache.dtype)
        ar = torch.arange(s, device=x.device)
        valid = (ar[None, :] <= ar[:, None])[None, None]
        if pad_mask is not None:
            valid = valid & (pad_mask != 0)[:, None, None, :]
        ctx = mt_attention_core(qh, kh, vh, self.head_dim, valid_mask=valid)
        return self.out_proj(ctx)

    def forward_slots_paged(self, x, pool_k, pool_v, block_table, steps,
                            targets, valid_cols=None, k_scale=None,
                            v_scale=None):
        """W tokens per slot over the paged pool, ``x [B, W, h]`` (W = 1
        a decode step, ``gpt.py:450-517``; W = k + 1 a speculative verify
        window, :399-448): lane ``j`` of row ``s`` writes its K/V at
        logical column ``steps[s] + j`` (in place, to the flat page and
        in-page column of ``targets``, `paged_kv.tail_page_targets`;
        quantized at write when ``k_scale``/``v_scale`` ride with 1-byte
        pools) and attends the columns up to its own through
        `paged_decode_attention`, all W lanes in one call: the Hopper
        kernel on a card, which dequantizes in the kernel. A verify
        window writes only the slot's own reserved pages past its
        cursor, so a rejected lane is rolled back by the cursor alone."""
        b, w = x.shape[0], x.shape[1]
        q, k, v = unpack_qkv_pair_major(self.qkv_proj(x), self.num_heads,
                                        self.head_dim)     # [B, W, H, D]
        flat = (b * w, self.num_heads, self.head_dim)
        if k_scale is None:
            paged_kv.write_token_pages(pool_k, *targets, k.reshape(flat))
            paged_kv.write_token_pages(pool_v, *targets, v.reshape(flat))
        else:
            paged_kv.write_token_pages_q(pool_k, k_scale, *targets,
                                         k.reshape(flat))
            paged_kv.write_token_pages_q(pool_v, v_scale, *targets,
                                         v.reshape(flat))
        ctx = paged_decode_attention(q.permute(0, 2, 1, 3), pool_k, pool_v,
                                     block_table, steps, self.head_dim,
                                     valid_cols=valid_cols, k_scale=k_scale,
                                     v_scale=v_scale)
        return self.out_proj(ctx.reshape(b, w, -1))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, *, device, dtype):
        super().__init__()
        self.fc_in = Linear(config.hidden_size, config.intermediate_size,
                            device=device, dtype=dtype)
        self.fc_out = Linear(config.intermediate_size, config.hidden_size,
                             device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        return self.dropout(self.fc_out(F.gelu(self.fc_in(x),
                                               approximate="tanh")))


class GPTDecoderLayer(nn.Module):
    """Pre-LN transformer block (GPT-2 style)."""

    def __init__(self, config: GPTConfig, *, device, dtype):
        super().__init__()
        eps = config.layer_norm_epsilon
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.mlp = GPTMLP(config, **kw)

    def forward(self, x, attn_mask=None):
        x = x + self.attn(self.ln_1(x), attn_mask=attn_mask)
        return x + self.mlp(self.ln_2(x))

    def forward_prefill(self, x, k_cache, v_cache, pad_mask=None):
        x = x + self.attn.forward_prefill(self.ln_1(x), k_cache, v_cache,
                                          pad_mask=pad_mask)
        return x + self.mlp(self.ln_2(x))

    def forward_slots_paged(self, x, pool_k, pool_v, block_table, steps,
                            targets, valid_cols=None, k_scale=None,
                            v_scale=None):
        x = x + self.attn.forward_slots_paged(
            self.ln_1(x), pool_k, pool_v, block_table, steps, targets,
            valid_cols=valid_cols, k_scale=k_scale, v_scale=v_scale)
        return x + self.mlp(self.ln_2(x))


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        """Word plus position embeddings, then dropout. Positions default
        to ``0..S-1`` for every row."""
        if position_ids is None:
            b, s = input_ids.shape
            position_ids = torch.arange(s, device=input_ids.device).expand(
                b, s)
        return self.dropout(self.word_embeddings(input_ids)
                            + self.position_embeddings(position_ids))


class GPTModel(nn.Module):
    """Backbone: embeddings + N decoder layers + final LN."""

    def __init__(self, config: GPTConfig, *, device, dtype):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embeddings = GPTEmbeddings(config, **kw)
        self.h = nn.ModuleList([GPTDecoderLayer(config, **kw)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon, **kw)

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                caches=None):
        """Hidden states ``[B, S, h]`` of a full sequence. The concat-grow
        ``caches`` path of the reference is a later slice (ROADMAP A7);
        serving uses `prefill` and `decode_slots_paged`."""
        if caches is not None:
            raise NotImplementedError(
                "GPTModel.forward(caches=...) is a later slice (ROADMAP "
                "A7); serve through prefill/decode_slots_paged")
        x = self.embeddings(input_ids, position_ids)
        for layer in self.h:
            x = layer(x, attn_mask=attn_mask)
        return self.ln_f(x)

    def prefill(self, input_ids, caches, pad_mask=None):
        """Prompt pass over per-layer ``[B, H, >=S, D]`` caches (written in
        place). ``pad_mask [B, S]``: left-padded rows — pad columns are
        masked and position ids restart at each row's first real token
        (``cumsum(pad_mask) - 1`` clipped at 0). Returns the hidden
        states ``[B, S, h]``."""
        b, s = input_ids.shape
        if pad_mask is None:
            pos = torch.arange(s, device=input_ids.device).expand(b, s)
        else:
            pos = (pad_mask.long().cumsum(dim=1) - 1).clamp(min=0)
        x = self.embeddings(input_ids, pos)
        for layer, (kc, vc) in zip(self.h, caches):
            x = layer.forward_prefill(x, kc, vc, pad_mask=pad_mask)
        return self.ln_f(x)

    def decode_slots_paged(self, token_ids, steps, pools, block_table,
                           pads=None, valid_cols=None, scales=None):
        """One token per slot at per-row logical columns ``steps [B]``
        over the per-layer ``[(k_pool, v_pool), ...]`` (written in place;
        one ``block_table [B, max_pages]`` for every layer). ``scales``:
        the per-layer ``[(k_scale, v_scale), ...]`` of a quantized pool,
        written in place beside it. Position ids are ``steps - pads``
        clipped at 0. Returns ``[B, 1, h]``: the verify window of one
        lane."""
        return self.verify_slots_paged(token_ids, steps, pools, block_table,
                                       pads, valid_cols, scales)

    def verify_slots_paged(self, token_ids, steps, pools, block_table,
                           pads=None, valid_cols=None, scales=None):
        """The speculative verify window over the paged pool
        (``gpt.py:1129-1156``): ``token_ids [B, W]`` holds each slot's
        pending token (lane 0) and up to ``W - 1`` drafted ones; lane
        ``j`` sits at column ``steps[s] + j`` with position id
        ``steps[s] - pads[s] + j``, the positions W sequential
        `decode_slots_paged` calls would give it. Returns the hidden
        states of all W lanes ``[B, W, h]``. Every layer writes the same
        page slots, so their targets are computed once."""
        b, w = token_ids.shape
        pos = steps.long() if pads is None else steps.long() - pads.long()
        pos = (pos.clamp(min=0)[:, None]
               + torch.arange(w, device=token_ids.device)[None, :])
        x = self.embeddings(token_ids, pos)
        pool0 = pools[0][0]
        targets = paged_kv.tail_page_targets(block_table, steps, w,
                                             pool0.shape[2],
                                             pool0.shape[0] - 1)
        for i, (layer, (pk, pv)) in enumerate(zip(self.h, pools)):
            ks, vs = (None, None) if scales is None else scales[i]
            x = layer.forward_slots_paged(x, pk, pv, block_table, steps,
                                          targets, valid_cols=valid_cols,
                                          k_scale=ks, v_scale=vs)
        return self.ln_f(x)


class GPTForPretraining(nn.Module):
    """GPT with the LM head tied to the word embedding.

    ``config``: a `GPTConfig` or a `GPT_CONFIGS` name. ``device``:
    ``None`` means ``cuda`` (raises without a GPU; pass ``"cpu"`` for
    the CPU). Weights are random from ``seed`` (normal with the config's
    ``initializer_range``, zero biases, unit LayerNorm scales), made on
    the target device; `models.convert` loads real ones."""

    def __init__(self, config, *, device=None, dtype="float32", seed=0):
        super().__init__()
        if isinstance(config, str):
            config = gpt_config(config)
        dev = resolve_device(device)
        self.gpt = GPTModel(config, device=dev, dtype=resolve_dtype(dtype))
        init_weights(self, seed, config.initializer_range)
        self.requires_grad_(False)
        self.eval()

    @property
    def config(self) -> GPTConfig:
        return self.gpt.config

    @property
    def device(self) -> torch.device:
        return self.gpt.embeddings.word_embeddings.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.embeddings.word_embeddings.weight.dtype

    def _logits(self, hidden):
        """The weight-tied LM head, the only logits projection
        (``gpt.py:1266-1270``)."""
        return hidden @ self.gpt.embeddings.word_embeddings.weight.T

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                caches=None):
        """Logits ``[B, S, V]`` of a full sequence (tied head)."""
        return self._logits(self.gpt(input_ids, position_ids, attn_mask,
                                     caches))

    def gen_static_cache(self, batch_size, max_len, dtype=None):
        """Per-layer ``(k, v)`` caches ``[batch, heads, max_len, head_dim]``
        of zeros."""
        cfg = self.config
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"prompt + max_new_tokens = {max_len} exceeds "
                f"max_position_embeddings {cfg.max_position_embeddings}")
        shape = (batch_size, cfg.num_attention_heads, max_len, cfg.head_dim)
        return self._zeros_per_layer(
            shape, self.dtype if dtype is None else resolve_dtype(dtype))

    def gen_page_pool(self, pages, page_size, dtype=None):
        """Per-layer ``(k, v)`` page pools ``[pages, heads, page_size,
        head_dim]`` of zeros, in the model dtype or ``dtype`` (a
        `device.PAGE_DTYPES` name: int8 and float8_e4m3fn for quantized
        pools)."""
        cfg = self.config
        shape = (int(pages), cfg.num_attention_heads, int(page_size),
                 cfg.head_dim)
        return self._zeros_per_layer(
            shape, self.dtype if dtype is None
            else resolve_dtype(dtype, PAGE_DTYPES))

    def gen_page_scales(self, pages, page_size):
        """Per-layer ``(k_scale, v_scale)`` ``[pages, heads, page_size]``
        f32 zeros for a quantized page pool, one scale per (page, head,
        in-page column): an unwritten slot dequantizes to zeros."""
        cfg = self.config
        shape = (int(pages), cfg.num_attention_heads, int(page_size))
        return self._zeros_per_layer(shape, torch.float32)

    def _zeros_per_layer(self, shape, dt):
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device))
                for _ in range(self.config.num_hidden_layers)]

    def prefill(self, input_ids, caches, pad_mask=None):
        """Logits of the last position ``[B, 1, V]`` (under left padding
        every row's newest real token) and the written caches."""
        hidden = self.gpt.prefill(input_ids, caches, pad_mask=pad_mask)
        return self._logits(hidden[:, -1:]), caches

    def decode_slots_paged(self, token_ids, steps, pools, block_table,
                           pads=None, valid_cols=None, scales=None):
        """Logits ``[B, 1, V]`` of one paged decode step (pools, and the
        scales of a quantized pool, written in place)."""
        return self._logits(self.gpt.decode_slots_paged(
            token_ids, steps, pools, block_table, pads=pads,
            valid_cols=valid_cols, scales=scales))

    def verify_slots_paged(self, token_ids, steps, pools, block_table,
                           pads=None, valid_cols=None, scales=None):
        """Logits ``[B, W, V]`` of one paged verify window (pools and
        scales written in place)."""
        return self._logits(self.gpt.verify_slots_paged(
            token_ids, steps, pools, block_table, pads=pads,
            valid_cols=valid_cols, scales=scales))


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross entropy with an optional loss mask."""

    def forward(self, logits, labels, loss_mask=None):
        loss = cross_entropy(logits, labels, reduction="none")
        if loss_mask is not None:
            mask = loss_mask.reshape(loss.shape).to(loss.dtype)
            return (loss * mask).sum() / mask.sum().clamp(min=1.0)
        return loss.mean()


__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "unpack_qkv_pair_major",
           "GPTAttention", "GPTMLP", "GPTDecoderLayer", "GPTEmbeddings", "GPTModel",
           "GPTForPretraining", "GPTPretrainingCriterion"]
