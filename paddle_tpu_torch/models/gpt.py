"""GPT decoder-only language models: training, generation and paged
serving.

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
  weight-tied LM head and the cache/pool/scale constructors;
- generation, as `models.generation.GenerationMixin.generate` runs it:
  the prompt pass with the reference's unmasked flash branch (a pad-free
  prompt the qkv gate takes), the static-cache decode step
  (`GPTModel.decode_step`), the paged beam step with a shared prompt
  segment and per-beam tail pages (`GPTModel.decode_beam_paged`, the
  tail through `kernels.paged_attention.paged_tail_segment`), and the
  concat-grow ``forward(caches=)``. The decode steps take their cursor
  (``step``, ``gen_col``) as an int or as an int tensor on the device,
  and no shape depends on it, so one CUDA graph of a step serves every
  position (`jit.capture.CapturedStep`).

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

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..device import PAGE_DTYPES, resolve_device, resolve_dtype
from ..kernels import flash_attention_qkv_enabled, paged_kv
from ..kernels.flash_attention import flash_attention_qkv
from ..kernels.paged_attention import (merge_attention_segments,
                                       paged_decode_attention,
                                       paged_tail_segment)
from ..nn import Dropout, Embedding, LayerNorm, Linear, init_weights
from ..nn.functional import (cross_entropy, mt_attention_core,
                             scaled_dot_product_attention)
from .generation import GenerationMixin


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


def decode_cursor(step, max_len: int, device) -> torch.Tensor:
    """A decode step's cache column as a 0-d int64 tensor on ``device``.
    An int is checked against ``max_len`` (ValueError past it) and made
    with a fill, so a graph may capture it; a tensor is taken as it is,
    unchecked: a captured step never reads the device from the host, and
    its caller checks the cursor on the host from its loop index."""
    if torch.is_tensor(step):
        return step.reshape(()).long()
    if int(step) >= max_len:
        raise ValueError(f"decode step {int(step)} out of range for cache "
                         f"max_len {max_len}")
    return torch.full((), int(step), dtype=torch.long, device=device)


def decode_attention(q, keys, vals, head_dim, valid_mask):
    """softmax(q K^T / sqrt(d)) V of the decode step over its whole
    static cache: `nn.functional.mt_attention_core`, but the scores
    leave the product in float32 (bf16 and fp16 operands: cuBLAS with a
    float32 output on a card, the operands widened on the CPU), as the
    port's attention kernels keep theirs, where the composition rounds
    them to the operands' type. q ``[B, H, S, D]``, keys/vals ``[B, H,
    L, D]``, ``valid_mask`` broadcastable to ``[B, H, S, L]``; returns
    ``[B, S, H*D]``."""
    b, h, s, d = q.shape
    n = keys.shape[2]
    q3 = q.reshape(b * h, s, d)
    k3 = keys.reshape(b * h, n, d).transpose(1, 2)
    if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16):
        scores = torch.bmm(q3, k3, torch.float32)
    else:
        scores = torch.bmm(q3.float(), k3.float())
    s32 = scores.view(b, h, s, n) / math.sqrt(head_dim)
    s32 = s32.masked_fill(~valid_mask, torch.finfo(torch.float32).min / 2)
    w = torch.softmax(s32, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhsl,bhld->bhsd", w, vals)
    return ctx.permute(0, 2, 1, 3).reshape(b, s, h * d)


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

    def forward(self, x, attn_mask=None, cache=None):
        """Training and full-sequence attention over ``x [B, S, h]``:
        causal without a mask, else ``attn_mask`` (bool or additive).

        With ``use_flash_attention``, no mask, no cache and a shape the
        gate takes, the projection feeds `flash_attention_qkv` as it is
        (``gpt.py:136-148``). Otherwise the unpacked q, k, v go to
        `scaled_dot_product_attention` with ``use_flash`` (:149-171):
        with a mask or a shape the qkv gate refuses, the general flash
        kernels where that gate takes them, else the composition.

        ``cache``: the concat-grow ``(k, v)`` cache ``[B, past, H, D]``
        (:162-174): the new K/V are appended along the sequence axis, the
        causal mask is bottom-right aligned, and the call returns ``(out,
        (k, v))``."""
        b, s, h = x.shape
        dropout_p = self.attn_dropout_p if self.training else 0.0
        qkv = self.qkv_proj(x)
        if cache is None and self.use_flash and flash_attention_qkv_enabled(
                qkv, self.num_heads, attn_mask, dropout_p):
            out = flash_attention_qkv(qkv, self.num_heads, is_causal=True,
                                      dropout_p=dropout_p)
            return self.resid_dropout(self.out_proj(out))
        q, k, v = unpack_qkv_pair_major(qkv, self.num_heads, self.head_dim)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
            is_causal=attn_mask is None, training=self.training,
            use_flash=self.use_flash)
        out = self.resid_dropout(self.out_proj(out.reshape(b, s, h)))
        return out if cache is None else (out, (k, v))

    def _heads(self, x):
        """x -> head-major q, k, v ``[B, H, S, D]``."""
        q, k, v = unpack_qkv_pair_major(self.qkv_proj(x), self.num_heads,
                                        self.head_dim)
        return (q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                v.permute(0, 2, 1, 3))

    def forward_prefill(self, x, k_cache, v_cache, pad_mask=None):
        """Prompt pass: causal attention over ``x [B, S, h]`` and the
        prompt K/V written into cache columns ``[0, S)`` in place
        (``gpt.py:183-247``). A pad-free prompt whose shape the qkv gate
        takes (``S % 128 == 0``) attends through `flash_attention_qkv`
        (the unmasked branch, :216-227: the Hopper kernel on a card).
        Otherwise ``pad_mask [B, S]`` (1 = real token), when given,
        excludes left-pad columns from every query's view, in composed
        attention (the masked branch, :228-245, which the engine always
        takes)."""
        s = x.shape[1]
        qkv = self.qkv_proj(x)
        q, k, v = unpack_qkv_pair_major(qkv, self.num_heads, self.head_dim)
        kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        k_cache[:, :, :s] = kh.to(k_cache.dtype)
        v_cache[:, :, :s] = vh.to(v_cache.dtype)
        if (pad_mask is None and self.use_flash
                and flash_attention_qkv_enabled(qkv, self.num_heads, None,
                                                0.0)):
            return self.out_proj(flash_attention_qkv(qkv, self.num_heads,
                                                     is_causal=True))
        ar = torch.arange(s, device=x.device)
        valid = (ar[None, :] <= ar[:, None])[None, None]
        if pad_mask is not None:
            valid = valid & (pad_mask != 0)[:, None, None, :]
        ctx = mt_attention_core(q.permute(0, 2, 1, 3), kh, vh,
                                self.head_dim, valid_mask=valid)
        return self.out_proj(ctx)

    def forward_decode(self, x, k_cache, v_cache, step, valid_cols=None):
        """One token per row at the shared cache column ``step``
        (``gpt.py:249-291``): its K/V are written there in place
        (``index_copy_``) and it attends the whole static cache under
        ``arange(max_len) <= step``, minus the columns ``valid_cols [B,
        max_len]`` marks 0 (a left-padded prompt's pad columns). Composed
        attention, as in the reference, with float32 scores
        (`decode_attention`). ``step`` is an int, checked
        against max_len here, or a one-element int tensor on the device,
        which the caller checks on the host (`decode_cursor`)."""
        max_len = k_cache.shape[2]
        t = decode_cursor(step, max_len, x.device).reshape(1)
        b = x.shape[0]
        q, k, v = unpack_qkv_pair_major(self.qkv_proj(x), self.num_heads,
                                        self.head_dim)     # [B, 1, H, D]
        k_cache.index_copy_(2, t, k.permute(0, 2, 1, 3).to(k_cache.dtype))
        v_cache.index_copy_(2, t, v.permute(0, 2, 1, 3).to(v_cache.dtype))
        qh = q.permute(0, 2, 1, 3)
        valid = (torch.arange(max_len, device=x.device) <= t)[
            None, None, None, :]
        if valid_cols is not None:
            valid = valid & (valid_cols != 0)[:, None, None, :]
        ctx = decode_attention(qh, k_cache.to(qh.dtype),
                               v_cache.to(qh.dtype), self.head_dim, valid)
        return self.out_proj(ctx.reshape(b, 1, -1))

    def _ctx_segment(self, qh, ctx_k, ctx_v, pad_mask):
        """The beam's shared prompt segment as a normalized ``(out [N, H,
        D], lse [N, H])`` pair (``gpt.py:629-654``): each batch row's
        prompt K/V ``[B, H, Sp, D]`` is contracted once against all K
        beams of the row, softmaxed over the prompt columns alone
        (``pad_mask [B, Sp]`` masks left padding with -1e30)."""
        n, h, d = qh.shape
        b, sc = ctx_k.shape[0], ctx_k.shape[2]
        qb = qh.reshape(b, n // b, h, d)
        scale = torch.full((), float(self.head_dim), dtype=qh.dtype,
                           device=qh.device).sqrt()
        s32 = (torch.einsum("bkhd,bhld->bkhl", qb, ctx_k.to(qh.dtype))
               / scale).float()
        if pad_mask is not None:
            s32 = s32.masked_fill((pad_mask == 0)[:, None, None, :], -1e30)
        m = s32.amax(dim=-1)                                 # [B, K, H]
        p = torch.exp(s32 - m[..., None])
        l = p.sum(dim=-1)
        o = torch.einsum("bkhl,bhld->bkhd", (p / l[..., None]).to(qh.dtype),
                         ctx_v.to(qh.dtype))
        return o.reshape(n, h, d), (m + torch.log(l)).reshape(n, h)

    def forward_decode_beam_paged(self, x, ctx_k, ctx_v, pool_k, pool_v,
                                  block_table, gen_col, pad_mask=None,
                                  k_scale=None, v_scale=None):
        """One beam-decode token per row of ``x [N = B*K, 1, h]`` over the
        paged beam layout (``gpt.py:596-722``): the prompt K/V ``ctx_k/v
        [B, H, Sp, D]`` is stored once per batch row and shared by its K
        beams; each beam's generated tail lives in its pages of ``pool_k
        / pool_v`` through ``block_table [N, Pg]``. The token's K/V are
        written at gen column ``gen_col`` (an int, or a one-element int
        tensor on the device: `decode_cursor`) in place, quantized when
        ``k_scale``/``v_scale`` ride with 1-byte pools; the tail is read
        by `paged_tail_segment` (the Hopper kernel on a card) and merged
        with `_ctx_segment` by `merge_attention_segments`."""
        n = x.shape[0]
        q, k, v = unpack_qkv_pair_major(self.qkv_proj(x), self.num_heads,
                                        self.head_dim)     # [N, 1, H, D]
        qh, kh, vh = q[:, 0], k[:, 0], v[:, 0]
        ps = pool_k.shape[2]
        j = decode_cursor(gen_col, block_table.shape[1] * ps, x.device)
        pages = block_table.gather(
            1, (j // ps).reshape(1, 1).expand(n, 1))[:, 0]
        offs = (j % ps).reshape(1).expand(n)
        if k_scale is None:
            paged_kv.write_token_pages(pool_k, pages, offs, kh)
            paged_kv.write_token_pages(pool_v, pages, offs, vh)
        else:
            paged_kv.write_token_pages_q(pool_k, k_scale, pages, offs, kh)
            paged_kv.write_token_pages_q(pool_v, v_scale, pages, offs, vh)
        o_ctx, lse_ctx = self._ctx_segment(qh, ctx_k, ctx_v, pad_mask)
        o_gen, lse_gen = paged_tail_segment(
            qh, pool_k, pool_v, block_table, j, self.head_dim,
            k_scale=k_scale, v_scale=v_scale)
        o = merge_attention_segments(o_ctx, lse_ctx, o_gen, lse_gen)
        return self.out_proj(o.reshape(n, 1, -1))

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

    def forward(self, x, attn_mask=None, cache=None):
        """``x`` after the block; with ``cache`` (the concat-grow ``(k,
        v)``), ``(x, new_cache)``."""
        out = self.attn(self.ln_1(x), attn_mask=attn_mask, cache=cache)
        if cache is not None:
            out, cache = out
        x = x + out
        x = x + self.mlp(self.ln_2(x))
        return x if cache is None else (x, cache)

    def forward_prefill(self, x, k_cache, v_cache, pad_mask=None):
        x = x + self.attn.forward_prefill(self.ln_1(x), k_cache, v_cache,
                                          pad_mask=pad_mask)
        return x + self.mlp(self.ln_2(x))

    def forward_decode(self, x, k_cache, v_cache, step, valid_cols=None):
        x = x + self.attn.forward_decode(self.ln_1(x), k_cache, v_cache,
                                         step, valid_cols=valid_cols)
        return x + self.mlp(self.ln_2(x))

    def forward_decode_beam_paged(self, x, ctx_k, ctx_v, pool_k, pool_v,
                                  block_table, gen_col, pad_mask=None,
                                  k_scale=None, v_scale=None):
        x = x + self.attn.forward_decode_beam_paged(
            self.ln_1(x), ctx_k, ctx_v, pool_k, pool_v, block_table,
            gen_col, pad_mask=pad_mask, k_scale=k_scale, v_scale=v_scale)
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
        """Hidden states ``[B, S, h]`` of a full sequence. With ``caches``
        (per-layer concat-grow ``(k, v)`` ``[B, past, H, D]``, e.g.
        `GPTForPretraining.gen_cache`; ``gpt.py:1007-1025``) the positions
        continue at ``past`` and the call returns ``(hidden,
        new_caches)``."""
        if caches is not None and position_ids is None:
            b, s = input_ids.shape
            past = caches[0][0].shape[1]
            position_ids = torch.arange(past, past + s,
                                        device=input_ids.device).expand(b, s)
        x = self.embeddings(input_ids, position_ids)
        if caches is None:
            for layer in self.h:
                x = layer(x, attn_mask=attn_mask)
            return self.ln_f(x)
        new_caches = []
        for layer, cache in zip(self.h, caches):
            x, cache = layer(x, attn_mask=attn_mask, cache=cache)
            new_caches.append(cache)
        return self.ln_f(x), new_caches

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

    @staticmethod
    def _decode_positions(token_ids, step, pads):
        """Position ids ``[B, 1]`` of tokens at the shared cache column
        ``step`` (an int or a one-element int tensor): ``step - pads``
        clipped at 0 (left-padded rows)."""
        b = token_ids.shape[0]
        if torch.is_tensor(step):
            pos = step.reshape(1).long().expand(b)
        else:
            pos = torch.full((b,), int(step), dtype=torch.long,
                             device=token_ids.device)
        if pads is not None:
            pos = (pos - pads.long()).clamp(min=0)
        return pos[:, None]

    def decode_step(self, token_ids, step, caches, pads=None,
                    valid_cols=None):
        """One token per row ``token_ids [B, 1]`` at the shared cache
        column ``step`` over the static caches ``[B, H, max_len, D]``
        (written in place; ``gpt.py:1044-1063``): an int, checked against
        max_len, or a one-element int tensor on the device
        (`decode_cursor`). ``pads [B]`` shifts position ids of left-padded
        rows; ``valid_cols [B, max_len]`` masks their pad columns.
        Returns ``[B, 1, h]``."""
        step = decode_cursor(step, caches[0][0].shape[2], token_ids.device)
        x = self.embeddings(token_ids,
                            self._decode_positions(token_ids, step, pads))
        for layer, (kc, vc) in zip(self.h, caches):
            x = layer.forward_decode(x, kc, vc, step, valid_cols=valid_cols)
        return self.ln_f(x)

    def decode_beam_paged(self, token_ids, step, ctx_caches, pools,
                          block_table, gen_col, pads=None, pad_mask=None,
                          scales=None):
        """One beam-decode token per row of ``token_ids [B*K, 1]`` over
        the paged beam layout (``gpt.py:1219-1253``): ``ctx_caches`` the
        per-layer shared prompt K/V ``[B, H, Sp, D]``, ``pools`` the
        per-layer tail pools, ``block_table [B*K, Pg]`` the beams' page
        map (one for every layer), ``gen_col`` the gen column written
        and ``step`` the absolute position (ints, or one-element int
        tensors on the device). ``pads [B*K]`` shifts
        position ids; ``pad_mask [B, Sp]`` masks a left-padded prompt;
        ``scales`` the per-layer ``(k_scale, v_scale)`` of 1-byte pools.
        Pools and scales are written in place. Returns ``[B*K, 1, h]``."""
        x = self.embeddings(token_ids,
                            self._decode_positions(token_ids, step, pads))
        for i, (layer, (ck, cv), (pk, pv)) in enumerate(
                zip(self.h, ctx_caches, pools)):
            ks, vs = (None, None) if scales is None else scales[i]
            x = layer.forward_decode_beam_paged(
                x, ck, cv, pk, pv, block_table, gen_col, pad_mask=pad_mask,
                k_scale=ks, v_scale=vs)
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


class GPTForPretraining(GenerationMixin, nn.Module):
    """GPT with the LM head tied to the word embedding; `generate` comes
    from `models.generation.GenerationMixin`.

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
        """Logits ``[B, S, V]`` of a full sequence (tied head); with
        ``caches``, ``(logits, new_caches)`` (``gpt.py:1272-1278``)."""
        out = self.gpt(input_ids, position_ids, attn_mask, caches)
        if caches is None:
            return self._logits(out)
        return self._logits(out[0]), out[1]

    def gen_cache(self, batch_size):
        """Empty per-layer concat-grow caches ``[batch, 0, heads,
        head_dim]`` for ``forward(caches=)`` (``gpt.py:1280-1287``)."""
        cfg = self.config
        return self._zeros_per_layer(
            (batch_size, 0, cfg.num_attention_heads, cfg.head_dim),
            self.dtype)

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

    def decode_step(self, token_ids, step, caches, pads=None,
                    valid_cols=None):
        """Logits ``[B, 1, V]`` of one static-cache decode step and the
        caches (written in place; ``gpt.py:1309-1314``)."""
        return self._logits(self.gpt.decode_step(
            token_ids, step, caches, pads=pads,
            valid_cols=valid_cols)), caches

    def decode_beam_paged(self, token_ids, step, ctx_caches, pools,
                          block_table, gen_col, pads=None, pad_mask=None,
                          scales=None):
        """Logits ``[B*K, 1, V]`` of one paged beam-decode step (pools and
        scales written in place; ``gpt.py:1380-1386``)."""
        return self._logits(self.gpt.decode_beam_paged(
            token_ids, step, ctx_caches, pools, block_table, gen_col,
            pads=pads, pad_mask=pad_mask, scales=scales))

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


__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "decode_cursor",
           "decode_attention",
           "unpack_qkv_pair_major",
           "GPTAttention", "GPTMLP", "GPTDecoderLayer", "GPTEmbeddings", "GPTModel",
           "GPTForPretraining", "GPTPretrainingCriterion"]
