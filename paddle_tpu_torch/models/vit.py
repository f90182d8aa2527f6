"""Vision Transformer (ViT).

Counterpart: ``paddle_tpu/models/vit.py``: a patch embedding (a
`nn.Conv2D` whose stride is the patch size), a class token and learned
positions, pre-LN `nn.TransformerEncoderLayer`s with GELU, a final
LayerNorm and a linear head on the class token. BASELINE.md's row 5 is
ViT-L/16 (``vit-l-16``).

Attention takes the layers' own gates, as in the reference: at 224 px
and patch 16 the sequence is 197 tokens, not a multiple of 128, so
neither the qkv-direct branch nor the flash gate of
``nn.functional.scaled_dot_product_attention`` takes it, and attention
composes (``paddle_tpu/kernels/__init__.py:148-162``). No kernel of the
port runs in ViT.

The parameter names and layouts are the reference's (the conv weight
OIHW, ``Linear`` weights ``[in, out]``), so a ``paddle_tpu`` state dict
loads key for key (`models.convert`). A model is built in eval mode with
parameters that do not require grad, its weights drawn from ``seed``
(normal, std 0.02; biases zero, LayerNorm scales one); training runs it
through `distributed.SpmdTrainStep`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from ..framework.param_attr import create_parameter
from ..nn import (Dropout, LayerNorm, Linear, TransformerEncoderLayer,
                  init_weights)
from ..nn.conv import Conv2D

#: std of the random init
INIT_STD = 0.02


@dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout: float = 0.0
    attention_dropout: float = 0.0
    num_classes: int = 1000
    in_channels: int = 3

    @property
    def seq_len(self):
        """Patches plus the class token."""
        return (self.image_size // self.patch_size) ** 2 + 1


VIT_CONFIGS = {
    "vit-b-16": dict(hidden_size=768, num_layers=12, num_heads=12,
                     mlp_dim=3072),
    "vit-l-16": dict(hidden_size=1024, num_layers=24, num_heads=16,
                     mlp_dim=4096),
    "vit-test": dict(image_size=32, patch_size=8, hidden_size=32,
                     num_layers=2, num_heads=2, mlp_dim=64, num_classes=10),
}


def vit_config(name: str) -> ViTConfig:
    return ViTConfig(**VIT_CONFIGS[name])


class PatchEmbed(nn.Module):
    """``[B, C, H, W]`` images -> ``[B, patches, hidden]``: a conv of
    kernel and stride ``patch_size``, its grid flattened row-major."""

    def __init__(self, cfg: ViTConfig, *, device, dtype):
        super().__init__()
        self.proj = Conv2D(cfg.in_channels, cfg.hidden_size,
                           kernel_size=cfg.patch_size,
                           stride=cfg.patch_size, device=device, dtype=dtype)
        self.num_patches = (cfg.image_size // cfg.patch_size) ** 2

    def forward(self, x):
        x = self.proj(x)                       # [B, hidden, gh, gw]
        return x.flatten(2).transpose(1, 2)    # [B, patches, hidden]


class VisionTransformer(nn.Module):
    """``forward(images [B, C, H, W]) -> logits [B, num_classes]`` (the
    class token's final hidden state when ``num_classes`` is 0).
    ``config``: a `ViTConfig` or a `VIT_CONFIGS` name. ``device``:
    ``None`` means ``cuda`` (raises without a GPU)."""

    _init_normal = ("cls_token", "pos_embed")

    def __init__(self, config, *, device=None, dtype="float32", seed=0):
        super().__init__()
        cfg = vit_config(config) if isinstance(config, str) else config
        kw = dict(device=resolve_device(device), dtype=resolve_dtype(dtype))
        self.config = cfg
        self.patch_embed = PatchEmbed(cfg, **kw)
        n = self.patch_embed.num_patches
        self.cls_token = create_parameter([1, 1, cfg.hidden_size], **kw)
        self.pos_embed = create_parameter([1, n + 1, cfg.hidden_size], **kw)
        self.pos_drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList([TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.mlp_dim, dropout=cfg.dropout,
            activation="gelu", attn_dropout=cfg.attention_dropout,
            act_dropout=0.0, normalize_before=True, **kw)
            for _ in range(cfg.num_layers)])
        self.norm = LayerNorm(cfg.hidden_size, **kw)
        if cfg.num_classes > 0:
            self.head = Linear(cfg.hidden_size, cfg.num_classes, **kw)
        init_weights(self, seed, INIT_STD)
        self.requires_grad_(False)
        self.eval()

    def forward(self, x):
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], 1, self.config.hidden_size)
        x = self.pos_drop(torch.cat([cls, x], dim=1) + self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        if self.config.num_classes > 0:
            return self.head(x[:, 0])
        return x[:, 0]


def vit_b_16(**kwargs):
    """ViT-B/16; ``kwargs``: `VisionTransformer`'s ``device``, ``dtype``
    and ``seed``."""
    return VisionTransformer(vit_config("vit-b-16"), **kwargs)


def vit_l_16(**kwargs):
    """ViT-L/16 (BASELINE.md row 5); ``kwargs`` as `vit_b_16`."""
    return VisionTransformer(vit_config("vit-l-16"), **kwargs)


__all__ = ["ViTConfig", "VIT_CONFIGS", "vit_config", "PatchEmbed",
           "VisionTransformer", "vit_b_16", "vit_l_16"]
