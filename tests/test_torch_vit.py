"""The port's ViT (`models.vit`) against paddle_tpu's.

paddle_tpu's ``vit-test`` model is built from a seed, its state dict
exported as numpy and loaded into the port's (`models.convert`). Checked:

- the logits of a batch of images from a numpy seed, within 1e-5 of
  their largest |value|, and the mean cross-entropy's grads of every
  parameter within 1e-5 of the largest |grad| (float32, the same sums in
  another order);
- the state dict's round trip: the port's export loads into a fresh
  reference model, which then computes the same logits; a missing or an
  extra name is refused;
- the configs (``vit-b-16``, ``vit-l-16``, ``vit-test``) and, at ViT's
  197 tokens (224 px, patch 16), no flash branch: attention composes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.models import vit as jvit
from paddle_tpu_torch.nn import functional as pF
from paddle_tpu_torch.nn import transformer as ptr
from paddle_tpu_torch.models import (export_paddle_tpu_state_dict,
                                     load_paddle_tpu_state_dict)
from paddle_tpu_torch.models import vit

import _torch_layers as tl

REL = 1e-5
B = 3


def _jmodel(seed=5):
    paddle_tpu.seed(seed)
    return jvit.VisionTransformer(jvit.vit_config("vit-test"))


def _images(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cfg.in_channels, cfg.image_size,
                             cfg.image_size)).astype("float32")
    return x, rng.integers(0, cfg.num_classes, (B,))


def test_forward_and_grads_match_reference():
    jmodel = _jmodel()
    model = tl.port_of(jmodel, vit.VisionTransformer("vit-test",
                                                     device="cpu"))
    x, labels = _images(model.config)

    def jloss(logits):
        logp = jnp.log(jnp.exp(logits - logits.max(-1, keepdims=True)).sum(
            -1)) + logits.max(-1) - logits[jnp.arange(B), labels]
        return logp.mean()

    def loss(logits):
        return torch.nn.functional.cross_entropy(logits, tl.t(labels))

    want = tl.jax_loss_grads(jmodel, jloss, tl.jtensor(x))
    got = tl.torch_loss_grads(model, loss, tl.t(x))
    tl.close_to_scale(got[1], want[1], REL, "logits")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    tl.grads_close(got[2], want[2], REL)


def test_state_dict_round_trip():
    jmodel = _jmodel(9)
    model = tl.port_of(jmodel, vit.VisionTransformer("vit-test",
                                                     device="cpu", seed=1))
    back = export_paddle_tpu_state_dict(model)
    assert sorted(back) == sorted(tl.arrays(jmodel))
    other = _jmodel(10)
    other.set_state_dict({k: paddle_tpu.to_tensor(v)
                          for k, v in back.items()})
    x, _ = _images(model.config, 1)
    with jautograd.no_grad():
        want = np.asarray(other(tl.jtensor(x))._value)
    with torch.no_grad():
        got = model(tl.t(x)).numpy()
    tl.close_to_scale(got, want, REL)
    fresh = vit.VisionTransformer("vit-test", device="cpu")
    with pytest.raises(ValueError, match="missing"):
        load_paddle_tpu_state_dict(fresh, {k: v for k, v in back.items()
                                           if k != "pos_embed"})
    with pytest.raises(ValueError, match="unexpected"):
        load_paddle_tpu_state_dict(fresh, {**back, "extra": back["pos_embed"]})


def test_configs_and_composed_attention_at_197_tokens(monkeypatch):
    for name in ("vit-b-16", "vit-l-16", "vit-test"):
        assert vars(vit.vit_config(name)) == vars(jvit.vit_config(name))
    cfg = vit.vit_config("vit-l-16")
    assert (cfg.seq_len, cfg.hidden_size, cfg.num_layers,
            cfg.num_heads) == (197, 1024, 24, 16)
    small = vit.ViTConfig(hidden_size=32, num_layers=1, num_heads=2,
                          mlp_dim=64, num_classes=4)
    model = vit.VisionTransformer(small, device="cpu")
    seen = []
    for mod, name in ((pF, "flash_attention"),
                      (ptr, "flash_attention_qkv3")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k:
                            seen.append(1) or _r(*a, **k))
    with torch.no_grad():
        out = model(torch.randn(1, 3, 224, 224))
    assert out.shape == (1, 4) and not seen
