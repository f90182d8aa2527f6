"""chip_smoke.py phase 26a's model, the Zaremba et al. 2014 LSTM language
model (`chip_smoke.zaremba_lm`: embedding, dropout, a 2-layer LSTM,
dropout, the output projection, every parameter U(-0.04, 0.04) through
`ParamAttr`), built from paddle_tpu and from the port at a small width
(vocabulary 50, hidden 16, 2 layers, 5 steps unrolled, batch 3), the
reference's weights carried across by `models.load_layer_state_dict`.

Both run the reference's eager loop on the same token ids (``loss =
summed cross-entropy / batch``, ``loss.backward(); opt.step();
opt.clear_grad()`` with ``SGD(1.0)`` and ``ClipGradByGlobalNorm``), the
LSTM state carried (detached) from batch to batch, dropout 0 in
training. The first step's loss within REL (1e-5) and every grad within
REL of its largest |value|; then 3 steps with the clip at 0.5, below the
first step's global norm so that it scales every step: each loss within
REL, and every parameter after them within REL of its largest |value|
(float32 throughout).
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.nn import functional as F

import _torch_fns as tf

REL = 1e-5
V, H, LAYERS, T, B = 50, 16, 2, 5, 3
CLIP = 0.5


@pytest.fixture(scope="module")
def models():
    with tf.state_kept():
        jmodel = cs.zaremba_lm(paddle_tpu, V, H, LAYERS, 0.0, 0.04)
        model = tf.twin(jmodel, lambda: cs.zaremba_lm(
            paddle_tpu_torch, V, H, LAYERS, 0.0, 0.04, device="cpu"))
    return jmodel, model


def _batches(n):
    stream = np.random.default_rng(5).integers(0, V, (B, n * T + 1))
    return [(stream[:, i * T:(i + 1) * T], stream[:, i * T + 1:(i + 1) * T
                                                  + 1]) for i in range(n)]


def _run(jmodel, model, steps, clip):
    """Both packages' loop: ``([(reference loss, port loss)] a step,
    grads of the first step by package)``."""
    jopt_ = jopt.SGD(learning_rate=1.0, parameters=jmodel.parameters(),
                     grad_clip=jnn.ClipGradByGlobalNorm(clip))
    opt = popt.SGD(learning_rate=1.0, parameters=model.parameters(),
                   grad_clip=pnn.ClipGradByGlobalNorm(clip))
    jmodel.train()
    model.train()
    jstate = state = None
    losses, first = [], None
    for ids, target in _batches(steps):
        jlogits, jstate = jmodel(JTensor(ids), jstate)
        jloss = cs.ptb_loss(JF, jlogits, JTensor(target))
        jloss.backward()
        logits, state = model(torch.from_numpy(ids), state)
        loss = cs.ptb_loss(F, logits, torch.from_numpy(target))
        loss.backward()
        if first is None:
            first = ({n: np.asarray(p.grad._value)
                      for n, p in jmodel.named_parameters()},
                     {n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()})
        jopt_.step()
        jopt_.clear_grad()
        opt.step()
        opt.clear_grad()
        jstate = tuple(s.detach() for s in jstate)
        state = tuple(s.detach() for s in state)
        losses.append((float(jloss), loss.item()))
    return losses, first


def test_loss_grads_and_three_clipped_steps(models):
    jmodel, model = models
    losses, (jgrads, grads) = _run(jmodel, model, 3, CLIP)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in jgrads.values()))
    assert norm > CLIP, norm                     # the clip scales
    assert sorted(grads) == sorted(jgrads)
    for name in jgrads:
        tf.tl.close_to_scale(grads[name], jgrads[name], REL, name)
    for want, got in losses:
        np.testing.assert_allclose(got, want, rtol=REL)
    assert abs(losses[0][0] / T - np.log(V)) < 0.5
    jparams = dict(jmodel.named_parameters())
    for name, p in model.named_parameters():
        tf.tl.close_to_scale(p.detach().numpy(),
                             np.asarray(jparams[name]._value), REL, name)


def test_the_model_at_the_published_config_is_66m_parameters():
    """The card's model (vocabulary 10000, 2 x 1500) counted from its
    shapes, built on ``meta`` (`LazyGuard`: no memory)."""
    with paddle_tpu_torch.LazyGuard():
        model = cs.zaremba_lm(paddle_tpu_torch, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == 66_034_000, n
    assert all(p.is_meta for p in model.parameters())
