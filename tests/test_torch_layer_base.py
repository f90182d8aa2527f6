"""The port's layer base (`nn.Layer`, the containers) against
paddle_tpu's: one small model in both packages, made of `Sequential`,
`LayerList` and `LayerDict` over `Linear`, `Embedding(padding_idx)`,
`Conv2D` and `LayerNorm`, with a persistable and a non-persistable
buffer. The names and order of ``named_parameters``, ``named_sublayers``,
``named_buffers`` and ``state_dict``; ``set_state_dict``'s ``(missing,
unexpected)`` and its shape error; ``to(dtype=)``; train and eval;
``apply``'s order; forward hooks that replace inputs and outputs, and
their ``remove()``; the outputs at float32 1e-6 of their scale.

The reference's weights load into the port (`models.convert`); the
inputs come from numpy. Both run on the CPU.
"""
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.random import rng_guard, step_generator
from paddle_tpu_torch.models import load_paddle_tpu_state_dict

import _torch_layers as tl

REL = 1e-6
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _rng_state_kept():
    with tl.rng_state_kept():
        yield


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = jnn.Embedding(10, 8, padding_idx=0)
        self.body = jnn.Sequential(("fc", jnn.Linear(8, 16)),
                                   ("ln", jnn.LayerNorm(16)))
        self.heads = jnn.LayerList([jnn.Linear(16, 4), jnn.Linear(16, 4)])
        self.convs = jnn.LayerDict({"a": jnn.Conv2D(1, 2, 3, padding=1)})
        self.register_buffer("count", np.arange(3, dtype=np.int64))
        self.register_buffer("scale", np.full(4, 0.5, np.float32))
        self.register_buffer("scratch", np.zeros(2, np.float32),
                             persistable=False)

    def forward(self, ids, img):
        h = self.body(self.emb(ids))
        return (self.heads[0](h) + self.heads[1](h)) * self.scale, \
            self.convs["a"](img)


class Net(pnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = pnn.Embedding(10, 8, padding_idx=0, **CPU)
        self.body = pnn.Sequential(("fc", pnn.Linear(8, 16, **CPU)),
                                   ("ln", pnn.LayerNorm(16, **CPU)))
        self.heads = pnn.LayerList([pnn.Linear(16, 4, **CPU),
                                    pnn.Linear(16, 4, **CPU)])
        self.convs = pnn.LayerDict({"a": pnn.Conv2D(1, 2, 3, padding=1,
                                                    **CPU)})
        self.register_buffer("count", np.arange(3, dtype=np.int64))
        self.register_buffer("scale", np.full(4, 0.5, np.float32))
        self.register_buffer("scratch", np.zeros(2, np.float32),
                             persistable=False)

    def forward(self, ids, img):
        h = self.body(self.emb(ids))
        return (self.heads[0](h) + self.heads[1](h)) * self.scale, \
            self.convs["a"](img)


@pytest.fixture(scope="module")
def pair():
    """``(reference, port)`` with the reference's weights in the port."""
    with tl.rng_state_kept():
        jnet = JNet()
    with rng_guard(step_generator(0, "cpu")):
        net = Net()
    load_paddle_tpu_state_dict(net, {n: np.asarray(p.numpy()) for n, p
                                     in jnet.named_parameters()})
    return jnet, net


def _inputs():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 10, (2, 5))
    ids[0, 0] = ids[1, 3] = 0                  # the padding row is read
    return ids, rng.standard_normal((2, 1, 6, 6)).astype(np.float32)


def _run(jnet, net):
    ids, img = _inputs()
    jout = [np.asarray(o.numpy()) for o in jnet(
        JTensor(jnp.asarray(ids)), JTensor(jnp.asarray(img)))]
    with torch.no_grad():
        out = [o.numpy() for o in net(torch.from_numpy(ids),
                                      torch.from_numpy(img))]
    return jout, out


def test_names_and_order_match_the_reference(pair):
    jnet, net = pair
    assert [n for n, _ in net.named_parameters()] == \
        [n for n, _ in jnet.named_parameters()]
    assert [n for n, _ in net.named_sublayers()] == \
        [n for n, _ in jnet.named_sublayers()]
    assert [n for n, _ in net.named_sublayers(include_self=True)][0] == ""
    assert len(net.sublayers(include_self=True)) == \
        len(jnet.sublayers(include_self=True)) == 10
    assert [n for n, _ in net.named_buffers()] == \
        [n for n, _ in jnet.named_buffers()] == ["count", "scale", "scratch"]
    assert list(net.state_dict()) == list(jnet.state_dict())
    assert "scratch" not in net.state_dict()
    assert isinstance(net.parameters(), list)
    assert len(net.parameters()) == len(jnet.parameters()) == 11
    assert net.heads[0].full_name().startswith("linear_")
    assert net.body[0] is net.body.fc and len(net.body[1:]) == 1
    assert list(net.convs) == ["a"] and "a" in net.convs


def test_outputs_match_the_reference(pair):
    jnet, net = pair
    jout, out = _run(jnet.eval(), net.eval())
    for got, want, what in zip(out, jout, ("heads", "conv")):
        tl.close_to_scale(got, want, REL, what)
    ids, _ = _inputs()
    assert not out[0][ids == 0].any()          # padding_idx looks up zeros
    assert not net.emb.weight[0].any()


def test_set_state_dict_reports_like_the_reference(pair):
    jnet, net = pair
    sd = OrderedDict((k, np.asarray(v.numpy()))
                     for k, v in jnet.state_dict().items())
    sd.pop("heads.1.bias")
    sd["extra.weight"] = np.zeros(3, np.float32)
    got = net.set_state_dict(sd)
    assert got == jnet.set_state_dict(sd) == (["heads.1.bias"],
                                              ["extra.weight"])
    bad = dict(sd, **{"body.fc.weight": np.zeros((16, 8), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch for body.fc"):
        jnet.set_state_dict(bad)
    with pytest.raises(ValueError, match="shape mismatch for body.fc"):
        net.set_state_dict(bad)
    jout, out = _run(jnet.eval(), net.eval())
    tl.close_to_scale(out[0], jout[0], REL, "after set_state_dict")


def test_to_dtype_train_eval_and_apply_follow_the_reference():
    jnet = JNet()
    with rng_guard(step_generator(1, "cpu")):
        net = Net()
    jnet.to(dtype="bfloat16")
    net.to(dtype="bfloat16")
    want = {k for k, v in jnet.state_dict().items()
            if v._value.dtype == jnp.bfloat16}
    got = {k for k, v in net.state_dict().items() if v.dtype ==
           torch.bfloat16}
    assert got == want == set(net.state_dict()) - {"count"}
    assert net.count.dtype == torch.int64
    assert net.scratch.dtype == torch.bfloat16
    assert net.astype("float32") is net and net.heads[1].weight.dtype == \
        torch.float32
    for m in (jnet, net):
        assert all(not s.training for s in m.eval().sublayers(True))
        assert all(s.training for s in m.train().sublayers(True))
    seen = {"j": [], "p": []}
    jnet.apply(lambda layer: seen["j"].append(type(layer).__name__))
    net.apply(lambda layer: seen["p"].append(type(layer).__name__))
    assert seen["p"][1:] == seen["j"][1:] and seen["p"][0] == "Net"
    assert seen["p"][1:4] == ["Embedding", "Sequential", "Linear"]


def test_forward_hooks_replace_inputs_and_outputs_like_the_reference(pair):
    jnet, net = pair
    base_j, base = _run(jnet.eval(), net.eval())
    handles = []
    for m in (jnet, net):
        head = m.heads[0]
        handles.append(head.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] * 2,)))
        handles.append(head.register_forward_post_hook(
            lambda layer, inputs, out: out + 1.0))
    jout, out = _run(jnet, net)
    tl.close_to_scale(out[0], jout[0], REL, "hooked")
    assert not np.allclose(out[0], base[0])
    for h in handles:
        h.remove()
    jout, out = _run(jnet, net)
    tl.close_to_scale(out[0], base[0], 0.0, "hooks removed")
    tl.close_to_scale(jout[0], base_j[0], 0.0, "reference hooks removed")
