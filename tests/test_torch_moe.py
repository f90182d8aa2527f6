"""The port's MoE on one card (`distributed.moe`, `incubate.distributed.
models.moe`) against paddle_tpu's.

Inputs come from numpy seeds; weights from the reference's layer (its
state dict loaded through `models.convert`). Float32; values within 1e-5
of each tensor's largest |value|.

- `top_k_gating` on random logits (no ties): combine, dispatch and the
  load-balancing loss, at the default capacity and at one so small that
  tokens drop; a tie takes the lower expert first, as ``lax.top_k``;
- the dense dispatch, combine and stacked expert FFN (the tanh GELU, as
  ``jax.nn.gelu`` by default);
- `MoELayer` with `GShardGate` and stacked experts: output, aux loss and
  the grads of every parameter and of the input; the same layer with
  listed experts equals the stacked one; [S, M] input;
- the expert-parallel exchange refused by name (ROADMAP A12) but with
  ``axis_name=None``, where `moe_ffn_ep` is the reference's dense block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.incubate.distributed.models import moe as jmoe_layers
from paddle_tpu_torch.distributed import moe
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ExpertFFN, GShardGate, MoELayer, NaiveGate, SwitchGate)
from paddle_tpu_torch.models import export_paddle_tpu_state_dict

import _torch_layers as tl

REL = 1e-5
G, S, M, E, F_ = 2, 16, 8, 4, 12


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        "float32")


@pytest.mark.parametrize("k,capacity", [(2, None), (1, None), (2, 3)])
def test_top_k_gating_matches_reference(k, capacity):
    logits = _x(G, S, E) * 2
    want = jmoe.top_k_gating(jnp.asarray(logits), k=k, capacity=capacity)
    got = moe.top_k_gating(tl.t(logits), k=k, capacity=capacity)
    for a, b in zip(got, want):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            tl.close_to_scale(a.numpy(), np.asarray(b), REL)
    if capacity == 3:           # tokens past the capacity were dropped
        assert int(got[1].sum()) < G * S * k


def test_ties_take_the_lower_expert():
    logits = torch.zeros(1, 4, E)
    logits[0, :, 2] = logits[0, :, 3] = 1.0     # experts 2 and 3 tie
    combine, _, _ = moe.top_k_gating(logits, k=1, capacity=4)
    assert combine.sum(-1).argmax(-1).tolist() == [[2, 2, 2, 2]]
    want = jmoe.top_k_gating(jnp.asarray(logits.numpy()), k=1,
                             capacity=4)[0]
    np.testing.assert_array_equal(combine.numpy(), np.asarray(want))


def test_dispatch_combine_and_stacked_ffn_match_reference():
    x = _x(G, S, M)
    combine, dispatch, _ = jmoe.top_k_gating(jnp.asarray(_x(G, S, E, seed=1)))
    w1, b1 = _x(E, M, F_, seed=2), _x(E, F_, seed=3)
    w2, b2 = _x(E, F_, M, seed=4), _x(E, M, seed=5)
    jd = jmoe.moe_dispatch(jnp.asarray(x), dispatch)
    d = moe.moe_dispatch(tl.t(x), tl.t(np.asarray(dispatch)))
    tl.close_to_scale(d.numpy(), np.asarray(jd), REL)
    jo = jmoe.stacked_expert_ffn(jd, *map(jnp.asarray, (w1, b1, w2, b2)))
    o = moe.stacked_expert_ffn(d, *map(tl.t, (w1, b1, w2, b2)))
    tl.close_to_scale(o.numpy(), np.asarray(jo), REL)
    jy = jmoe.moe_combine(jo, combine)
    y = moe.moe_combine(o, tl.t(np.asarray(combine)))
    tl.close_to_scale(y.numpy(), np.asarray(jy), REL)
    # the tanh GELU, not the exact one
    h = torch.tensor([[-1.5, 0.3, 2.0]])
    assert torch.equal(moe.gelu_tanh(h), torch.nn.functional.gelu(
        h, approximate="tanh"))


def _layers():
    paddle_tpu.seed(4)
    jgate = jmoe_layers.GShardGate(M, E, capacity=(1.25, 2.5))
    jexperts = jmoe_layers.moe_layer.ExpertFFN(E, M, F_)
    jlayer = jmoe_layers.MoELayer(M, experts=jexperts, gate=jgate)
    rng = np.random.default_rng(4)
    for p in jlayer.parameters():        # non-zero biases as well
        p.set_value(paddle_tpu.to_tensor(
            (rng.standard_normal(p.shape) * 0.3).astype("float32")))
    layer = MoELayer(M, experts=ExpertFFN(E, M, F_, device="cpu"),
                     gate=GShardGate(M, E, capacity=(1.25, 2.5),
                                     device="cpu"))
    return jlayer, tl.port_of(jlayer, layer)


def test_layer_forward_aux_and_grads_match_reference():
    jlayer, layer = _layers()
    x = _x(G, S, M)
    names = [n for n, _ in jlayer.named_parameters()]
    params = {n: p._value for n, p in jlayer.named_parameters()}

    def f(p, xv):
        with jautograd.no_grad():
            y = tl.jfunctional_call(jlayer, {n: p[n] for n in names},
                                    tl.JTensor(xv))._value
        aux = jlayer.gate.loss
        aux = aux._value if hasattr(aux, "_value") else aux
        return (y ** 2).mean() + 0.1 * aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = tl.t(x).requires_grad_(True)
    ps = {n: p.detach().clone().requires_grad_(True)
          for n, p in layer.named_parameters()}
    y = torch.func.functional_call(layer, ps, (xt,))
    aux = layer.gate.loss
    ((y ** 2).mean() + 0.1 * aux).backward()
    tl.close_to_scale(y.detach().numpy(), np.asarray(jy), REL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    tl.grads_close({n: p.grad.numpy() for n, p in ps.items()},
                   {n: np.asarray(g) for n, g in jg.items()}, REL)
    tl.close_to_scale(xt.grad.numpy(), np.asarray(jgx), REL)
    back = export_paddle_tpu_state_dict(layer)
    assert sorted(back) == sorted(tl.arrays(jlayer))


class _OneExpert(torch.nn.Module):
    """One expert of an `ExpertFFN` as a module of its own: ``[g, c, m]``
    -> ``[g, c, m]``."""

    def __init__(self, stacked, i):
        super().__init__()
        self.w1, self.b1, self.w2, self.b2 = (
            torch.nn.Parameter(getattr(stacked, n)[i:i + 1].detach().clone())
            for n in ("w1", "b1", "w2", "b2"))

    def forward(self, x):
        return moe.stacked_expert_ffn(x[None], self.w1, self.b1, self.w2,
                                      self.b2)[0]


def test_listed_experts_equal_stacked_and_unbatched_input():
    _, layer = _layers()
    listed = MoELayer(M, experts=[_OneExpert(layer.experts, i)
                                  for i in range(E)], gate=layer.gate)
    assert listed.num_expert == layer.num_expert == E
    x = tl.t(_x(G, S, M, seed=8))
    with torch.no_grad():
        a, b = layer(x), listed(x)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
        one = layer(x[0])
    assert one.shape == (S, M)
    np.testing.assert_allclose(one.numpy(), a[0].numpy(), rtol=0, atol=1e-6)


def test_gates_and_the_expert_parallel_refusals():
    assert NaiveGate(M, E, world_size=2, device="cpu").weight.shape == (M,
                                                                       2 * E)
    assert SwitchGate(M, E, topk=2, device="cpu").top_k == 1
    layer = MoELayer(M, gate={"type": "switch"}, num_expert=E, d_hidden=F_,
                     device="cpu")
    assert isinstance(layer.gate, SwitchGate) and layer.num_expert == E
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        MoELayer(M, num_expert=E, d_hidden=F_, moe_group=object(),
                 device="cpu")
    d = torch.zeros(E, G, 3, M)
    assert moe.ep_exchange(d, None) is d and moe.ep_return(d, None) is d
    for fn in (moe.ep_exchange, moe.ep_return):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            fn(d)
    x, gw = _x(G, S, M), _x(M, E, seed=1)
    ws = (_x(E, M, F_, seed=2), _x(E, F_, seed=3), _x(E, F_, M, seed=4),
          _x(E, M, seed=5))
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        moe.moe_ffn_ep(tl.t(x), tl.t(gw), *map(tl.t, ws))
    y, aux = moe.moe_ffn_ep(tl.t(x), tl.t(gw), *map(tl.t, ws),
                            axis_name=None)
    jy, jaux = jmoe.moe_ffn_ep(jnp.asarray(x), jnp.asarray(gw),
                               *map(jnp.asarray, ws), axis_name=None)
    tl.close_to_scale(y.numpy(), np.asarray(jy), REL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
