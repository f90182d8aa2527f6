"""Shared helpers of the functional parity tests (tests/test_torch_
activation.py, test_torch_loss.py, test_torch_norm.py,
test_torch_pooling.py, test_torch_vision_fns.py, test_torch_resnet.py):
a reference function's output and its inputs' grads through ``jax.vjp``,
the port's through ``torch.autograd``, both with the loss ``sum(y * r)``
for one random ``r``; a reference layer's weights carried into the
port's twin; and a scope that puts back both packages' random state and
global initializers. Imports jax: CPU tests only."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import initializer as jinit
from paddle_tpu_torch.core.random import rng_guard, step_generator
from paddle_tpu_torch.models import load_layer_state_dict
from paddle_tpu_torch.nn import initializer as pinit

import _torch_layers as tl


@contextlib.contextmanager
def state_kept():
    """`_torch_layers.rng_state_kept`, and both packages' global
    initializers and numpy's global random state (the reference's
    `SpectralNorm` draws from it) put back on exit."""
    saved = dict(jinit._GLOBAL_INIT), dict(pinit._GLOBAL_INIT)
    np_state = np.random.get_state()
    try:
        with tl.rng_state_kept():
            yield
    finally:
        jinit._GLOBAL_INIT.update(saved[0])
        pinit._GLOBAL_INIT.update(saved[1])
        np.random.set_state(np_state)


def randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype("float32")


def _cotangent(shape, seed=99):
    return np.asarray(randn(tuple(shape), seed))


def ref_vjp(jfn, arrays, diff, jit=True, **kw):
    """``(y, grads)`` of the reference's ``jfn(*arrays, **kw)``: ``y`` as
    numpy, ``grads`` the grads of ``sum(y * r)`` w.r.t. ``arrays[i]`` for
    ``i`` in ``diff`` (the other arrays enter as constants, anything
    that is not an array as it is). ``jit=False`` runs
    the reference op by op, as its own eager autograd does (a max pool's
    ``reduce_window`` has no reverse mode under ``jit``: its -inf start
    is then a traced value)."""
    consts = {i: JTensor(jnp.asarray(a)) if isinstance(a, np.ndarray) else a
              for i, a in enumerate(arrays) if i not in diff}

    def f(*vals):
        it = iter(vals)
        args = [consts[i] if i in consts else JTensor(next(it))
                for i in range(len(arrays))]
        with jautograd.no_grad():
            return jfn(*args, **kw)._value

    if jit:
        f = jax.jit(f)
    y, pull = jax.vjp(f, *[jnp.asarray(arrays[i]) for i in diff])
    r = _cotangent(y.shape).astype(np.asarray(y).dtype)
    return np.asarray(y), [np.asarray(g) for g in pull(jnp.asarray(r))]


def port_vjp(pfn, arrays, diff, **kw):
    """The port's ``(y, grads)`` as `ref_vjp` gives the reference's."""
    ts = [torch.tensor(a, requires_grad=i in diff)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(arrays)]
    y = pfn(*ts, **kw)
    r = torch.from_numpy(_cotangent(tuple(y.shape))).to(y.dtype)
    if diff:
        (y * r).sum().backward()
    return y.detach().numpy(), [ts[i].grad.numpy() for i in diff]


def held(got, want, rel, what=""):
    """`ref_vjp`'s and `port_vjp`'s results within ``rel`` of each
    tensor's largest |value| (`_torch_layers.close_to_scale`)."""
    (gy, gg), (wy, wg) = got, want
    assert gy.shape == wy.shape, (what, gy.shape, wy.shape)
    tl.close_to_scale(gy, wy, rel, f"{what} y")
    for i, (g, w) in enumerate(zip(gg, wg)):
        tl.close_to_scale(g, w, rel, f"{what} grad {i}")


def both(jfn, pfn, arrays, diff, rel, jit=True, **kw):
    """The reference and the port on the same arrays, held (`held`)."""
    held(port_vjp(pfn, arrays, diff, **kw),
         ref_vjp(jfn, arrays, diff, jit=jit, **kw), rel, pfn.__name__)


def ref_layer_step(jlayer, loss_of, x, train=True):
    """``(loss, out, grads, buffers)`` of one pass of the reference layer
    in train (or eval) mode: ``loss_of(out)`` (a jax function of the raw
    output) under one jitted ``jax.value_and_grad`` over ``x`` (grads key
    ``"x"``) and the parameters (their names), the buffers fed in and the
    values the pass leaves in them read out. The layer is evaluated under
    ``jax.ensure_compile_time_eval``, so that constants it makes stay
    constants (a max pool's -inf start, traced, has no reverse mode). Its
    own values stay as they were."""
    jlayer.train() if train else jlayer.eval()
    sd = jlayer.state_dict()
    pnames = [n for n, _ in jlayer.named_parameters()]
    bnames = [n for n in sd if n not in set(pnames)]

    def f(diff, bufs):
        saved = {n: sd[n]._value for n in sd}
        try:
            for n in pnames:
                sd[n]._value = diff[n]
            for n in bnames:
                sd[n]._value = bufs[n]
            with jautograd.no_grad(), jax.ensure_compile_time_eval():
                out = jlayer(JTensor(diff["x"]))._value
            new = {n: sd[n]._value for n in bnames}
        finally:
            for n, v in saved.items():
                sd[n]._value = v
        return loss_of(out), (out, new)

    diff = {n: sd[n]._value for n in pnames}
    diff["x"] = jnp.asarray(x)
    (loss, (out, new)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        diff, {n: sd[n]._value for n in bnames})
    return (np.asarray(loss), np.asarray(out),
            {n: np.asarray(g) for n, g in grads.items()},
            {n: np.asarray(v) for n, v in new.items()})


def port_layer_step(layer, loss_of, x, train=True):
    """The port's ``(loss, out, grads, buffers)`` as `ref_layer_step`
    gives the reference's; the layer's buffers are updated as its pass
    updates them."""
    layer.train(train)
    layer.zero_grad()
    xt = torch.tensor(x, requires_grad=True)
    out = layer(xt)
    loss = loss_of(out)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    grads["x"] = xt.grad.numpy()
    bufs = {n: b.numpy().copy() for n, b in layer.named_buffers()}
    return loss.detach().numpy(), out.detach().numpy(), grads, bufs


def twin(jlayer, make):
    """``make()`` (the port's layer, built on the CPU) with ``jlayer``'s
    parameters and buffers (`models.load_layer_state_dict`)."""
    with rng_guard(step_generator(0, "cpu")):
        layer = make()
    return load_layer_state_dict(layer, tl.arrays(jlayer))


def layer_forward(jlayer, layer, *arrays):
    """Both layers' outputs on the same arrays, as numpy."""
    with jautograd.no_grad():
        want = jlayer(*[JTensor(jnp.asarray(a)) for a in arrays])
    with torch.no_grad():
        got = layer(*[torch.from_numpy(np.array(a)) for a in arrays])
    return got.numpy(), np.asarray(want._value)
