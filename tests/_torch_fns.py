"""Shared helpers of the functional and layer parity tests (tests/
test_torch_activation.py, test_torch_loss.py, test_torch_norm.py,
test_torch_pooling.py, test_torch_vision_fns.py, test_torch_resnet.py,
test_torch_rnn.py, test_torch_nn_extra.py, test_torch_nn_utils_quant.py):
a reference function's output and its inputs' grads through ``jax.vjp``,
the port's through ``torch.autograd``, both with the loss ``sum(y * r)``
for one random ``r``; one pass of a reference layer and of its twin,
outputs that are trees flattened to their leaves (`ref_layer_step`,
`port_layer_step`, `step_held`); a reference layer's weights carried
into the port's twin; and a scope that puts back both packages' random
state and global initializers. Imports jax: CPU tests only."""
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


def _jwrap(v):
    """Numpy arrays in a tree of arguments as reference Tensors."""
    if isinstance(v, np.ndarray):
        return JTensor(jnp.asarray(v))
    if isinstance(v, dict):
        return {k: _jwrap(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_jwrap(x) for x in v)
    return v


def _pwrap(v):
    """Numpy arrays in a tree of arguments as torch tensors."""
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v))
    if isinstance(v, dict):
        return {k: _pwrap(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_pwrap(x) for x in v)
    return v


def jleaves(out):
    """The jax values of a tree of reference Tensors, in order."""
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in jleaves(o)]
    return [] if out is None else [out._value]


def pleaves(out):
    """The tensors of a tree of the port's outputs, in order."""
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in pleaves(o)]
    return [] if out is None else [out]


def _inputs(x):
    """``{name: array}`` of a step's differentiated inputs: ``"x"`` for
    one array, ``"input i"`` for each of a list."""
    if isinstance(x, (list, tuple)):
        return {f"input {i}": a for i, a in enumerate(x)}
    return {"x": x}


def _leaf_loss(leaves, wrap):
    """``sum_i sum(leaf_i * r_i)``, one random ``r_i`` a leaf
    (`_cotangent`, seeds 99, 100, ...), ``wrap`` making ``r_i`` the
    leaf's kind of array."""
    return sum((v * wrap(_cotangent(tuple(v.shape), 99 + i))).sum()
               for i, v in enumerate(leaves))


def ref_layer_step(jlayer, loss_of, x, train=True, kw=None):
    """``(loss, out, grads, buffers)`` of one pass of the reference layer
    in train (or eval) mode, ``jlayer(*x, **kw)``: ``loss_of(out)`` (a
    jax function of the raw output; None: `_leaf_loss` of the output's
    leaves) under one jitted ``jax.value_and_grad`` over ``x`` (one
    array, grads key ``"x"``, or a list, keys ``"input i"``) and the
    parameters (their names), the buffers fed in and the values the pass
    leaves in them read out; ``kw`` (a tree of arrays and other
    arguments) enters as constants. ``out`` is the output as numpy, or
    its leaves' list when it is a tree. The layer is evaluated under
    ``jax.ensure_compile_time_eval``, so that constants it makes stay
    constants (a max pool's -inf start, traced, has no reverse mode). Its
    own values stay as they were."""
    jlayer.train() if train else jlayer.eval()
    sd = jlayer.state_dict()
    pnames = [n for n, _ in jlayer.named_parameters()]
    bnames = [n for n in sd if n not in set(pnames)]
    xs = _inputs(x)
    jkw = _jwrap(kw or {})

    def f(diff, bufs):
        saved = {n: sd[n]._value for n in sd}
        try:
            for n in pnames:
                sd[n]._value = diff[n]
            for n in bnames:
                sd[n]._value = bufs[n]
            with jautograd.no_grad(), jax.ensure_compile_time_eval():
                out = jlayer(*[JTensor(diff[n]) for n in xs], **jkw)
            new = {n: sd[n]._value for n in bnames}
        finally:
            for n, v in saved.items():
                sd[n]._value = v
        raw = out._value if isinstance(out, JTensor) else jleaves(out)
        loss = (loss_of(raw) if loss_of is not None
                else _leaf_loss(jleaves(out), jnp.asarray))
        return loss, (raw, new)

    diff = {n: sd[n]._value for n in pnames}
    diff.update((n, jnp.asarray(a)) for n, a in xs.items())
    (loss, (out, new)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        diff, {n: sd[n]._value for n in bnames})
    out = ([np.asarray(v) for v in out] if isinstance(out, list)
           else np.asarray(out))
    return (np.asarray(loss), out,
            {n: np.asarray(g) for n, g in grads.items()},
            {n: np.asarray(v) for n, v in new.items()})


def port_layer_step(layer, loss_of, x, train=True, kw=None):
    """The port's ``(loss, out, grads, buffers)`` as `ref_layer_step`
    gives the reference's; the layer's buffers are updated as its pass
    updates them. A parameter the pass does not reach has the grad
    None (`step_held` then wants the reference's to be zero)."""
    layer.train(train)
    layer.zero_grad(set_to_none=True)
    ts = {n: torch.tensor(a, requires_grad=True)
          for n, a in _inputs(x).items()}
    out = layer(*ts.values(), **_pwrap(kw or {}))
    tree = not isinstance(out, torch.Tensor)
    loss = (loss_of(out) if loss_of is not None
            else _leaf_loss(pleaves(out), torch.from_numpy))
    loss.backward()
    grads = {n: None if p.grad is None else p.grad.numpy()
             for n, p in layer.named_parameters()}
    grads.update((n, t.grad.numpy()) for n, t in ts.items())
    bufs = {n: b.numpy().copy() for n, b in layer.named_buffers()}
    out = ([v.detach().numpy() for v in pleaves(out)] if tree
           else out.detach().numpy())
    return loss.detach().numpy(), out, grads, bufs


def step_held(got, want, rel, what="", names=None):
    """Two layer steps' (`port_layer_step`'s and `ref_layer_step`'s)
    outputs and grads within ``rel`` of each tensor's largest |value|
    (`_torch_layers.close_to_scale`); a grad the port has as None must
    be zero in the reference. ``names`` (the port layer) keeps only the
    reference's grads of its parameters and the inputs."""
    (_, gout, gg, _), (_, wout, wg, _) = got, want
    gl = gout if isinstance(gout, list) else [gout]
    wl = wout if isinstance(wout, list) else [wout]
    assert len(gl) == len(wl), (what, len(gl), len(wl))
    for i, (a, b) in enumerate(zip(gl, wl)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        tl.close_to_scale(a, b, rel, f"{what} output leaf {i}")
    if names is not None:
        keep = dict(names.named_parameters())
        wg = {n: g for n, g in wg.items()
              if n in keep or n == "x" or n.startswith("input ")}
    assert sorted(gg) == sorted(wg), (what, sorted(gg), sorted(wg))
    for name in wg:
        if gg[name] is None:
            assert not np.any(wg[name]), (what, name, "no grad in the port")
        else:
            tl.close_to_scale(gg[name], wg[name], rel, f"{what} grad {name}")


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
