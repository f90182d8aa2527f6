"""Shared helpers of the layer parity tests (tests/test_torch_conv.py,
test_torch_vit.py, test_torch_transformer_decoder.py,
test_torch_fused_mt.py, test_torch_moe.py, test_torch_layer_base.py,
test_torch_initializer.py, test_torch_param_attr.py): a paddle_tpu
layer's weights as numpy, its loss and gradients through
``jax.value_and_grad`` over its parameters, the port's through
``torch.autograd``, the bound both are held to, and a scope that puts
back both packages' default random state. Imports jax: CPU tests
only."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import functional_call

from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core import random as jrandom
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit.api import functional_call as jfunctional_call

from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.models import load_paddle_tpu_state_dict


def arrays(jmodel):
    """paddle_tpu's ``state_dict()`` as numpy arrays."""
    return {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}


def port_of(jmodel, model):
    """``model`` (the port's twin of ``jmodel``) with ``jmodel``'s
    weights, in eval mode."""
    load_paddle_tpu_state_dict(model, arrays(jmodel))
    return model.eval()


def jtensor(x):
    return JTensor(jnp.asarray(x))


def jax_loss_grads(jmodel, loss_of, *args, **kwargs):
    """``(loss, out, grads)`` of ``loss_of(out)`` where ``out`` is
    ``jmodel(*args, **kwargs)`` run on its own parameters under
    ``jax.value_and_grad``, jitted as one program (op by op, each of the
    reference's ops would compile on its own): numpy arrays, ``grads``
    keyed by name.
    ``loss_of`` takes and returns jax values; ``out`` is the first output
    when the model returns a tuple."""
    names = [n for n, _ in jmodel.named_parameters()]
    params = {n: p._value for n, p in jmodel.named_parameters()}

    def f(p):
        with jautograd.no_grad():
            out = jfunctional_call(jmodel, {n: p[n] for n in names}, *args,
                                   **kwargs)
        out = (out[0] if isinstance(out, tuple) else out)._value
        return loss_of(out), out

    (loss, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    return (np.asarray(loss), np.asarray(out),
            {n: np.asarray(g) for n, g in grads.items()})


def torch_loss_grads(model, loss_of, *args, **kwargs):
    """The port's ``(loss, out, grads)`` as `jax_loss_grads` gives the
    reference's, through ``torch.func.functional_call``."""
    params = {n: p.detach().clone().requires_grad_(True)
              for n, p in model.named_parameters()}
    out = functional_call(model, params, args, kwargs)
    out = out[0] if isinstance(out, tuple) else out
    loss = loss_of(out)
    loss.backward()
    return (loss.detach().numpy(), out.detach().numpy(),
            {n: p.grad.numpy() for n, p in params.items()})


def close_to_scale(got, want, rel, what=""):
    """Each element of ``got`` within ``rel`` of ``want``'s largest
    |value| (float32 summation order at the tensor's own scale)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def grads_close(got, want, rel, zero_atol=1e-6):
    """Each gradient within ``rel`` of its own largest |value|
    (`close_to_scale`). The key projections' biases are held apart: their
    true gradient is exactly 0 (softmax does not see a constant added to
    a row's scores), so both sides hold only round-off, which their own
    scale would magnify; both are held within ``zero_atol`` of 0."""
    assert sorted(got) == sorted(want)
    for name in want:
        if name.endswith("k_proj.bias"):
            assert np.abs(want[name]).max() < zero_atol, name
            assert np.abs(got[name]).max() < zero_atol, name
        else:
            close_to_scale(got[name], want[name], rel, name)


def t(x):
    return torch.from_numpy(np.array(x))


@contextlib.contextmanager
def rng_state_kept():
    """Inside, draws may advance either package's default generators;
    on exit each is put back (a default the port made inside is
    dropped)."""
    jstate = jrandom.get_rng_state()
    with prandom._DEFAULTS_LOCK:
        pstate = {k: g.get_state() for k, g in prandom._DEFAULTS.items()}
    try:
        yield
    finally:
        jrandom.set_rng_state(jstate)
        with prandom._DEFAULTS_LOCK:
            for k in list(prandom._DEFAULTS):
                if k in pstate:
                    prandom._DEFAULTS[k].set_state(pstate[k])
                else:
                    del prandom._DEFAULTS[k]
