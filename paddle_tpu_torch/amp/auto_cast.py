"""Automatic mixed precision: `auto_cast` (O1 and O2) and `decorate`.

Counterpart: ``paddle_tpu/amp/auto_cast.py``. The op lists are the
reference's, letter for letter (:27-40). Inside `auto_cast`, every op
the port names through `core.dispatch.amp_cast` casts its float tensor
arguments: a white-list op to the AMP dtype (``"bfloat16"`` by default,
or ``"float16"``), a black-list op to float32, a gray op (on neither
list) not at all, so it computes in the dtype its inputs already have
(`amp_dtype_for_op`, :61-72; ``custom_white_list`` and
``custom_black_list`` add names, the black list first). ``level`` is
kept in the state and casts the same at O1 and O2, as in the
reference: O2 is `decorate`'s work, the float parameters cast to the
AMP dtype and the optimizers set to keep float32 masters
(``_multi_precision``, :94-116).
"""
from __future__ import annotations

import contextlib

import torch

from ..core import dispatch
from ..core.dtype import convert_dtype

# ops that are numerically safe and fast in low precision (mirror of the
# reference's AmpOperators white list)
white_list = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "sdpa", "addmm",
}

# ops that must stay in fp32 (reductions / losses / norms)
black_list = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "log_softmax", "cross_entropy", "bce", "bce_logits", "nll_loss",
    "layer_norm", "batch_norm", "group_norm", "instance_norm", "rms_norm",
    "reduce_sum", "logsumexp", "norm", "dist", "cumsum", "renorm",
    "softmax_with_cross_entropy",
}


def _install_hook():
    dispatch.set_amp_hook(amp_dtype_for_op)


# this thread's state (``enabled``, ``dtype``, ``level``,
# ``custom_white``, ``custom_black``): the dispatch's own record, so
# there is one flag for whether AMP is on
amp_state = dispatch.amp_state


def amp_dtype_for_op(op_name):
    """The dtype op ``op_name``'s float inputs are cast to, or None to
    leave them alone."""
    st = amp_state()
    if not st["enabled"]:
        return None
    if op_name in black_list or op_name in st["custom_black"]:
        return torch.float32
    if op_name in white_list or op_name in st["custom_white"]:
        return st["dtype"]
    return None


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Scope of automatic casting on this thread (see the module)."""
    _install_hook()
    st = amp_state()
    prev = dict(st)
    st["enabled"] = enable
    st["dtype"] = convert_dtype(dtype) if dtype else torch.bfloat16
    st["level"] = level
    st["custom_white"] = set(custom_white_list or ())
    st["custom_black"] = set(custom_black_list or ())
    try:
        yield
    finally:
        st.update(prev)


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """At O2, cast every float parameter of ``models`` (a layer or a
    list) to ``dtype`` in place and set each optimizer to keep float32
    masters; returns ``models`` (and ``optimizers``) as given."""
    from ..nn.layer import Layer

    single_model = isinstance(models, (Layer, torch.nn.Module))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        dt = convert_dtype(dtype)
        for m in model_list:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dt)
    if optimizers is None:
        return models if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    for opt in opt_list:
        if level == "O2" and (master_weight is None or master_weight):
            opt._multi_precision = True
    return (models if single_model else model_list), \
        (optimizers if single_opt else opt_list)


__all__ = ["white_list", "black_list", "amp_state", "amp_dtype_for_op",
           "auto_cast", "amp_guard", "decorate"]
