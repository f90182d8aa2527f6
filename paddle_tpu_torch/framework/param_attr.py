"""`ParamAttr` and the construction of every parameter.

Counterpart: ``paddle_tpu/framework/param_attr.py`` and
``paddle_tpu/ops/creation.py:300-308`` (``create_parameter``).
`build_parameter` serves `nn.Layer.create_parameter` and the top-level
`create_parameter`: it draws the parameter when the layer is built, with
the first initializer that applies:

1. the `ParamAttr`'s ``initializer``;
2. the global one (`nn.initializer.set_global_initializer`), for
   weights or biases;
3. the layer's own default (``default_initializer``);
4. ``XavierUniform`` for a weight, zeros for a bias.

The attr's ``learning_rate``, ``regularizer``, ``need_clip`` and
``trainable`` go onto the `core.Parameter`. The parameter lands on
``device``, resolved by `device.resolve_device` (``None``: the card,
raising when there is none). Under `nn.LazyGuard` it is built on the
``meta`` device and the initializer is recorded; its ``initialize()``
draws it on ``device``.
"""
from __future__ import annotations

import torch

from ..core.parameter import Parameter
from ..device import resolve_device, resolve_dtype


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """The reference's forms of an attr argument: None, False (no
        parameter), a name, an `Initializer`, or a `ParamAttr`."""
        from ..nn.initializer import Initializer

        if attr is None or attr is False or isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"Cannot convert {type(attr)} to ParamAttr")


# `nn.LazyGuard`'s switch; here so that both create_parameter forms see it
_LAZY_INIT = [False]


def build_parameter(shape, dtype, attr=None, is_bias=False,
                    default_initializer=None, name=None, device=None):
    """A `core.Parameter` of ``shape`` and ``dtype`` on ``device`` by the
    rules above, or None when ``attr`` is False."""
    from ..nn.initializer import _GLOBAL_INIT, Constant, XavierUniform

    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    if attr is not None and attr.initializer is not None:
        init = attr.initializer
    elif not is_bias and _GLOBAL_INIT["weight"] is not None:
        init = _GLOBAL_INIT["weight"]
    elif is_bias and _GLOBAL_INIT["bias"] is not None:
        init = _GLOBAL_INIT["bias"]
    elif default_initializer is not None:
        init = default_initializer
    else:
        init = Constant(0.0) if is_bias else XavierUniform()
    shape = tuple(int(s) for s in shape)
    dev = resolve_device(device)
    pname = (attr.name if attr else None) or name
    trainable = attr.trainable if attr else True
    if _LAZY_INIT[0]:
        p = Parameter(torch.empty(shape, dtype=dtype, device="meta"),
                      trainable, name=pname)
        p._init_fn = lambda: init(shape, dtype, dev)
    else:
        p = Parameter(init(shape, dtype, dev), trainable, name=pname)
    if attr is not None:
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
    return p


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, *,
                     device=None):
    """A standalone parameter (`build_parameter`); ``device=None`` is the
    card."""
    return build_parameter(shape, resolve_dtype(dtype), attr=attr,
                           is_bias=is_bias,
                           default_initializer=default_initializer,
                           name=name, device=device)


__all__ = ["ParamAttr", "build_parameter", "create_parameter"]
