"""The op namespace: every tensor op of the reference's ``paddle.*``.

Counterpart: ``paddle_tpu/ops/__init__.py:1-26``, assembled the same
way: the public functions of `creation`, `math`, `manip` and `linalg`
(but the names of ``_SKIP``) make up the namespace and ``__all__``, and
`methods.install` adds the reference's Tensor methods that torch lacks
to ``torch.Tensor``.
"""
from . import creation, linalg, manip, math, methods  # noqa: F401

_SKIP = {"builtins_sum", "builtins_slice", "cond_trace", "Tensor", "apply_op",
         "convert_dtype", "next_key", "jax", "jnp", "np", "builtins", "weakref"}


def _collect(mod):
    out = {}
    for name in dir(mod):
        if name.startswith("_") or name in _SKIP:
            continue
        fn = getattr(mod, name)
        if callable(fn) and not isinstance(fn, type) and not hasattr(fn, "__path__"):
            out[name] = fn
    return out


_namespace = {}
for _mod in (creation, math, manip, linalg):
    _namespace.update(_collect(_mod))

globals().update(_namespace)
__all__ = sorted(_namespace)

methods.install()
