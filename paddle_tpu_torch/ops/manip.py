"""Shape and layout manipulation, gather and scatter, search and sort.

Counterpart: ``paddle_tpu/ops/manip.py:21-706``. Each op computes in
torch on its tensors' device, with the reference's meanings where the
same name means something else in torch: `split` takes a number of
sections, `gather` is a take along ``axis``, ``scatter(overwrite=False)``
zeroes the target rows and then accumulates, `transpose` takes a
permutation, `unique` returns int64 index outputs. The in-place forms
(`reshape_`, `scatter_`, `index_add_`) write ``x``; `reshape_` changes
its shape outside autograd, as torch has no in-place reshape. Ops whose
output shape depends on the data (`masked_select`, `nonzero`, `unique`,
`unique_consecutive`) read a count back to the host, as torch's do.

``slice`` shadows the builtin: code below it uses ``builtins.slice``.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dispatch
from ..core.dtype import convert_dtype


def _shape_arg(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    return tuple(int(s) for s in shape)


def _int(v):
    return int(v.item() if isinstance(v, torch.Tensor) else v)


def _index(index, like):
    """``index`` as an int64 tensor on ``like``'s device."""
    if isinstance(index, torch.Tensor):
        return index.long().to(like.device)
    return torch.as_tensor(np.asarray(index), dtype=torch.int64,
                           device=like.device)


def reshape(x, shape, name=None):
    return torch.reshape(x, _shape_arg(shape))


def _rebind(x, out):
    """``x`` made to hold ``out``'s values and shape (outside autograd)."""
    x.data = out.detach()
    return x


def reshape_(x, shape, name=None):
    return _rebind(x, reshape(x, shape))


def transpose(x, perm, name=None):
    return x.permute(*perm)


def t(x, name=None):
    return x.permute(*reversed(range(x.ndim)))


def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis1, axis2, name=None):
    return torch.swapaxes(x, axis1, axis2)


def _squeeze_axes(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return tuple(a % x.ndim for a in axes if x.shape[a % x.ndim] == 1)


def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    axes = _squeeze_axes(x, axis)
    return torch.squeeze(x, axes) if axes else x


def _unsqueeze_axes(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return sorted(a % (x.ndim + len(axes)) if a < 0 else a for a in axes)


def unsqueeze(x, axis, name=None):
    out = x
    for a in _unsqueeze_axes(x, axis):
        out = out.unsqueeze(a)
    return out


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return torch.reshape(x, tuple(x.shape[:s]) + (-1,)
                         + tuple(x.shape[e + 1:]))


def concat(x, axis=0, name=None):
    return torch.cat(list(x), dim=_int(axis))


def stack(x, axis=0, name=None):
    return torch.stack(list(x), dim=axis)


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` equal parts (an int), or parts of the listed
    sizes (one of them may be -1: the rest)."""
    ax = _int(axis)
    total = x.shape[ax]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: {total} along axis {ax} does not "
                             f"divide into {num_or_sections} equal parts")
        return list(torch.split(x, total // num_or_sections, dim=ax))
    sections = [_int(s) for s in num_or_sections]
    if builtins.any(s == -1 for s in sections):
        known = builtins.sum(s for s in sections if s != -1)
        sections = [total - known if s == -1 else s for s in sections]
    return list(torch.split(x, sections, dim=ax))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(x, axis))


unstack = unbind


def tile(x, repeat_times, name=None):
    return torch.tile(x, _shape_arg(repeat_times))


def expand(x, shape, name=None):
    """``x`` broadcast to ``shape``; -1 keeps ``x``'s size there."""
    tgt = list(_shape_arg(shape))
    off = len(tgt) - x.ndim
    for i in range(len(tgt)):
        if tgt[i] == -1:
            tgt[i] = x.shape[i - off]
    return torch.broadcast_to(x, tuple(tgt))


broadcast_to = expand


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [expand(t, shape) for t in inputs]


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def flip(x, axis, name=None):
    if axis is None:
        axis = tuple(range(x.ndim))
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(x, list(axes))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


def roll(x, shifts, axis=None, name=None):
    return torch.roll(x, shifts, axis)


def cast(x, dtype):
    return x.to(convert_dtype(dtype))


def slice(x, axes, starts, ends, name=None):
    idx = [builtins.slice(None)] * x.ndim
    for a, s, e in zip(axes, starts, ends):
        idx[a] = builtins.slice(_int(s), _int(e))
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing along ``axes``; a negative stride walks back (an
    index gather: torch slices take positive steps only)."""
    out = x
    for a, s, e, st in zip(axes, starts, ends, strides):
        s, e, st = _int(s), _int(e), _int(st)
        if st > 0:
            idx = [builtins.slice(None)] * out.ndim
            idx[a] = builtins.slice(s, e, st)
            out = out[tuple(idx)]
        else:
            rows = range(*builtins.slice(s, e, st).indices(out.shape[a]))
            out = torch.index_select(out, a, torch.tensor(
                list(rows), dtype=torch.int64, device=out.device))
    return out


def crop(x, shape=None, offsets=None, name=None):
    shp = _shape_arg(shape)
    offs = [0] * len(shp) if offsets is None else [_int(o) for o in offsets]
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))]


def _pad_rows(n, before, after, mode, device):
    """The source row of each padded row along a dim of ``n`` rows, for
    jnp.pad's ``edge``, ``wrap`` and ``reflect`` modes."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i.abs(), period)
    return torch.where(j < n, j, period - j)


def _pad_widths(x, pad, data_format):
    p = pad.tolist() if isinstance(pad, torch.Tensor) else [_int(q)
                                                            for q in pad]
    p = [int(q) for q in p]
    if len(p) == 2 * x.ndim:
        return [(p[2 * i], p[2 * i + 1]) for i in range(x.ndim)]
    n_spatial = len(p) // 2
    widths = [(0, 0)] * x.ndim
    if data_format.startswith("N") and data_format.endswith("C"):
        dims = list(range(1, 1 + n_spatial))
    else:
        dims = list(range(x.ndim - n_spatial, x.ndim))
    for i, d in enumerate(dims):
        widths[d] = (p[2 * i], p[2 * i + 1])
    return widths


def _pad_by_widths(x, widths, mode, value=0.0):
    jmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]
    if jmode == "constant":
        flat = [w for pair in reversed(widths) for w in pair]
        return torch.nn.functional.pad(x, flat, value=value)
    out = x
    for d, (a, b) in enumerate(widths):
        if a or b:
            out = torch.index_select(out, d, _pad_rows(
                out.shape[d], a, b, jmode, out.device))
    return out


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``jnp.pad`` of ``x``: ``pad`` holds (before, after) pairs for every
    dim, or for the spatial dims of ``data_format``."""
    return _pad_by_widths(x, _pad_widths(x, pad, data_format), mode, value)


# -- gather / scatter -------------------------------------------------------

def gather(x, index, axis=0, name=None):
    """Rows ``index`` of ``x`` along ``axis`` (``jnp.take``; torch's
    ``gather`` is ``take_along_axis``)."""
    ax = _int(axis)
    idx = _index(index, x)
    if idx.ndim == 0:
        return x.select(ax, int(idx))
    return torch.index_select(x, ax, idx.reshape(-1))


def gather_nd(x, index, name=None):
    idx = _index(index, x)
    return x[tuple(idx.unbind(-1))]


def _scatter(v, idx, u, overwrite):
    if overwrite:
        return v.index_put((idx,), u)
    z = v.index_put((idx,), torch.zeros_like(u))
    return z.index_put((idx,), u, accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` set to ``updates``; with ``overwrite=False``
    the rows are zeroed and every update added (duplicates sum)."""
    return _scatter(x, _index(index, x).reshape(-1), updates, overwrite)


def scatter_(x, index, updates, overwrite=True, name=None):
    idx = _index(index, x).reshape(-1)
    if overwrite:
        return x.index_put_((idx,), updates)
    x.index_put_((idx,), torch.zeros_like(updates))
    return x.index_put_((idx,), updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    idx = _index(index, x)
    return x.index_put(tuple(idx.unbind(-1)), updates, accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    zeros = torch.zeros(_shape_arg(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


def index_select(x, index, axis=0, name=None):
    idx = _index(index, x)
    out = torch.index_select(x, axis, idx.reshape(-1))
    ax = axis % x.ndim
    return out.reshape(tuple(x.shape[:ax]) + tuple(idx.shape)
                       + tuple(x.shape[ax + 1:]))


def index_sample(x, index, name=None):
    return torch.gather(x, 1, _index(index, x))


def index_add(x, index, axis, value, name=None):
    return x.index_add(axis, _index(index, x), value)


def index_add_(x, index, axis, value, name=None):
    return x.index_add_(axis, _index(index, x), value)


def index_put(x, indices, value, accumulate=False, name=None):
    idx = tuple(i.to(x.device) if isinstance(i, torch.Tensor)
                else _index(i, x) for i in indices)
    value = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        value, dtype=x.dtype, device=x.device)
    return x.index_put(idx, value.to(x.dtype), accumulate=accumulate)


def take_along_axis(arr, indices, axis, name=None):
    return torch.take_along_dim(arr, _index(indices, arr), dim=axis)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    idx = _index(indices, arr)
    if isinstance(values, torch.Tensor) and values.ndim:
        val = torch.broadcast_to(values.to(arr.dtype), idx.shape)
    else:
        val = torch.full(idx.shape, values.item() if isinstance(
            values, torch.Tensor) else values, dtype=arr.dtype,
            device=arr.device)
    if reduce == "assign":
        return arr.scatter(axis, idx, val)
    if reduce == "add":
        return arr.scatter_add(axis, idx, val)
    if reduce in ("multiply", "mul"):
        return arr.scatter_reduce(axis, idx, val, "prod")
    raise ValueError(f"unsupported reduce: {reduce}")


def masked_select(x, mask, name=None):
    return torch.masked_select(x, mask.to(x.device))


def masked_fill(x, mask, value, name=None):
    val = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        value, device=x.device)
    return torch.where(mask.to(x.device), val.to(x.dtype), x)


def repeat_interleave(x, repeats, axis=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.repeat_interleave(x, repeats, dim=axis)


def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    return torch.stack([x.real, x.imag], dim=-1)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.view(convert_dtype(shape_or_dtype))


view_as = expand_as


def _atleast(fn, inputs):
    outs = [fn(t if isinstance(t, torch.Tensor) else torch.as_tensor(t))
            for t in inputs]
    return outs if len(outs) > 1 else outs[0]


def atleast_1d(*inputs):
    return _atleast(torch.atleast_1d, inputs)


def atleast_2d(*inputs):
    return _atleast(torch.atleast_2d, inputs)


def atleast_3d(*inputs):
    return _atleast(torch.atleast_3d, inputs)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


# -- search / sort ----------------------------------------------------------

def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1), 0)
        out = out.reshape((1,) * x.ndim) if keepdim else out
    else:
        out = fn(x, axis, keepdim=keepdim)
    return out.to(convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    """Stable: equal values keep their order, descending too."""
    return torch.sort(x, dim=axis, descending=descending, stable=True).indices


def sort(x, axis=-1, descending=False, name=None):
    return torch.sort(x, dim=axis, descending=descending, stable=True).values


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """The ``k`` largest (or smallest) along ``axis``, values and int64
    indices, in order (ties: the lower index first)."""
    kk = _int(k)
    s = torch.sort(x, dim=axis, descending=largest, stable=True)
    return (s.values.narrow(axis, 0, kk),
            s.indices.narrow(axis, 0, kk))


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    ax = axis % x.ndim
    s = torch.sort(x, dim=ax, stable=True)
    vals = s.values.select(ax, k - 1)
    idx = s.indices.select(ax, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among equally
    frequent ones) and the index of its first occurrence."""
    ax = axis % x.ndim
    moved = torch.movedim(torch.sort(x, dim=ax).values, ax, -1)
    n = moved.shape[-1]
    eq = moved[..., 1:] == moved[..., :-1]
    pos = torch.arange(n - 1, device=x.device)
    last_break = torch.cummax(torch.where(eq, torch.full_like(pos, -1), pos),
                              -1).values
    runs = torch.where(eq, pos - last_break, torch.zeros_like(pos))
    runs = torch.cat([torch.zeros_like(runs[..., :1]), runs], -1)
    best = torch.argmax(runs, dim=-1)
    vals = torch.gather(moved, -1, best[..., None])[..., 0]
    idx = torch.argmax((torch.movedim(x, ax, -1) == vals[..., None]).int(),
                       dim=-1)
    if keepdim:
        vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
    return vals, idx


def nonzero(x, as_tuple=False, name=None):
    idx = torch.nonzero(x)
    if as_tuple:
        return tuple(idx[:, i:i + 1] for i in range(idx.shape[1]))
    return idx


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def _first_index(inverse, n):
    """The first position of each of ``n`` groups in ``inverse``."""
    pos = torch.arange(inverse.numel(), device=inverse.device)
    first = torch.full((n,), inverse.numel(), dtype=torch.int64,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Sorted unique values (along ``axis``: unique slices), and as asked
    the first index, the inverse and the counts, all int64
    (``np.unique``)."""
    out, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                    return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return out
    rets = [out]
    if return_index:
        rets.append(_first_index(inv, out.shape[0 if axis is None
                                                else axis]))
    if return_inverse:
        rets.append(inv)
    if return_counts:
        rets.append(counts)
    return tuple(rets)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    flat = x.reshape(-1) if axis is None or x.ndim == 1 else x
    dim = None if axis is None or x.ndim == 1 else axis
    out, inv, counts = torch.unique_consecutive(
        flat, return_inverse=True, return_counts=True, dim=dim)
    rets = [out]
    if return_inverse:
        rets.append(inv)
    if return_counts:
        rets.append(counts)
    return rets[0] if len(rets) == 1 else tuple(rets)


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts in ``bins`` equal bins over [min, max] (both 0: the data's
    range), int64."""
    v = input if input.is_floating_point() else input.double()
    return torch.histc(v, bins=bins, min=min, max=max).to(torch.int64)


def bincount(x, weights=None, minlength=0, name=None):
    out = torch.bincount(x, weights=weights, minlength=minlength)
    return out if weights is None else out.to(weights.dtype)


def _edge(e, x, axis):
    """A prepended or appended number, or tensor, shaped for torch.diff."""
    if e is None:
        return e
    e = torch.as_tensor(e, dtype=x.dtype, device=x.device)
    if e.ndim == x.ndim:
        return e
    shape = list(x.shape)
    shape[axis] = 1
    return e.expand(shape)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n, axis, _edge(prepend, x, axis),
                      _edge(append, x, axis))


def unflatten(x, axis, shape, name=None):
    ax = axis % x.ndim
    return x.reshape(tuple(x.shape[:ax]) + tuple(int(s) for s in shape)
                     + tuple(x.shape[ax + 1:]))


def vander(x, n=None, increasing=False, name=None):
    cols = x.shape[0] if n is None else n
    p = torch.arange(cols, device=x.device)
    if not increasing:
        p = p.flip(0)
    return torch.pow(x[:, None], p[None, :])


def renorm(x, p, axis, max_norm, name=None):
    """Each sub-tensor along ``axis`` scaled so its ``p``-norm is at most
    ``max_norm``."""
    (v,) = dispatch.amp_cast("renorm", x)
    ax = axis % v.ndim
    red = tuple(i for i in range(v.ndim) if i != ax)
    norms = torch.sum(v.abs() ** p, dim=red, keepdim=True) ** (1.0 / p)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-12),
                        torch.ones_like(norms))
    return v * scale


def as_strided(x, shape, stride, offset=0, name=None):
    return torch.as_strided(x.contiguous(), tuple(shape), tuple(stride),
                            offset)


def take(x, index, mode="raise", name=None):
    """Elements of ``x.flatten()`` at ``index`` (its shape). ``raise``
    checks the range (one host read), ``wrap`` takes it modulo the size,
    ``clip`` clamps (negatives to 0)."""
    assert mode in ("raise", "wrap", "clip"), mode
    n = x.numel()
    i = _index(index, x)
    if mode == "raise":
        if i.numel() and (int(i.min()) < -n or int(i.max()) >= n):
            raise IndexError(
                f"take: index out of range for input with {n} elements")
        i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    elif mode == "wrap":
        i = torch.remainder(i, n)
    else:
        i = i.clamp(0, n - 1)
    return x.reshape(-1)[i]


def vsplit(x, num_or_sections, name=None):
    if x.ndim < 2:
        raise ValueError(f"vsplit expects ndim>=2, got {x.ndim}")
    return split(x, num_or_sections, axis=0)


def reverse(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(x, list(axes))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    """Indices re-offset into shard ``shard_id`` of ``[0, index_num)``,
    others ``ignore_value``."""
    if not 0 <= shard_id < nshards:
        raise ValueError(f"shard_id {shard_id} out of range [0, {nshards})")
    size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * size, (shard_id + 1) * size
    inside = (input >= lo) & (input < hi)
    return torch.where(inside, input - lo, torch.full_like(input,
                                                           ignore_value))


def tolist(x):
    return x.tolist()


def shape(input):
    """The shape as a 1-D int32 tensor."""
    return torch.tensor(list(input.shape), dtype=torch.int32,
                        device=input.device)


def rank(input):
    """ndim as a 0-d int32 tensor."""
    return torch.tensor(input.ndim, dtype=torch.int32, device=input.device)
