"""One CUDA graph per shape bucket: `CapturedStep`.

Counterpart: the ``jax.jit`` discipline of the reference's serving steps
(``paddle_tpu/serving/compiled.py``: one executable per shape bucket,
each trace reported to the recompile sentinel) and of its compiled
generation loop. A `CapturedStep` is built from a step body and the
shapes of its operands:

- It allocates **static input buffers** once. The int32 operands a
  caller holds on the host as numpy arrays (``staged``) lie in one flat
  device buffer, each at a 16-byte aligned offset (the kernels read
  some in 16-byte pieces), filled from one pinned host buffer by one
  copy a call; operands that already live on the device (``inputs``)
  are copied into their own buffers.
- On a CUDA device its first call runs the body once on a side stream
  (the warm-up: cuBLAS handles and workspaces, the kernels' modules and
  per-stream buffers), then captures it with `torch.cuda.CUDAGraph` into
  the memory pool its owner shares between all its buckets
  (`graph_pool`), and replays it; every later call only replays. The
  interpreter's garbage collector is off during the capture: a
  collection there could free a dead owner's graph, a call no capture
  permits. The
  warm-up and the capture leave the kernel launch counts as they were;
  each replay adds the launches the capture recorded
  (`kernels.add_launches`). A buffer a kernel wrapper keeps across calls
  and the graph reads is held for the graph's life (`kernels.hold`).
- On the CPU it runs the body eagerly on the same static buffers,
  through the same copy-in and copy-out, and counts one build a bucket.

Each capture (on the CPU, each build) is reported once, to the owner's
``on_trace``, which reports it to the recompile sentinel under the
step's name and no signature (the `Engine`'s `EngineMetrics.note_trace`,
`generate`'s loop builder): armed, any second build of one name raises,
a rebuild after an eviction too. There is no eager
fallback and no switch: a capture that fails raises with the step's
name. `run_eager` runs the body once on the static buffers without a
replay, for holding a graph against its eager run; nothing on a main
path calls it. `build` builds a step ahead of its first call (on a card
the warm-up and the capture, no replay; on the CPU only the build's
report): the adaptive engine's verify rungs, built together at its
first speculative decode.

A train step (`distributed.SpmdTrainStep`) is such a step too, with
three additions: its body returns a tuple (the loss and the values its
loss function hands out), each copied out; the generators it draws from
are registered with the graph (``generators``), so a replay draws from
the seed and offset a generator holds when it starts, which the owner
sets from the step's key before each call; and its body updates weights
and optimizer state in place, so it must run once a call
(``warm_is_call``): the first call's warm-up IS that call, whose outputs
it returns and whose kernel launches it counts, and the capture after it
only records.

The body must be a pure function of the static buffers and of state at
fixed addresses (weights, caches and page pools written in place, listed
in ``fixed``: their addresses are checked once, at capture). It must not
read the device from the host (no ``.item()``, no ``int(tensor)``) nor
copy from the host. Its outputs are copied out of the graph's memory on
every call, so a caller may keep them while another graph of the pool
replays.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import kernels


#: int32 elements in 16 bytes: each staged operand starts at a multiple
_ALIGN = 4


def graph_pool(device):
    """The memory pool every graph of one owner is captured into (its
    graphs replay one at a time, in any order, since each call copies
    its outputs out); None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.graph_pool_handle()


class CapturedStep:
    """A step body over static buffers, captured once as a CUDA graph on
    a card and replayed on every call (module docstring).

    ``name``: the sentinel's name of this step. ``body(**static)``
    returns a tensor or a tuple of tensors. ``staged``: ``{name: shape}``
    of the int32 operands given as numpy arrays or ints, all of them in
    every call. ``inputs``: ``{name: (shape, dtype)}`` of operands given
    as tensors on the device; one left out keeps its last value.
    ``fixed``: the tensors the body reads or writes in place. ``pool``:
    the owner's `graph_pool`. ``on_trace``: called with no argument on
    each build; it reports the build to the sentinel. ``generators``:
    the non-default CUDA generators the body draws from.
    ``warm_is_call``: the first call returns the warm-up's outputs and
    does not replay (module docstring)."""

    def __init__(self, name, body, device, *, pool, on_trace, staged=None,
                 inputs=None, fixed=(), generators=(), warm_is_call=False):
        self.name = name
        self.body = body
        self.device = torch.device(device)
        self.fixed = list(fixed)
        self.pool = pool
        self.on_trace = on_trace
        self.generators = list(generators)
        self.warm_is_call = warm_is_call
        #: builds of this step: 1 after the first call
        self.captures = 0
        #: host seconds of the warm-up and the capture (0.0 on the CPU)
        self.capture_s = 0.0
        self._cuda = self.device.type == "cuda"
        self._graph = None
        self._out = None
        self._delta: dict = {}
        self._held: list = []
        staged = {k: tuple(v) for k, v in (staged or {}).items()}
        offsets, total = [], 0
        for shape in staged.values():
            offsets.append(total)
            total += -(-int(np.prod(shape)) // _ALIGN) * _ALIGN
        self._host = torch.zeros(max(total, 1), dtype=torch.int32,
                                 pin_memory=self._cuda)
        self._dev = torch.zeros(max(total, 1), dtype=torch.int32,
                                device=self.device)
        host = self._host.numpy()
        self._staged: dict[str, np.ndarray] = {}
        #: the static buffers, by operand name
        self.static: dict[str, torch.Tensor] = {}
        for (k, shape), off in zip(staged.items(), offsets):
            n = int(np.prod(shape))
            self._staged[k] = host[off:off + n].reshape(shape)
            self.static[k] = self._dev[off:off + n].view(shape)
        for k, (shape, dtype) in (inputs or {}).items():
            self.static[k] = torch.zeros(shape, dtype=dtype,
                                         device=self.device)
        self._copied = torch.cuda.Event() if self._cuda else None
        self._copy_pending = False

    # -- operands ----------------------------------------------------------
    def set(self, **operands):
        """Copy ``operands`` into the static buffers: the staged ones
        through the pinned host buffer in one copy, then the device ones
        into their buffers. A shape that differs from the bucket's
        raises."""
        staged = [k for k in operands if k in self._staged]
        if staged:
            if len(staged) != len(self._staged):
                missing = sorted(set(self._staged) - set(staged))
                raise ValueError(f"{self.name}: staged operands {missing} "
                                 "missing (every call gives them all)")
            if self._copy_pending:
                # the last copy may still read the host buffer
                self._copied.synchronize()
            for k in staged:
                view, v = self._staged[k], operands[k]
                if np.shape(v) != view.shape:
                    raise ValueError(f"{self.name}: operand {k} has shape "
                                     f"{np.shape(v)}, the bucket "
                                     f"{view.shape}")
                np.copyto(view, v, casting="unsafe")
            self._dev.copy_(self._host, non_blocking=self._cuda)
            if self._cuda:
                self._copied.record()
                self._copy_pending = True
        for k, v in operands.items():
            if k in self._staged:
                continue
            buf = self.static.get(k)
            if buf is None:
                raise TypeError(f"{self.name}: unknown operand {k!r}")
            if tuple(v.shape) != tuple(buf.shape):
                raise ValueError(f"{self.name}: operand {k} has shape "
                                 f"{tuple(v.shape)}, the bucket "
                                 f"{tuple(buf.shape)}")
            buf.copy_(v)

    # -- running -----------------------------------------------------------
    def __call__(self, **operands):
        """Copy the operands in, replay (building on the first call) and
        return the outputs, copied out."""
        self.set(**operands)
        warm = None
        if not self.captures:
            warm = self._build()
        if self._graph is None:
            return _copied(self.body(**self.static))
        if warm is not None:
            return warm
        self._graph.replay()
        kernels.add_launches(self._delta)
        return _copied(self._out)

    def build(self, **operands):
        """Build the step on ``operands`` without running it as a call:
        on a card the warm-up (its launches not counted) and the capture,
        with no replay; on the CPU only the build's report. A step
        already built is left as it is."""
        self.set(**operands)
        if not self.captures:
            self._build()

    def run_eager(self, **operands):
        """The body once, eagerly, on the static buffers (after copying
        ``operands`` in): what a replay computes, for a check."""
        self.set(**operands)
        return _copied(self.body(**self.static))

    def _build(self):
        """Report the build and capture; the warm-up's outputs, copied,
        when the warm-up is the call (else None)."""
        self.on_trace()
        warm = None
        if self._cuda:
            t0 = time.perf_counter()
            warm = self._capture()
            self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return warm

    def _capture(self):
        ptrs = [t.data_ptr() for t in self.fixed]
        cur = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(cur)
        held: list = []
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        before = kernels.kernel_launch_counts()
        try:
            with kernels.launches_uncounted(), \
                    kernels.held_by_capture(held):
                with torch.cuda.stream(stream):
                    first = self.body(**self.static)
                cur.wait_stream(stream)
                warm = kernels.kernel_launch_counts()
                for gen in self.generators:
                    graph.register_generator_state(gen)
                # thread_local: a call that is unsafe during a capture
                # fails it only when this thread makes it (global mode
                # also counts other threads', such as the profiler's)
                with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    out = self.body(**self.static)
                after = kernels.kernel_launch_counts()
        except Exception as exc:
            raise RuntimeError(f"{self.name}: CUDA graph capture failed "
                               f"({type(exc).__name__}: {exc})") from exc
        finally:
            if collecting:
                gc.enable()
        moved = [i for i, (t, p) in enumerate(zip(self.fixed, ptrs))
                 if t.data_ptr() != p]
        if moved:
            raise RuntimeError(f"{self.name}: fixed tensors {moved} moved "
                               "during the capture: the graph would read "
                               "freed memory")
        torch.cuda.synchronize(self.device)
        self._delta = {k: after[k] - warm[k] for k in after
                       if after[k] != warm[k]}
        self._graph, self._out, self._held = graph, out, held
        if not self.warm_is_call:
            return None
        kernels.add_launches({k: warm[k] - before[k] for k in warm})
        return _copied(first)


def _copied(out):
    """A body's outputs copied out of the memory the next run reuses."""
    if isinstance(out, tuple):
        return tuple(t.clone() for t in out)
    return out.clone()


__all__ = ["CapturedStep", "graph_pool"]
