"""The port's sequence parallelism (ring and Ulysses over
torch.distributed) against the JAX package's on its 8-device CPU mesh.

Two gloo worlds, of 2 and 4 ranks, are started once for the module
through the port's own `spawn` (`_torch_sp_worker.run`, which imports
neither jax nor paddle_tpu); every rank runs every case and writes its
chunk of each result as numpy. Here the chunks are joined and held
against `paddle_tpu.distributed.sequence_parallel` on the same numpy
inputs: `sp_attention` / `ring_attention` under ``shard_map`` for the
outputs, ``jax.grad`` of the same loss for the q, k and v grads. Both
compose in float32, so the bound is the reference's own 2e-5
(``tests/test_sequence_parallel.py:33-40``); the kernel-shaped ring
(128 rows a chunk: each pair through B4, `flash_attention_with_lse`, the
plain version here) is held to the reference's flash-ring bound, 2e-4,
against the reference's ring with its Pallas kernels in interpret mode.
The factored ring loop, run in this process for every rank, is held to
the JAX ring too.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_sp_worker as worker
from paddle_tpu.distributed import HybridMesh as JaxMesh
from paddle_tpu.distributed import HybridParallelConfig as JaxConfig
from paddle_tpu.distributed import sequence_parallel as jsp
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed import sequence_parallel as psp

WORLDS = (2, 4)
TOL = dict(rtol=2e-5, atol=2e-5)
TOL_FLASH = dict(rtol=2e-4, atol=2e-4)
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started at once; ``results(world, case)`` waits for
    its world and returns each result as the list of its ranks'
    arrays."""
    runs = {}
    for n in WORLDS:
        out = tmp_path_factory.mktemp(f"sp{n}")
        runs[n] = (spawn(worker.run, args=(n, str(out)), nprocs=n,
                         join=False), out)
    done = {}

    def results(n, case):
        ctx, out = runs[n]
        if n not in done:
            done[n] = ctx.join(SPAWN_TIMEOUT_S)
        assert done[n], ("spawned ranks failed, exit codes "
                         f"{[p.exitcode for p in ctx.processes]}")
        parts = [np.load(os.path.join(out, f"{case}.{r}.npz"))
                 for r in range(n)]
        return {key: [p[key] for p in parts] for key in parts[0].files}

    yield results
    for ctx, _ in runs.values():
        ctx.join(SPAWN_TIMEOUT_S)


def _seq(chunks):
    """The ranks' sequence chunks joined in rank order."""
    return np.concatenate(chunks, 1)


def _mesh(n):
    return JaxMesh(JaxConfig(sp_degree=n), devices=jax.devices()[:n])


def _jax_ring_or_ulysses(fn, n, causal, arrays, **kw):
    """The JAX package's output and q/k/v grads of ``sum(o * w)`` with
    ``fn`` under shard_map over an ``n``-device sp mesh."""
    q, k, v, w = (jnp.asarray(a) for a in arrays)
    spec = P(None, "sp", None, None)
    f = jax.shard_map(lambda a, b, c: fn(a, b, c, "sp", causal, **kw),
                      mesh=_mesh(n).mesh, in_specs=(spec,) * 3,
                      out_specs=spec, check_vma=False)

    def loss(q, k, v):
        o = f(q, k, v)
        return jnp.sum(o * w), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(g) for g in grads]


def _held(mine, o, grads, tol):
    np.testing.assert_allclose(_seq(mine["o"]), o, **tol)
    for key, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_seq(mine[key]), g, **tol, err_msg=key)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", sorted(worker.SP_CASES))
def test_sp_attention_matches_jax(worlds, n, case):
    """`sp_attention` on sequence-sharded DTensors, ring and Ulysses,
    causal and full: the output (a DTensor placed as q) and the grads
    against the reference's `sp_attention` and `jax.grad` of its
    shard_map'd `ring_attention` / `ulysses_attention`."""
    mode, causal, shape = worker.SP_CASES[case]
    arrays = worker.inputs(case, shape)
    mine = worlds(n, case)
    assert all(mine["placed"])
    ref_out = jsp.sp_attention(_mesh(n), *(jnp.asarray(a)
                                           for a in arrays[:3]),
                               causal=causal, mode=mode)
    np.testing.assert_allclose(_seq(mine["o"]), np.asarray(ref_out._value),
                               **TOL)
    fn = {"ring": jsp.ring_attention, "ulysses": jsp.ulysses_attention}[mode]
    o, grads = _jax_ring_or_ulysses(fn, n, causal, arrays)
    _held(mine, o, grads, TOL)


@pytest.fixture
def jax_flash_on_cpu(monkeypatch):
    """The reference's chunk kernels in interpret mode, as its own flash
    ring tests run them (``tests/test_sequence_parallel.py:91-102``)."""
    import paddle_tpu.kernels as K

    monkeypatch.setattr(importlib.import_module(
        "paddle_tpu.kernels.flash_attention"), "_INTERPRET", True)
    monkeypatch.setattr(K, "pallas_available", lambda: True)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", sorted(worker.FLASH_CASES))
def test_kernel_shaped_ring_matches_jax_flash_ring(worlds, jax_flash_on_cpu,
                                                   n, case):
    """128 rows a chunk: each rank sends every pair it computes through
    B4's entry (me + 1 pairs causal, n full), and the ring's output and
    grads (a real lse cotangent through the merge) match the reference's
    flash ring."""
    causal = worker.FLASH_CASES[case]
    arrays = worker.inputs(case, worker.flash_shape(n))
    mine = worlds(n, case)
    want = [r + 1 if causal else n for r in range(n)]
    assert [int(c) for c in mine["b4_calls"]] == want
    o, grads = _jax_ring_or_ulysses(jsp.ring_attention, n, causal, arrays,
                                    attn_impl=jsp.flash_chunk_attention)
    _held(mine, o, grads, TOL_FLASH)


@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_refuses_heads_the_degree_does_not_divide(worlds, n):
    message = worlds(n, "ulysses_refusal")["message"][0].item()
    assert f"head count ({n + 1})" in message
    assert f"sp degree ({n})" in message


@pytest.mark.parametrize("n", WORLDS)
def test_a_mesh_without_sp_composes(worlds, n):
    """A dp-only mesh composes plain attention, as the reference's serial
    mesh does; `shard_sequence` on an sp mesh hands each rank its
    chunk."""
    q, k, v, _ = worker.inputs("serial", (2, 16, 2, 8))
    mine = worlds(n, "serial")
    assert all(a.tolist() == ["dp"] for a in mine["axes"])
    ref = jsp.sp_attention(JaxMesh(JaxConfig(), devices=jax.devices()[:1]),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True)
    for rank_out in mine["o"]:
        np.testing.assert_allclose(rank_out, np.asarray(ref._value), **TOL)
    np.testing.assert_array_equal(_seq(mine["shard"]), q)
    assert all(mine["shard_placed"])


@pytest.mark.parametrize("n", WORLDS)
def test_collectives_and_their_backwards(worlds, n):
    """`send_recv` with [(0, 1)]: rank 1 gets rank 0's tensor, the rest
    zeros, and rank 0's grad is rank 1's weight; `all_to_all` swaps
    slots and its backward swaps the cotangent back."""
    got = {k: np.stack(v) for k, v in worlds(n, "collectives").items()}
    want_y = np.zeros((n, 3), np.float32)
    want_y[1] = 1.0
    np.testing.assert_array_equal(got["y"], want_y)
    want_dx = np.zeros((n, 3), np.float32)
    want_dx[0] = 2.0
    np.testing.assert_array_equal(got["dx"], want_dx)
    ranks = np.arange(n, dtype=np.float32)
    # rank r's slot i holds 10 * i + r; its cotangent there is (i + 1),
    # which flows back to rank i's slot r
    np.testing.assert_array_equal(got["b"][:, :, 0],
                                  10 * ranks[None, :] + ranks[:, None])
    np.testing.assert_array_equal(got["da"][:, :, 0],
                                  np.broadcast_to(ranks[:, None] + 1, (n, n)))


def test_two_rings_on_a_dp_by_sp_mesh(worlds):
    """World 4 as dp 2 x sp 2: each dp row runs its own two-rank ring
    (`HybridMesh.group("sp")`), batch row i on dp rank i; the output and
    grads against the reference's serial attention."""
    q, k, v, w = worker.inputs("dp_sp", (2, 64, 2, 16))
    got = worlds(4, "dp_sp")

    def rows(x):    # ranks (dp0 sp0, dp0 sp1, dp1 sp0, dp1 sp1)
        return np.concatenate([_seq(x[:2]), _seq(x[2:])], 0)

    def loss(q, k, v):
        o = jsp._sdpa(q, k, v, True)
        return jnp.sum(o * w), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(rows(got["o"]), np.asarray(o), **TOL)
    for key, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(rows(got[key]), np.asarray(g), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_factored_ring_loop_in_one_process_matches_jax_ring(causal):
    """`_ring_loop` for every rank of a 4-way ring in this one process,
    each fed the chunks the ring would deliver (the card runs its
    kernel-shaped twin in chip_smoke.py phase 11): the joined output and
    the grads of the whole q, k and v against the reference's ring."""
    n, shape = 4, (1, 64, 2, 16)
    arrays = worker.inputs(f"loop_{causal}", shape)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays[:3])
    kvs = [torch.stack(p) for p in zip(k.chunk(n, 1), v.chunk(n, 1))]
    outs = []
    for me in range(n):
        step = iter(range(1, n))

        def shift(kv, me=me, step=step):
            return kvs[(me - next(step)) % n]

        o, _ = psp._ring_loop(q.chunk(n, 1)[me], *kvs[me], me, n, shift,
                              causal, shape[-1] ** -0.5,
                              psp.flash_chunk_attention)
        outs.append(o)
    o = torch.cat(outs, 1)
    (o * torch.from_numpy(arrays[3])).sum().backward()
    ro, grads = _jax_ring_or_ulysses(jsp.ring_attention, n, causal, arrays)
    np.testing.assert_allclose(o.detach().numpy(), ro, **TOL)
    for t, g in zip((q, k, v), grads):
        np.testing.assert_allclose(t.grad.numpy(), g, **TOL)


def test_ring_and_ulysses_without_a_world_run_one_rank():
    """With no world initialised (one process) the group is this process
    alone: the ring makes one B4 call, whose o it returns unchanged, and
    Ulysses attends over the whole sequence; both against the reference's
    serial attention."""
    from paddle_tpu_torch import kernels

    arrays = worker.inputs("solo", (1, 128, 2, 16))
    q, k, v = (torch.from_numpy(a) for a in arrays[:3])
    ring = psp.ring_attention(q, k, v, causal=True)
    o, _ = kernels.flash_attention_with_lse(q, k, v, is_causal=True)
    assert torch.equal(ring, o)
    ref = np.asarray(jsp._sdpa(*(jnp.asarray(a) for a in arrays[:3]), True))
    np.testing.assert_allclose(ring.numpy(), ref, **TOL)
    np.testing.assert_allclose(
        psp.ulysses_attention(q, k, v, causal=True).numpy(), ref, **TOL)
