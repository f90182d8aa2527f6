"""B3 and B6 in float16, and B3 on float pages of a dtype other than q's.

The plain version of the paged kernel (`paged_attention_reference`, the
CPU path and the card's check) is held against paddle_tpu's Pallas
kernel run in interpret mode (`fused_paged_attention`, as
tests/test_paged_attention.py runs it) on the same numpy-seeded inputs,
for float16 queries and pages and for every pair of float q and page
dtypes (float32, bfloat16, float16), at W 1 and 5 and page sizes 16 and
4, with ragged steps, left pads and a fully masked row; and the beam's
tail read (`paged_tail_segment`) in float16. Both read each page in its
own dtype, widen it to float32 and round the output once to q's dtype,
so a 16-bit output is held to 2 ulps of its dtype at each element's
scale (the two sum in another order; the scale is the largest of the
element's own magnitude, its row's rms and 1/64 of the tensor's rms)
and a float32 one, and every lse, at atol 2e-5.

The paged-KV writers store into float16 pools, and into pools of a
float dtype other than the values', cast to the pool's dtype as the
reference's writers are (``paged_kv.py:106``, :131): bit for bit.

B6's plain versions in float16 against paddle_tpu's ``fused_ln``
kernels in interpret mode (gradients by ``jax.vjp``): y, dx,
d(residual), dg and db within 2 float16 ulps of each element's scale.

The kernels themselves run only on a card: chip_smoke.py's phase 3
holds them against these plain versions there (8 float16 ulps).
"""
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.paged_attention as jpa
import paddle_tpu.kernels.paged_kv as jkv
from paddle_tpu_torch.kernels import fused_ln as pfl
from paddle_tpu_torch.kernels import paged_kv
from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention_reference, paged_tail_segment)

jfl = importlib.import_module("paddle_tpu.kernels.fused_ln")

ULPS, FLOOR, ATOL = 2, 1 / 64, 2e-5
#: one ulp at scale 1 in each 16-bit dtype
UNIT = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8}
FLOATS = ("float32", "bfloat16", "float16")
PAIRS = [(q, p) for q in FLOATS for p in FLOATS
         if not (q == p and q != "float16")]


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(jpa, "_INTERPRET", True)


def _jnp(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _np(x):
    """A jax or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ulps(got, want, d, dtype):
    """The largest |got - want| in ulps of ``dtype`` at each element's
    scale (rows of ``d`` values)."""
    g, w = _np(got).reshape(-1, d), _np(want).reshape(-1, d)
    scale = np.maximum(np.abs(w), np.sqrt((w ** 2).mean(1, keepdims=True)))
    scale = np.maximum(scale, FLOOR * np.sqrt((w ** 2).mean()))
    return float((np.abs(g - w) / (scale * UNIT[dtype])).max())


def _held(got, want, d, dtype, what):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0,
                                   err_msg=what)
        return
    u = _ulps(got, want, d, dtype)
    assert u <= ULPS, f"{what}: {u:.2f} {dtype} ulps"


def _case(ps, w, seed, n=4, h=2, d=64, pmax=5):
    """A shuffled block table over n*pmax pages (+ the sentinel), ragged
    steps, left pads, and row 3 fully masked with its cursor on the last
    column; float32 values."""
    rng = np.random.default_rng(seed)
    pages = n * pmax
    pool_k = rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32)
    pool_v = rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32)
    bt = rng.permutation(pages).reshape(n, pmax).astype(np.int32)
    lp = pmax * ps
    steps = rng.integers(1, lp - w + 1, (n,)).astype(np.int32)
    steps[3] = lp - w
    vc = np.ones((n, lp), np.int32)
    for r in range(n):
        vc[r, :rng.integers(0, steps[r])] = 0
    vc[3] = 0
    q = rng.standard_normal((n, h, w, d)).astype(np.float32)
    return q, pool_k, pool_v, bt, steps, vc


@pytest.mark.parametrize("q_dt, page_dt", PAIRS,
                         ids=[f"q_{q}-pages_{p}" for q, p in PAIRS])
@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("ps", [16, 4])
def test_plain_version_matches_the_interpret_kernel_across_dtypes(
        interpret_kernel, q_dt, page_dt, w, ps):
    q, pk, pv, bt, st, vc = _case(ps, w, seed=ps * 100 + w)
    j_out, j_lse = jpa.fused_paged_attention(
        _jnp(q, q_dt), _jnp(pk, page_dt), _jnp(pv, page_dt), bt, st, vc, 64)
    out, lse = paged_attention_reference(
        _torch(q, q_dt), _torch(pk, page_dt), _torch(pv, page_dt),
        torch.from_numpy(bt), torch.from_numpy(st), torch.from_numpy(vc))
    assert out.dtype == getattr(torch, q_dt)
    assert str(j_out.dtype) == q_dt and lse.dtype == torch.float32
    _held(out, j_out, 64, q_dt, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=ATOL,
                               rtol=0)
    assert np.isfinite(_np(out)).all()


@pytest.mark.parametrize("gen_col", [7, 12])
def test_tail_segment_in_float16(interpret_kernel, gen_col):
    """The beam's tail read on float16 pages under float16 queries."""
    rng = np.random.default_rng(gen_col)
    n, h, d, ps, pg = 4, 2, 64, 4, 4
    pk, pv = (rng.standard_normal((n * pg, h, ps, d)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(n * pg).reshape(n, pg).astype(np.int32)
    q = rng.standard_normal((n, h, d)).astype(np.float32)
    j_out, j_lse = jpa.paged_tail_segment(
        _jnp(q, "float16"), _jnp(pk, "float16"), _jnp(pv, "float16"), bt,
        gen_col, d)
    out, lse = paged_tail_segment(
        _torch(q, "float16"), _torch(pk, "float16"), _torch(pv, "float16"),
        torch.from_numpy(bt), gen_col, d)
    assert out.dtype == torch.float16
    _held(out, j_out, d, "float16", "tail out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=ATOL,
                               rtol=0)


def _bits(x):
    """A pool's raw bits as numpy, for an exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("pool_dt, val_dt", [
    ("float16", "float16"), ("float16", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float16"), ("float16", "bfloat16")])
def test_writers_store_in_the_pools_dtype(pool_dt, val_dt):
    """`write_token_pages`, `scatter_prompt_pages` and
    `scatter_tail_pages` into a float16 pool, or one of another float
    dtype than the values', against the reference's writers, bit for
    bit: both cast the values to the pool's dtype."""
    rng = np.random.default_rng(3)
    pages, h, ps, d = 6, 2, 4, 8
    pool = rng.standard_normal((pages + 1, h, ps, d)).astype(np.float32)
    jp, tp = _jnp(pool, pool_dt), _torch(pool, pool_dt)
    # one token a row into (page, offset)
    pg = np.array([1, 4], np.int32)
    off = np.array([2, 0], np.int32)
    val = rng.standard_normal((2, h, d)).astype(np.float32)
    jp = jkv.write_token_pages(jp, pg, off, _jnp(val, val_dt))
    paged_kv.write_token_pages(tp, torch.from_numpy(pg),
                               torch.from_numpy(off), _torch(val, val_dt))
    np.testing.assert_array_equal(_bits(tp), _bits(jp))
    # a 6-token prompt over two rows' reserved pages
    rows = np.array([[0, 2], [5, 3]], np.int32)
    local = rng.standard_normal((2, h, 6, d)).astype(np.float32)
    jp = jkv.scatter_prompt_pages(jp, rows, _jnp(local, val_dt), ps)
    paged_kv.scatter_prompt_pages(tp, torch.from_numpy(rows),
                                  _torch(local, val_dt), ps)
    np.testing.assert_array_equal(_bits(tp), _bits(jp))
    # a 3-token tail from column 5
    col0 = np.array([5, 1], np.int32)
    tail = rng.standard_normal((2, h, 3, d)).astype(np.float32)
    jp = jkv.scatter_tail_pages(jp, rows, col0, _jnp(tail, val_dt))
    paged_kv.scatter_tail_pages(tp, torch.from_numpy(rows),
                                torch.from_numpy(col0), _torch(tail, val_dt))
    np.testing.assert_array_equal(_bits(tp), _bits(jp))
    assert tp.dtype == getattr(torch, pool_dt)


@pytest.fixture
def ln_interpret(monkeypatch):
    monkeypatch.setattr(jfl, "_INTERPRET", True)


@pytest.mark.parametrize("residual", [True, False])
def test_fused_ln_plain_float16_matches_the_interpret_kernels(ln_interpret,
                                                              residual):
    """B6 in float16: the port's autograd over its plain versions
    (`fused_add_layer_norm` on CPU tensors) against the reference's
    kernels and ``jax.vjp``."""
    rng = np.random.default_rng(11 + residual)
    n, m = 256, 256
    x, r, dy = (rng.standard_normal((n, m)).astype(np.float32) * 2 + 0.5
                for _ in range(3))
    g = (rng.standard_normal(m) * 0.5 + 1).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    f16 = "float16"
    jargs = [_jnp(t, f16) for t in (x, r, g, b)]
    if residual:
        fn = lambda xv, rv, gv, bv: jfl.fused_add_layer_norm(xv, rv, gv, bv,
                                                              1e-5)
    else:
        jargs.pop(1)
        fn = lambda xv, gv, bv: jfl.fused_add_layer_norm(xv, None, gv, bv,
                                                         1e-5)
    jy, vjp = jax.vjp(fn, *jargs)
    jgrads = vjp(_jnp(dy, f16))
    leaves = [_torch(t, f16).requires_grad_(True) for t in (x, r, g, b)]
    if not residual:
        leaves[1] = None
    y = pfl.fused_add_layer_norm(leaves[0], leaves[1], leaves[2], leaves[3],
                                 1e-5)
    y.backward(_torch(dy, f16))
    grads = [t.grad for t in leaves if t is not None]
    assert y.dtype == torch.float16 and str(jy.dtype) == f16
    _held(y, jy, m, f16, "y")
    for name, a, want in zip(("dx", "dres", "dg", "db") if residual
                             else ("dx", "dg", "db"), grads, jgrads):
        assert a.dtype == torch.float16, name
        _held(a, want, a.shape[-1], f16, name)


def test_build_all_times_each_library_to_its_own_exit(monkeypatch,
                                                      tmp_path):
    """The paged source builds once a q dtype (three libraries, their
    defines) beside the others, every ``nvcc`` started at once; each
    library's log holds its own seconds (a fast build is not charged the
    slow one's wait) and the compiler's output. A failed build raises
    and stops the builds still running."""
    import os
    import stat
    import time

    from paddle_tpu_torch.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "out=''; while [ $# -gt 0 ]; do\n"
        "  case $1 in -o) out=$2; shift;; -DPTT_Q_F16) slow=1;; esac\n"
        "  shift; done\n"
        "[ -n \"$FAKE_FAIL\" ] && case $out in *fused_ln*) echo boom;"
        " exit 3;; esac\n"
        "[ -n \"$slow\" ] && sleep 1.5\n"
        "echo \"ptxas info : built $out\"; : > \"$out\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    names = ["paged_attention", "paged_attention_bf16", "paged_attention_f16",
             "fused_ln"]
    assert _build.source_and_flags("paged_attention_bf16") == (
        "paged_attention", ["--split-compile=0", "-DPTT_Q_BF16"])
    t0 = time.perf_counter()
    _build.build_all(names)
    assert time.perf_counter() - t0 < 3.0           # in parallel
    secs = {}
    for n in names:
        assert os.path.exists(_build._lib_path(n))
        first, rest = _build.build_report(n).split("\n", 1)
        secs[n] = float(first.split()[-1])
        assert "ptxas info" in rest
    assert secs["paged_attention_f16"] >= 1.4
    assert secs["fused_ln"] < 1.0 and secs["paged_attention"] < 1.0
    # a failing library raises at once and stops the slow build
    for n in names:
        os.remove(_build._lib_path(n))
    monkeypatch.setenv("FAKE_FAIL", "1")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="nvcc failed on fused_ln"):
        _build.build_all(names)
    assert time.perf_counter() - t0 < 1.2
    assert not os.path.exists(_build._lib_path("paged_attention_f16"))
