"""float16 in the flash kernels' plain versions (B1, B2, B4, B5) and in
the Adam update, against paddle_tpu's.

On the CPU each flash wrapper runs its plain version, the function the
Hopper kernel is held to on the card; here it takes float16 q, k, v (or
qkv) and is held against the reference's Pallas kernels run in
interpret mode on the same float16 inputs (through ``jax.vjp``), as the
reference's own tests run them. Both round p*keep to v's dtype before
the product and dS to q's dtype, so they differ by float32 summation
order and those rounding points: o, lse and each gradient are held to 8
float16 ulps (2^-11) of each element's scale (the largest of its own
|value|, its row's rms and 1/64 of the tensor's rms, as
`chip_smoke.flash_ulps` holds the kernels), lse to 1e-5.

The Adam update: ``AdamW(multi_precision=True)``'s eager step on float16
parameters keeps float32 masters, in both packages; over three steps the
float16 params agree with the reference's to 1 float16 ulp, the masters
to 1e-6 (as tests/test_torch_optimizer.py holds bfloat16's).

The kernels themselves run only on a card: the ``cuda`` cases hold the
float16 kernels against these plain versions there and skip here.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as J
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch import kernels
from paddle_tpu_torch import optimizer as T
from paddle_tpu_torch.kernels import flash_attention as pfa

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

SEED = 4321
ULPS, UNIT, FLOOR = 8, 2.0 ** -11, 1 / 64
LSE_ATOL = 1e-5
F16 = jnp.float16


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)


def _ulps(got, want, d):
    """The largest |got - want| in float16 ulps of each element's scale
    (rows of one head's ``d`` values)."""
    g = np.asarray(got, np.float32).reshape(-1, d)
    w = np.asarray(want, np.float32).reshape(-1, d)
    scale = np.maximum(np.abs(w), np.sqrt((w ** 2).mean(1, keepdims=True)))
    scale = np.maximum(scale, FLOOR * np.sqrt((w ** 2).mean()))
    return float((np.abs(g - w) / (scale * UNIT)).max())


def _held(parts, got, want, d):
    for name, a, w in zip(parts, got, want):
        u = _ulps(a, w, d)
        assert u <= ULPS, f"{name}: {u:.2f} float16 ulps"


def _f16(rng, shape):
    return rng.standard_normal(shape).astype(np.float16)


@pytest.mark.parametrize("causal,mask,p", [(False, True, 0.1),
                                           (True, False, 0.0),
                                           (True, True, 0.1)])
def test_b2_plain_float16_matches_the_interpret_kernel(interpret_kernel,
                                                       causal, mask, p):
    rng = np.random.default_rng(11 + causal + 2 * mask)
    b, s, h, d = 2, 256, 2, 64
    q, k, v, g = (_f16(rng, (b, s, h, d)) for _ in range(4))
    m = (np.arange(s)[None] < rng.integers(s // 2, s, (b, 1)))[
        :, None, None, :] if mask else None
    seed = jnp.asarray([SEED], jnp.int32) if p else None

    def fn(q, k, v):
        o = jfa.flash_attention_fwd(
            q, k, v, is_causal=causal, block_q=128, block_k=128,
            attn_mask=None if m is None else jnp.asarray(m), dropout_p=p,
            seed=seed)
        return o._value if hasattr(o, "_value") else o

    o, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
    assert o.dtype == F16
    want = [o, *vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = pfa.flash_attention(*leaves, is_causal=causal,
                              attn_mask=None if m is None
                              else torch.from_numpy(m), dropout_p=p,
                              seed=SEED if p else None, block_q=128,
                              block_k=128)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float16
    assert all(t.grad.dtype == torch.float16 for t in leaves)
    _held(("o", "dq", "dk", "dv"), [out.detach()] + [t.grad for t in leaves],
          want, d)


@pytest.mark.parametrize("layout", ["pair", "which"])
@pytest.mark.parametrize("causal,p", [(True, 0.0), (False, 0.1)])
def test_b1_b5_plain_float16_match_the_interpret_kernels(interpret_kernel,
                                                         layout, causal, p):
    rng = np.random.default_rng(21 + causal + (layout == "pair"))
    b, s, h, d = 2, 128, 2, 64
    qkv, g = _f16(rng, (b, s, 3 * h * d)), _f16(rng, (b, s, h * d))
    seed = jnp.asarray([SEED], jnp.int32) if p else None
    scale = float(1.0 / np.sqrt(d))
    fwd, prim = ((jfa._fwd_qkv, jfa._flash_qkv_p) if layout == "pair"
                 else (jfa._fwd_qkv3, jfa._flash_qkv3_p))
    x = jnp.asarray(qkv)
    _, lse = fwd(x, scale, causal, d, p, seed)
    o, vjp = jax.vjp(lambda v: prim(v, seed, scale, causal, d, p), x)
    (dqkv,) = vjp(jnp.asarray(g))
    lse = np.asarray(lse)[:, :, ::8].reshape(b, h, -1)
    entry = (pfa.flash_attention_qkv if layout == "pair"
             else pfa.flash_attention_qkv3)
    t = torch.from_numpy(qkv).requires_grad_(True)
    out = entry(t, h, is_causal=causal, dropout_p=p,
                seed=SEED if p else None)
    out.backward(torch.from_numpy(g))
    assert out.dtype == t.grad.dtype == torch.float16
    _held(("o", "dqkv"), (out.detach(), t.grad), (o, dqkv), d)
    plain = (pfa.flash_qkv_reference if layout == "pair"
             else pfa.flash_qkv3_reference)
    _, got_lse = plain(torch.from_numpy(qkv), h, causal, p,
                       torch.tensor([SEED], dtype=torch.int32) if p else None)
    np.testing.assert_allclose(got_lse.numpy(), lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_b4_plain_float16_matches_the_reference(interpret_kernel, causal):
    """o, lse and the grads of a loss that reads both."""
    rng = np.random.default_rng(31 + causal)
    b, s, h, d = 1, 128, 2, 64
    q, k, v, go = (_f16(rng, (b, s, h, d)) for _ in range(4))
    gl = rng.standard_normal((b, h, s)).astype(np.float32)

    def fn(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, is_causal=causal)
        return (o._value if hasattr(o, "_value") else o,
                lse._value if hasattr(lse, "_value") else lse)

    (o, lse), vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
    grads = vjp((jnp.asarray(go), jnp.asarray(gl)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out, got_lse = kernels.flash_attention_with_lse(*leaves,
                                                    is_causal=causal)
    assert out.dtype == torch.float16 and got_lse.dtype == torch.float32
    ((out.float() * torch.from_numpy(go).float()).sum()
     + (got_lse * torch.from_numpy(gl)).sum()).backward()
    np.testing.assert_allclose(got_lse.detach().numpy(), np.asarray(lse),
                               atol=LSE_ATOL, rtol=0)
    _held(("o", "dq", "dk", "dv"), [out.detach()] + [t.grad for t in leaves],
          [o, *grads], d)


def test_adamw_multi_precision_float16_matches_the_reference():
    """Three eager steps of ``AdamW(multi_precision=True)`` on float16
    parameters: the float16 params (the masters' rounding) within 1 ulp
    of the reference's, the float32 masters within 1e-6."""
    rng = np.random.default_rng(41)
    shapes = {"w": (64, 48), "b": (48,)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    gs = [{k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()} for _ in range(3)]
    jps = [JParameter(jnp.asarray(v, F16), name=k) for k, v in p.items()]
    tps = [(k, torch.nn.Parameter(torch.tensor(v).half()))
           for k, v in p.items()]
    kw = dict(learning_rate=0.01, weight_decay=0.05, multi_precision=True)
    jo, to = J.AdamW(parameters=jps, **kw), T.AdamW(parameters=tps, **kw)
    for g in gs:
        for jpar, (k, tpar) in zip(jps, tps):
            jpar._grad = JTensor(jnp.asarray(g[k], F16))
            tpar.grad = torch.from_numpy(g[k]).half()
        jo.step()
        to.step()
    jsd, tsd = jo.state_dict(), to.state_dict()
    for jpar, (k, tpar) in zip(jps, tps):
        assert tpar.dtype == torch.float16
        assert tsd[f"{k}.master"].dtype == torch.float32
        w = np.asarray(jpar._value.astype(jnp.float32))
        ulp = 2.0 ** -10 * np.exp2(np.floor(np.log2(np.maximum(np.abs(w),
                                                               1e-30))))
        assert (np.abs(tpar.detach().float().numpy() - w) <= ulp).all(), k
        np.testing.assert_allclose(tsd[f"{k}.master"].numpy(),
                                   np.asarray(jsd[f"{k}.master"]._value),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_each_library_names_its_source_and_flags():
    """The float16 libraries are the flash sources built again with
    ``-DPTT_F16``; every library of the paged source (60 kernels)
    compiles its device code in parallel; each library builds from its
    own flags into a file of its own."""
    from paddle_tpu_torch.kernels import _build

    assert _build.source_and_flags("flash_attention_f16") == (
        "flash_attention", ["-DPTT_F16"])
    assert _build.source_and_flags("flash_attention_qkv") == (
        "flash_attention_qkv", [])
    assert _build.source_and_flags("paged_attention") == (
        "paged_attention", ["--split-compile=0"])
    names = _build.sources()
    assert {"flash_attention_f16", "flash_attention_qkv_f16",
            "paged_attention", "multi_tensor_adam"} <= set(names)
    assert len({_build._lib_path(n) for n in names}) == len(names)


@pytest.mark.cuda
def test_float16_kernels_match_the_plain_versions_on_a_card():
    """B2 (key padding, dropout), B5 and B1 (dropout) and B4 on float16
    against their plain versions, 8 float16 ulps of each element's
    scale; each launch counted under ``<kernel>_f16``; the Adam kernel's
    float16 group with float32 masters within 1 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only on "
                    "the card")
    from paddle_tpu_torch.kernels import multi_tensor_adam as mta

    g = torch.Generator(device="cuda").manual_seed(0)
    kernels.reset_kernel_launch_counts()
    seed = torch.tensor([7], dtype=torch.int32, device="cuda")
    q, k, v, do = (torch.randn((2, 256, 2, 64), generator=g, device="cuda")
                   .half() for _ in range(4))
    mask = torch.arange(256, device="cuda")[None] < torch.tensor(
        [[200], [256]], device="cuda")
    kw = dict(bias=pfa.normalize_mask_bias(mask[:, None, None, :]),
              dropout_p=0.1, seed=seed)
    o, lse = pfa.flash_attention_fwd(q, k, v, False, **kw)
    ro, rlse = pfa.flash_reference(q, k, v, False, **kw)
    got = pfa.flash_attention_bwd(q, k, v, ro, rlse, do, False, **kw)
    want = pfa.flash_bwd_reference(q, k, v, ro, rlse, do, False, **kw)
    _held(("o", "dq", "dk", "dv"), [t.cpu() for t in (o, *got)],
          [t.cpu() for t in (ro, *want)], 64)
    for fwd, bwd, plain, plain_bwd in (
            (pfa.flash_attention_qkv3_fwd, pfa.flash_attention_qkv3_bwd,
             pfa.flash_qkv3_reference, pfa.flash_qkv3_bwd_reference),
            (pfa.flash_attention_qkv_fwd, pfa.flash_attention_qkv_bwd,
             pfa.flash_qkv_reference, pfa.flash_qkv_bwd_reference)):
        qkv = torch.randn((2, 128, 384), generator=g, device="cuda").half()
        dout = torch.randn((2, 128, 128), generator=g, device="cuda").half()
        o, _ = fwd(qkv, 2, True, 0.1, seed)
        ro, rlse = plain(qkv, 2, True, 0.1, seed)
        _held(("o", "dqkv"), (o.cpu(), bwd(qkv, dout, ro, rlse, 2, True, 0.1,
                                           seed).cpu()),
              (ro.cpu(), plain_bwd(qkv, dout, ro, rlse, 2, True, 0.1,
                                   seed).cpu()), 64)
    o, lse = pfa.flash_attention_lse_fwd(q, k, v, True)
    ro, rlse = pfa.flash_reference(q, k, v, True)
    dlse = torch.randn(rlse.shape, generator=g, device="cuda")
    got = pfa.flash_attention_lse_bwd(q, k, v, ro, rlse, do, dlse, True)
    want = pfa.flash_bwd_reference(q, k, v, ro, rlse, do, True, dlse=dlse)
    _held(("o", "dq", "dk", "dv"), [t.cpu() for t in (o, *got)],
          [t.cpu() for t in (ro, *want)], 64)
    p = torch.randn(4096, generator=g, device="cuda")
    e = mta.AdamEntry(p.half(), (p * 1e-2).half(), torch.zeros_like(p),
                      torch.zeros_like(p), p.clone(), 0.01)
    plain = mta.AdamEntry(*(t.clone() if isinstance(t, torch.Tensor) else t
                            for t in e))
    lr = torch.tensor(1e-3, device="cuda")
    step = torch.zeros((), dtype=torch.int32, device="cuda")
    run = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, adamw=True)
    mta.multi_tensor_adam([e], lr, step, tables=mta.AdamTables(), **run)
    mta.adam_reference([plain], lr, step, **run)
    assert torch.equal(e.p, plain.p) and torch.equal(e.master, plain.master)
    counts = kernels.kernel_launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "flash_attention_fwd_f16": 1, "flash_attention_bwd_f16": 1,
        "flash_attention_qkv3_fwd_f16": 1, "flash_attention_qkv3_bwd_f16": 1,
        "flash_attention_qkv_fwd_f16": 1, "flash_attention_qkv_bwd_f16": 1,
        "flash_attention_lse_fwd_f16": 1, "flash_attention_lse_bwd_f16": 1,
        "multi_tensor_adam_f16": 1}
