"""The port's optimizer plane against paddle_tpu's: LR schedulers, every
optimizer's functional update, the eager ``step()`` with
``multi_precision`` and ``apply_decay_param_fun``, ``state_dict``, the
clips, and the Adam kernel's plain version.

Inputs are numpy arrays from fixed seeds, handed to both packages.
Tolerances: schedulers 1e-12 relative (the same Python float math);
float32 updates within 1e-6 absolute and relative, on values of order 1
(XLA fuses the reference's elementwise ops, which may round a step in
another place: measured differences of a few 1e-8); bf16 params and
slots bit for bit (one rounding to bf16 of the same float32 value).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as J
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import kernels
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as T
from paddle_tpu_torch.kernels import multi_tensor_adam as mta
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 3
SHAPES = {"a": (4, 37), "b": (129,), "c": (3, 5, 8)}


def _schedulers(m):
    """Each of the 16 schedulers (and the base), built from module ``m``,
    with arguments that make every branch move within 30 steps."""
    return {
        "NoamDecay": lambda: m.NoamDecay(64, 10, learning_rate=2.0),
        "PiecewiseDecay": lambda: m.PiecewiseDecay([5, 12], [1.0, 0.5, 0.1]),
        "NaturalExpDecay": lambda: m.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: m.InverseTimeDecay(0.5, 0.2),
        "PolynomialDecay": lambda: m.PolynomialDecay(0.5, 10, cycle=True),
        "PolynomialDecay_nocycle": lambda: m.PolynomialDecay(0.5, 20,
                                                             power=2.0),
        "LinearWarmup": lambda: m.LinearWarmup(
            m.CosineAnnealingDecay(0.5, 12), 6, 0.0, 0.5),
        "LinearWarmup_float": lambda: m.LinearWarmup(0.3, 5, 0.01, 0.3),
        "ExponentialDecay": lambda: m.ExponentialDecay(0.5, 0.9),
        "MultiStepDecay": lambda: m.MultiStepDecay(0.5, [4, 9, 20]),
        "StepDecay": lambda: m.StepDecay(0.5, 7, gamma=0.5),
        "LambdaDecay": lambda: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "CosineAnnealingDecay": lambda: m.CosineAnnealingDecay(0.5, 10, 0.01),
        "CosineAnnealingWarmRestarts": lambda: m.CosineAnnealingWarmRestarts(
            0.5, 4, T_mult=2, eta_min=0.01),
        "ReduceOnPlateau": lambda: m.ReduceOnPlateau(0.5, patience=2,
                                                     cooldown=1),
        "OneCycleLR": lambda: m.OneCycleLR(0.5, 25),
        "CyclicLR": lambda: m.CyclicLR(0.01, 0.5, 4, mode="triangular2"),
        "CyclicLR_exp": lambda: m.CyclicLR(0.01, 0.5, 3, 5, mode="exp_range",
                                           exp_gamma=0.9),
        "MultiplicativeDecay": lambda: m.MultiplicativeDecay(
            0.5, lambda e: 0.9 if e % 3 else 1.1),
    }


def _plateau_metric(i):
    return [5.0, 4.0, 4.0, 4.1, 4.2, 4.3, 3.0, 3.0, 3.1, 3.2][i % 10]


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_matches_reference_over_30_steps(name):
    """30 steps of the port's scheduler against the reference's, the
    port's state moved through ``state_dict`` into a fresh scheduler at
    step 15."""
    ref, mine = _schedulers(jlr)[name](), _schedulers(tlr)[name]()
    assert isinstance(mine, tlr.LRScheduler)
    for i in range(30):
        assert math.isclose(mine.get_lr(), ref.get_lr(), rel_tol=1e-12,
                            abs_tol=1e-15), (name, i)
        if i == 15:
            sd = mine.state_dict()
            mine = _schedulers(tlr)[name]()
            mine.set_state_dict(sd)
        if name == "ReduceOnPlateau":
            ref.step(_plateau_metric(i))
            mine.step(torch.tensor(_plateau_metric(i)))
        else:
            ref.step()
            mine.step()


def test_all_sixteen_schedulers_are_ported():
    names = [n for n, v in vars(jlr).items() if isinstance(v, type)
             and issubclass(v, jlr.LRScheduler) and v is not jlr.LRScheduler]
    assert len(names) == 16
    assert all(issubclass(getattr(tlr, n), tlr.LRScheduler) for n in names)


OPTIMIZERS = [
    ("SGD", dict(learning_rate=0.1, weight_decay=0.01)),
    ("Momentum", dict(learning_rate=0.1, weight_decay=0.01)),
    ("Momentum", dict(learning_rate=0.1, use_nesterov=True)),
    ("Adam", dict(learning_rate=0.01, weight_decay=0.1)),
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.1)),
    ("Adamax", dict(learning_rate=0.01, weight_decay=0.01)),
    ("Adagrad", dict(learning_rate=0.1, initial_accumulator_value=0.1)),
    ("Adadelta", dict(learning_rate=1.0, weight_decay=0.01)),
    ("RMSProp", dict(learning_rate=0.01, momentum=0.9)),
    ("RMSProp", dict(learning_rate=0.01, centered=True)),
    ("Lamb", dict(learning_rate=0.01)),
]


def _arrays(seed, n=STEPS):
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in SHAPES.items()}
    gs = [{k: rng.standard_normal(s).astype(np.float32)
           for k, s in SHAPES.items()} for _ in range(n)]
    return p, gs


def _close(mine, ref, what):
    """bf16 (``what`` starts with "bf16") bit for bit; float32 within
    1e-6."""
    mine = mine.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    if str(what).startswith("bf16"):
        np.testing.assert_array_equal(mine, ref, err_msg=what)
    else:
        np.testing.assert_allclose(mine, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=what)


@pytest.mark.parametrize("dtype,slot_dtype", [
    ("float32", None), ("bfloat16", None), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16")])
@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{'-'.join(k)}" for n, k in OPTIMIZERS])
def test_three_functional_steps_match_reference(name, kw, dtype,
                                                slot_dtype):
    """``init_state`` / ``apply_gradients`` for three steps against the
    reference's, params and slots of either dtype."""
    p, gs = _arrays(1)
    jo, to = getattr(J, name)(**kw), getattr(T, name)(**kw)
    tdt = getattr(torch, dtype)
    jp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    tp = {k: torch.tensor(v).to(tdt) for k, v in p.items()}
    js = jo.init_state(jp, slot_dtype=None if slot_dtype is None
                       else jnp.dtype(slot_dtype))
    ts = to.init_state(tp, slot_dtype=None if slot_dtype is None
                       else getattr(torch, slot_dtype))
    for g in gs:
        jp, js = jo.apply_gradients(
            jp, {k: jnp.asarray(v, dtype) for k, v in g.items()}, js)
        out = to.apply_gradients(
            tp, {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, ts)
        assert out[0] is tp and out[1] is ts
    tag = "bf16" if dtype == "bfloat16" else "f32"
    for k in p:
        assert tp[k].dtype == tdt
        _close(tp[k], jp[k], f"{tag} {name} param {k}")
        for n, s in ts["slots"][k].items():
            stag = "bf16" if slot_dtype == "bfloat16" else "f32"
            _close(s, js["slots"][k][n], f"{stag} {name} slot {n}")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == STEPS


def test_adam_l2_rounds_in_the_grads_bf16():
    """Adam's L2 term is added in the grad's dtype: for bf16 grads ``wd``,
    ``wd * p`` and the sum each round to bf16, as the reference's weak
    scalar does. The port matches the reference bit for bit, and the
    same math without those roundings lands elsewhere."""
    p, gs = _arrays(2)
    jo = J.Adam(learning_rate=0.05, weight_decay=0.3)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    js = jo.init_state(jp)
    outs = {}
    for wd_dtype in (torch.bfloat16, torch.float32):
        tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
        step = torch.zeros((), dtype=torch.int32)
        slots = {k: {n: torch.zeros(v.shape) for n in ("m", "v")}
                 for k, v in p.items()}
        for g in gs:
            entries = []
            for k, v in g.items():
                gt = torch.from_numpy(v).to(torch.bfloat16)
                if wd_dtype == torch.float32:   # L2 in float32 instead
                    gt = (gt.float() + 0.3 * tp[k].float()).to(torch.bfloat16)
                entries.append(mta.AdamEntry(
                    tp[k], gt, slots[k]["m"], slots[k]["v"], None,
                    0.3 if wd_dtype == torch.bfloat16 else 0.0))
            mta.multi_tensor_adam(entries, torch.tensor(0.05), step,
                                  beta1=0.9, beta2=0.999, epsilon=1e-8,
                                  adamw=False)
            step += 1
        outs[wd_dtype] = tp
    for g in gs:
        jp, js = jo.apply_gradients(
            jp, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}, js)
    for k in p:
        _close(outs[torch.bfloat16][k], jp[k], f"bf16 Adam L2 {k}")
    assert any(not torch.equal(outs[torch.bfloat16][k],
                               outs[torch.float32][k]) for k in p)


def _jparams(p, dtype):
    return [JParameter(jnp.asarray(v, dtype), name=k) for k, v in p.items()]


def _tparams(p, dtype):
    return [(k, torch.nn.Parameter(torch.tensor(v).to(dtype)))
            for k, v in p.items()]


def _eager_steps(jo, to, jps, tps, gs, dtype):
    for g in gs:
        for jpar, (k, tpar) in zip(jps, tps):
            jpar._grad = JTensor(jnp.asarray(g[k], dtype))
            tpar.grad = torch.from_numpy(g[k]).to(tpar.dtype)
        jo.step()
        to.step()


@pytest.mark.parametrize("name,kw", [
    ("AdamW", dict(learning_rate=0.01, weight_decay=0.1)),
    ("Adam", dict(learning_rate=0.01, weight_decay=0.1)),
    ("Momentum", dict(learning_rate=0.1, weight_decay=0.01)),
    ("Lamb", dict(learning_rate=0.01))], ids=lambda x: str(x)[:10])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eager_step_matches_reference(name, kw, dtype):
    """``Optimizer(parameters=...).step()`` reading ``p.grad``, three
    steps, against the reference's eager step; then ``state_dict`` keys
    and values, and ``clear_grad``."""
    p, gs = _arrays(3)
    jps = _jparams(p, dtype)
    tps = _tparams(p, getattr(torch, dtype))
    jo = getattr(J, name)(parameters=jps, **kw)
    to = getattr(T, name)(parameters=tps, **kw)
    _eager_steps(jo, to, jps, tps, gs, dtype)
    tag = "bf16" if dtype == "bfloat16" else "f32"
    for jpar, (k, tpar) in zip(jps, tps):
        _close(tpar.detach(), jpar._value, f"{tag} {name} {k}")
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert list(tsd) == list(jsd)
    assert int(tsd["@step"]) == int(np.asarray(jsd["@step"]._value)) == STEPS
    for key in jsd:
        if key != "@step":
            _close(tsd[key], jsd[key]._value, f"f32 {key}")
    to.clear_grad()
    assert all(t.grad is None for _, t in tps)


def test_eager_step_multi_precision_matches_reference():
    """``multi_precision=True`` on bf16 params: float32 masters, updated
    by the rule (the Adam kernel's master form), the bf16 param their
    rounding; the masters round-trip through ``state_dict``."""
    p, gs = _arrays(4)
    jps = _jparams(p, "bfloat16")
    tps = _tparams(p, torch.bfloat16)
    kw = dict(learning_rate=0.01, weight_decay=0.05, multi_precision=True)
    jo, to = J.AdamW(parameters=jps, **kw), T.AdamW(parameters=tps, **kw)
    _eager_steps(jo, to, jps, tps, gs, "bfloat16")
    jsd, tsd = jo.state_dict(), to.state_dict()
    for jpar, (k, tpar) in zip(jps, tps):
        _close(tpar.detach(), jpar._value, f"bf16 master {k}")
        assert tsd[f"{k}.master"].dtype == torch.float32
        _close(tsd[f"{k}.master"], jsd[f"{k}.master"]._value, f"f32 {k}")
    twin = T.AdamW(parameters=_tparams(p, torch.bfloat16), **kw)
    twin.set_state_dict(tsd)
    assert twin._step_count == STEPS
    assert all(torch.equal(twin.state_dict()[k], v) for k, v in tsd.items()
               if k != "@step")


def test_apply_decay_param_fun_matches_reference():
    """AdamW's ``apply_decay_param_fun`` in the eager step: only the
    parameters it names decay."""
    p, gs = _arrays(5)
    jps, tps = _jparams(p, "float32"), _tparams(p, torch.float32)
    kw = dict(learning_rate=0.01, weight_decay=0.5,
              apply_decay_param_fun=lambda n: n != "b")
    jo, to = J.AdamW(parameters=jps, **kw), T.AdamW(parameters=tps, **kw)
    _eager_steps(jo, to, jps, tps, gs, "float32")
    for jpar, (k, tpar) in zip(jps, tps):
        _close(tpar.detach(), jpar._value, f"f32 decay {k}")
    plain = T.AdamW(parameters=_tparams(p, torch.float32),
                    learning_rate=0.01, weight_decay=0.5)
    for g in gs:
        for k, t in zip(p, plain._parameter_list):
            t.grad = torch.from_numpy(g[k])
        plain.step()
    b = dict(tps)["b"].detach()
    assert not torch.equal(b, plain._parameter_list[1].detach())


def test_lr_scheduler_drives_the_optimizer():
    """A scheduler as ``learning_rate``: ``get_lr`` follows it, ``set_lr``
    refuses, the eager step uses it, and ``@lr`` rides in
    ``state_dict``."""
    sched = tlr.StepDecay(0.5, 1, gamma=0.1)
    par = torch.nn.Parameter(torch.ones(4))
    opt = T.SGD(learning_rate=sched, parameters=[par])
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(0.1)
    par.grad = torch.ones(4)
    opt.step()
    assert torch.allclose(par.detach(), torch.full((4,), 0.5))
    sched.step()
    assert opt.get_lr() == pytest.approx(0.05)
    opt.step()
    assert torch.allclose(par.detach(), torch.full((4,), 0.45))
    assert opt.state_dict()["@lr"]["last_epoch"] == 1
    fixed = T.SGD(learning_rate=0.1, parameters=[par])
    fixed.set_lr(0.2)
    assert fixed.get_lr() == 0.2


def test_minimize_and_the_slices_left_out():
    par = torch.nn.Parameter(torch.ones(3))
    opt = T.SGD(learning_rate=0.5, parameters=[par])
    assert opt.minimize((par * 2).sum()) == (None, None)
    assert torch.allclose(par.detach(), torch.zeros(3)) and par.grad is None
    with pytest.raises(NotImplementedError, match="A14"):
        opt.minimize((par * 2).sum(), startup_program=object())
    with pytest.raises(NotImplementedError, match="A11"):
        T.AdamW(slot_placement="host")
    with pytest.raises(ValueError, match="without parameters"):
        T.AdamW().step()


def _clip_pairs(g, dtype):
    jpairs = [(JParameter(jnp.zeros(v.shape, dtype), name=k),
               JTensor(jnp.asarray(v, dtype))) for k, v in g.items()]
    tpairs = [(torch.nn.Parameter(torch.zeros(v.shape, dtype=getattr(
        torch, dtype))), torch.from_numpy(v).to(getattr(torch, dtype)))
        for k, v in g.items()]
    return jpairs, tpairs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["value", "norm", "global_norm"])
def test_clips_match_reference(form, dtype):
    """The three clip classes, eager pairs and functional dicts, against
    the reference; a param with ``need_clip = False`` passes through."""
    _, (g,) = _arrays(6, 1)
    g = {k: v * 3 for k, v in g.items()}
    make = {"value": lambda m: m.ClipGradByValue(1.5, -0.5),
            "norm": lambda m: m.ClipGradByNorm(2.0),
            "global_norm": lambda m: m.ClipGradByGlobalNorm(4.0)}[form]
    jc, tc = make(jnn), make(tnn)
    jfun = jc.apply_functional({k: jnp.asarray(v, dtype)
                                for k, v in g.items()})
    tfun = tc.apply_functional({k: torch.from_numpy(v).to(getattr(
        torch, dtype)) for k, v in g.items()})
    tag = "bf16" if dtype == "bfloat16" else "f32"
    for k in g:
        _close(tfun[k], jfun[k], f"{tag} {form} {k}")
    jpairs, tpairs = _clip_pairs(g, dtype)
    jpairs[1][0].need_clip = False
    tpairs[1][0].need_clip = False
    for (jp, jg), (tp, tg) in zip(jc(jpairs), tc(tpairs)):
        _close(tg, jg._value, f"{tag} {form} eager")
    assert torch.equal(tc(tpairs)[1][1], tpairs[1][1])


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_reference(norm_type):
    _, (g,) = _arrays(7, 1)
    jps = [JParameter(jnp.zeros(v.shape)) for v in g.values()]
    tps = [torch.nn.Parameter(torch.zeros(v.shape)) for v in g.values()]
    for jp, tp, v in zip(jps, tps, g.values()):
        jp._grad = JTensor(jnp.asarray(v))
        tp.grad = torch.from_numpy(v.copy())
    jtotal = jnn.clip_grad_norm_(jps, 1.0, norm_type)
    ttotal = tnn.clip_grad_norm_(tps, 1.0, norm_type)
    _close(ttotal, jtotal._value, "f32 total")
    for jp, tp in zip(jps, tps):
        _close(tp.grad, jp.grad._value, "f32 clipped")


def _entries(seed, pdt, gdt, sdt, master=False, wd=0.01):
    p, (g,) = _arrays(seed, 1)
    out = []
    for k in p:
        pt = torch.tensor(p[k]).to(pdt)
        out.append(mta.AdamEntry(
            pt, torch.from_numpy(g[k]).to(gdt),
            torch.full(pt.shape, 0.01, dtype=sdt),
            torch.full(pt.shape, 0.02, dtype=sdt),
            pt.float() if master else None, wd))
    return out


def test_kernel_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors `multi_tensor_adam` is `adam_reference`, launches
    nothing, and with ``found_inf`` set writes nothing; the clip scale
    and a master take their place in the math."""
    kernels.reset_kernel_launch_counts()
    for adamw in (False, True):
        a = _entries(8, torch.bfloat16, torch.float32, torch.bfloat16,
                     master=True)
        b = [mta.AdamEntry(*(t.clone() if isinstance(t, torch.Tensor) else t
                             for t in e)) for e in a]
        kw = dict(beta1=0.9, beta2=0.99, epsilon=1e-6, adamw=adamw,
                  clip_scale=torch.tensor(0.5))
        lr, step = torch.tensor(0.1), torch.tensor(4, dtype=torch.int32)
        mta.multi_tensor_adam(a, lr, step, **kw)
        mta.adam_reference(b, lr, step, **kw)
        for x, y in zip(a, b):
            for s, t in zip(x[:5], y[:5]):
                assert torch.equal(s, t)
            assert torch.equal(x.p, x.master.to(torch.bfloat16))
        c = [mta.AdamEntry(*(t.clone() if isinstance(t, torch.Tensor) else t
                             for t in e)) for e in a]
        mta.multi_tensor_adam(c, lr, step, found_inf=torch.tensor(
            1, dtype=torch.int32), **kw)
        assert all(torch.equal(s, t) for x, y in zip(a, c)
                   for s, t in zip(x[:5], y[:5]))
    assert kernels.kernel_launch_counts()["multi_tensor_adam"] == 0
    bf16 = _entries(9, torch.bfloat16, torch.bfloat16, torch.bfloat16)
    n = sum(e.p.numel() for e in bf16)
    assert mta.update_bytes(bf16) == 14 * n
    f32m = _entries(9, torch.bfloat16, torch.float32, torch.float32, True)
    assert mta.update_bytes(f32m) == (2 + 8 + 4 + 16) * n


def test_adamw_apply_gradients_with_a_fused_clip_matches_reference():
    """AdamW with a global-norm clip: the port hands the clip's scale to
    the update (the kernel's form), the reference clips first; bf16 and
    float32 params agree as the unclipped update does."""
    p, gs = _arrays(10)
    for dtype in ("float32", "bfloat16"):
        kw = dict(learning_rate=0.01, weight_decay=0.01)
        jo = J.AdamW(grad_clip=jnn.ClipGradByGlobalNorm(0.5), **kw)
        to = T.AdamW(grad_clip=tnn.ClipGradByGlobalNorm(0.5), **kw)
        jp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
        tp = {k: torch.tensor(v).to(getattr(torch, dtype))
              for k, v in p.items()}
        js, ts = jo.init_state(jp), to.init_state(tp)
        for g in gs:
            jp, js = jo.apply_gradients(
                jp, {k: jnp.asarray(v, dtype) for k, v in g.items()}, js)
            to.apply_gradients(tp, {k: torch.from_numpy(v).to(getattr(
                torch, dtype)) for k, v in g.items()}, ts)
        tag = "bf16" if dtype == "bfloat16" else "f32"
        for k in p:
            _close(tp[k], jp[k], f"{tag} clipped {k}")
