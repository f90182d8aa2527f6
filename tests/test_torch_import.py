"""The port stands alone: importing paddle_tpu_torch pulls in neither
jax nor paddle_tpu, its entry points refuse to run without a device
when no GPU is visible, arguments of later slices are refused by name,
and chip_smoke.py prints no result without a card. The signature walks
hold every parameter of the reference's `Engine`, `RequestHandle` and
`generate` against the port: taken at its default, and at another value
served or refused with `NotImplementedError` naming a ROADMAP queue-A
item."""
import inspect
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.device import resolve_device, resolve_dtype
from paddle_tpu_torch.kernels.paged_attention import fused_paged_attention
from paddle_tpu_torch.models.gpt import GPTForPretraining
from paddle_tpu_torch.observability import SLO
from paddle_tpu_torch.serving import Engine, FaultInjector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")

MODULES = ["paddle_tpu_torch", "paddle_tpu_torch.device",
           "paddle_tpu_torch.kernels", "paddle_tpu_torch.kernels._build",
           "paddle_tpu_torch.kernels.paged_kv",
           "paddle_tpu_torch.kernels.paged_attention",
           "paddle_tpu_torch.nn.functional", "paddle_tpu_torch.models",
           "paddle_tpu_torch.models.gpt", "paddle_tpu_torch.models.convert",
           "paddle_tpu_torch.models.generation", "paddle_tpu_torch.serving",
           "paddle_tpu_torch.serving.engine",
           "paddle_tpu_torch.serving.compiled",
           "paddle_tpu_torch.serving.kv_slots",
           "paddle_tpu_torch.serving.prefix_cache",
           "paddle_tpu_torch.core", "paddle_tpu_torch.core.random",
           "paddle_tpu_torch.kernels.flash_attention",
           "paddle_tpu_torch.kernels.fused_ce", "paddle_tpu_torch.nn",
           "paddle_tpu_torch.nn.clip", "paddle_tpu_torch.nn.layer",
           "paddle_tpu_torch.optimizer",
           "paddle_tpu_torch.optimizer.optimizer",
           "paddle_tpu_torch.optimizer.optimizers",
           "paddle_tpu_torch.optimizer.lr", "paddle_tpu_torch.amp",
           "paddle_tpu_torch.amp.grad_scaler",
           "paddle_tpu_torch.kernels.multi_tensor_adam",
           "paddle_tpu_torch.distributed",
           "paddle_tpu_torch.distributed.spmd",
           "paddle_tpu_torch.distributed.topology",
           "paddle_tpu_torch.distributed.collective",
           "paddle_tpu_torch.distributed.spawn",
           "paddle_tpu_torch.distributed.sequence_parallel",
           "paddle_tpu_torch.nn.common", "paddle_tpu_torch.nn.norm",
           "paddle_tpu_torch.nn.transformer", "paddle_tpu_torch.models.bert",
           "paddle_tpu_torch.kernels.fused_ln", "paddle_tpu_torch.incubate",
           "paddle_tpu_torch.incubate.nn",
           "paddle_tpu_torch.incubate.nn.functional",
           "paddle_tpu_torch.incubate.nn.layers",
           "paddle_tpu_torch.observability",
           "paddle_tpu_torch.observability.registry",
           "paddle_tpu_torch.observability.sentinel",
           "paddle_tpu_torch.jit", "paddle_tpu_torch.jit.capture",
           "paddle_tpu_torch.serving.timeline",
           "paddle_tpu_torch.serving.faults",
           "paddle_tpu_torch.serving.speculative",
           "paddle_tpu_torch.serving.request",
           "paddle_tpu_torch.serving.errors",
           "paddle_tpu_torch.framework", "paddle_tpu_torch.framework.io",
           "paddle_tpu_torch.framework.checkpoint",
           "paddle_tpu_torch.framework.train_faults",
           "paddle_tpu_torch.framework.train_loop",
           "paddle_tpu_torch.observability.tracing",
           "paddle_tpu_torch.observability.train_introspection",
           "paddle_tpu_torch.observability.threads",
           "paddle_tpu_torch.nn.conv", "paddle_tpu_torch.models.vit",
           "paddle_tpu_torch.distributed.moe",
           "paddle_tpu_torch.incubate.distributed",
           "paddle_tpu_torch.incubate.distributed.models",
           "paddle_tpu_torch.incubate.distributed.models.moe",
           "paddle_tpu_torch.incubate.distributed.models.moe.gate",
           "paddle_tpu_torch.incubate.distributed.models.moe.moe_layer",
           "paddle_tpu_torch.core.parameter",
           "paddle_tpu_torch.framework.param_attr",
           "paddle_tpu_torch.nn.initializer",
           "paddle_tpu_torch.nn.container", "paddle_tpu_torch.regularizer",
           "paddle_tpu_torch.nn.functional.activation",
           "paddle_tpu_torch.nn.functional.common",
           "paddle_tpu_torch.nn.functional.conv",
           "paddle_tpu_torch.nn.functional.loss",
           "paddle_tpu_torch.nn.functional.norm",
           "paddle_tpu_torch.nn.functional.pooling",
           "paddle_tpu_torch.nn.functional.vision",
           "paddle_tpu_torch.nn.activation", "paddle_tpu_torch.nn.loss",
           "paddle_tpu_torch.nn.pooling", "paddle_tpu_torch.vision",
           "paddle_tpu_torch.vision.models",
           "paddle_tpu_torch.vision.models.resnet",
           "paddle_tpu_torch.nn.rnn", "paddle_tpu_torch.nn.decode",
           "paddle_tpu_torch.nn.extra_layers", "paddle_tpu_torch.nn.utils",
           "paddle_tpu_torch.nn.functional.extra",
           "paddle_tpu_torch.nn.quant",
           "paddle_tpu_torch.nn.quant.quant_layers",
           "paddle_tpu_torch.nn.quant.functional_layers",
           "paddle_tpu_torch.quantization",
           "paddle_tpu_torch.quantization.layers",
           "paddle_tpu_torch.core.dtype", "paddle_tpu_torch.core.place",
           "paddle_tpu_torch.core.tensor", "paddle_tpu_torch.core.autograd",
           "paddle_tpu_torch.core.dispatch",
           "paddle_tpu_torch.amp.auto_cast", "paddle_tpu_torch.autograd",
           "paddle_tpu_torch.testing", "paddle_tpu_torch.testing.optest",
           "paddle_tpu_torch.ops", "paddle_tpu_torch.ops.creation",
           "paddle_tpu_torch.ops.math", "paddle_tpu_torch.ops.manip",
           "paddle_tpu_torch.ops.linalg", "paddle_tpu_torch.ops.methods",
           "paddle_tpu_torch.linalg", "paddle_tpu_torch.fft",
           "paddle_tpu_torch.signal", "paddle_tpu_torch.profiler",
           "paddle_tpu_torch.profiler.profiler",
           "paddle_tpu_torch.observability.slo",
           "paddle_tpu_torch.observability.costs",
           "paddle_tpu_torch.observability.flight_recorder",
           "paddle_tpu_torch.observability.server",
           "paddle_tpu_torch.observability.process_stats"]

#: the reference's top-level names of A2 and A3 (``paddle_tpu/__init__.py
#: :78-106``): dtypes, places, seeds and generator states, grad mode,
#: `grad`, `Tensor`, `Parameter`, `autograd`, `amp`
CORE_NAMES = ["enable_grad", "is_grad_enabled", "no_grad", "set_grad_enabled",
              "bfloat16", "bool_", "complex64", "complex128", "float16",
              "float32", "float64", "int8", "int16", "int32", "int64",
              "uint8", "CPUPlace", "CUDAPinnedPlace", "CUDAPlace",
              "NPUPlace", "Place", "TPUPlace", "device_count", "get_device",
              "is_compiled_with_cuda", "is_compiled_with_tpu", "set_device",
              "get_rng_state", "seed", "set_rng_state", "get_cuda_rng_state",
              "set_cuda_rng_state", "Parameter", "Tensor", "ParamAttr",
              "grad", "autograd", "amp", "bool", "dtype"]


def test_import_pulls_in_no_jax_and_no_paddle_tpu():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_core_top_level_names_are_the_references():
    import paddle_tpu
    import paddle_tpu_torch

    for name in CORE_NAMES:
        assert hasattr(paddle_tpu, name), name
        assert hasattr(paddle_tpu_torch, name), name
    assert paddle_tpu_torch.Tensor is torch.Tensor
    assert paddle_tpu_torch.float16 is torch.float16
    assert paddle_tpu_torch.autograd.PyLayer.__name__ == \
        paddle_tpu.autograd.PyLayer.__name__
    assert paddle_tpu_torch.amp.auto_cast.__name__ == "auto_cast"


BLOCKED = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes", "orbax")


def test_framework_works_with_jax_ml_dtypes_and_orbax_blocked(tmp_path):
    """With jax, paddle_tpu, ml_dtypes and orbax unimportable, the
    framework imports, reads a bfloat16 file paddle_tpu.save wrote (its
    pickle names ml_dtypes.bfloat16), writes one, and checkpoints."""
    import jax.numpy as jnp
    import ml_dtypes

    from paddle_tpu.core.tensor import Parameter as JParameter
    from paddle_tpu.framework import io as jio

    a = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    jio.save({"w": JParameter(jnp.asarray(a.astype(ml_dtypes.bfloat16)))},
             str(tmp_path / "ref.pd"))
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {BLOCKED!r}:\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from paddle_tpu_torch import framework as fw\n"
        "from paddle_tpu_torch.framework import checkpoint as ck\n"
        f"d = {str(tmp_path)!r}\n"
        "w = fw.load(d + '/ref.pd')['w']\n"
        "assert w.dtype == torch.bfloat16, w.dtype\n"
        "fw.save({'w': w}, d + '/port.pd')\n"
        "assert torch.equal(fw.load(d + '/port.pd')['w'], w)\n"
        "m = ck.CheckpointManager(d + '/ckpt')\n"
        "m.save(1, {'w': w}, {'step': 1}, block=True)\n"
        "assert torch.equal(m.restore_latest()[1]['w'], w)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r})\n"
        "print(w.float().tolist(), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    want = a.astype(ml_dtypes.bfloat16).astype(np.float32).tolist()
    assert res.stdout.startswith(repr(want))
    back = jio.load(str(tmp_path / "port.pd"), return_numpy=True)["w"]
    assert back.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back.astype(np.float32), want)


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_paddle_tpu():
    pat = re.compile(r"^\s*(import|from)\s+(jax|paddle_tpu)(\.|\s|$)")
    hits = []
    for path in _sources():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pat.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{i}: {line}")
    assert not hits, "".join(hits)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_raises_without_device_and_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForPretraining("gpt-test")


def test_train_step_runs_where_the_model_is():
    """The trainer has no device of its own: its params live with the
    model (cuda unless the model was built with device='cpu')."""
    from paddle_tpu_torch.distributed import SpmdTrainStep, gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForPretraining("gpt-test", device="cpu")
    params, state = SpmdTrainStep(model, gpt_loss_fn, AdamW()).init(
        dtype="bfloat16", slot_dtype="bfloat16")
    assert {p.device.type for p in params.values()} == {"cpu"}
    assert {p.dtype for p in params.values()} == {torch.bfloat16}
    assert state["slots"]["gpt.ln_f.weight"]["moment1"].dtype \
        == torch.bfloat16


def test_distributed_entry_points_need_a_gpu_or_a_world(no_gpu):
    """`init_parallel_env` goes to NCCL on the card unless asked for the
    CPU (gloo), so without a GPU it raises before joining anything; a
    mesh needs an initialised world."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import HybridMesh, init_parallel_env

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_parallel_env()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        HybridMesh(sp=2, device_type="cpu")


def test_engine_raises_without_device_and_gpu(no_gpu):
    model = GPTForPretraining("gpt-test", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, slots=2, max_len=16)
    Engine(model, slots=2, max_len=16, device="cpu")   # explicit CPU is fine


def test_engine_refuses_a_device_other_than_the_models():
    model = GPTForPretraining("gpt-test", device="cpu")
    with pytest.raises(ValueError, match="model is on"):
        Engine(model, slots=2, max_len=16, device="meta")


def test_dtype_names():
    assert resolve_dtype("bfloat16") is torch.bfloat16
    assert resolve_dtype(torch.float32) is torch.float32
    assert resolve_dtype("float16") is torch.float16
    with pytest.raises(ValueError):
        resolve_dtype("float8_e4m3fn")


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 1, 64)
    pool = torch.zeros(2, 1, 8, 64)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    st = torch.zeros(1, dtype=torch.int32)
    vc = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fused_paged_attention(q, pool, pool, bt, st, vc)


#: the Engine arguments of the later-slice table that have since arrived
#: (A2's dtype and A9's four): each case now holds that the
#: argument is served
ARRIVED = {"profiler", "observability_port", "flight_recorder", "slo",
           "dtype"}


@pytest.mark.parametrize("kw", [
    dict(profiler=lambda event, info: None), dict(sharding_rule=object()),
    dict(observability_port=0), dict(flight_recorder=True),
    dict(slo=SLO(ttft_p99_s=60.0)), dict(dtype="float32"),
    dict(mesh=object()), dict(role="prefill"), dict(kv_pool=object())],
    ids=lambda kw: next(iter(kw)))
def test_engine_later_slice_arguments_raise(kw):
    """The arguments still labelled for a later slice raise, naming it;
    the arrived ones (`ARRIVED`) build an engine that serves."""
    model = GPTForPretraining("gpt-test", device="cpu")
    if next(iter(kw)) in ARRIVED:
        eng = Engine(model, slots=2, max_len=16, device="cpu", **kw)
        try:
            assert len(eng.submit([1, 2, 3], max_new_tokens=2).result()) == 2
        finally:
            eng.close()
        return
    with pytest.raises(NotImplementedError, match="later slice"):
        Engine(model, slots=2, max_len=16, device="cpu", **kw)


def test_engine_later_slice_calls_raise():
    model = GPTForPretraining("gpt-test", device="cpu")
    eng = Engine(model, slots=2, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="beam search"):
        eng.submit(np.arange(1, 4), decode_strategy="beam_search")
    with pytest.raises(TypeError, match="unexpected argument"):
        Engine(model, slots=2, max_len=16, device="cpu", banana=1)


def test_chip_smoke_prints_no_result_without_a_card(tmp_path):
    """Here (no CUDA) the script exits non-zero and prints no result,
    from the repo root and from a directory holding only the script."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT),
                        (str(lone), str(tmp_path))):
        res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


# -- signature walks over the reference's surfaces --------------------------
def _reference_params(fn, skip=()):
    return [p for p in inspect.signature(fn).parameters.values()
            if p.name not in ("self",) + tuple(skip)
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _served_or_named(call):
    """``call()`` is served, or refused with NotImplementedError naming a
    queue-A item (``A<n>``)."""
    try:
        call()
    except NotImplementedError as exc:
        assert re.search(r"\bA\d+", str(exc)), str(exc)


#: a value other than the default for every reference Engine parameter
ENGINE_OTHER = dict(
    slots=2, max_len=24, prefill_buckets=(8,), top_k=5, weight_quant="int8",
    mesh=object(), sharding_rule=object(), dtype="bfloat16",
    profiler=lambda event, info: None, seed=3, kv_mode="slots",
    page_size=8, kv_pages=20,
    prefix_cache=True, engine_id="e1", role="prefill", kv_pool=object(),
    default_deadline_s=1.0, max_queue=4, shed_policy="shed_newest",
    admission_retries=3, fault_injector=FaultInjector(), spec_k=2,
    spec_ngram=2,
    draft_model=lambda ctx, k: [], spec_adaptive=True, spec_k_max=4,
    observability_port=0, flight_recorder=True, kv_quant="int8",
    kv_pool_bytes=1 << 20, slo=SLO(ttft_p99_s=60.0), chunk_tokens=8)
#: what a parameter's other value needs beside it (the reference refuses
#: adaptive speculation and a k ceiling without a starting k)
ENGINE_WITH = dict(spec_adaptive=dict(spec_k=2), spec_k_max=dict(spec_k=2))


def _jax_engine_params():
    from paddle_tpu.serving import Engine as JaxEngine

    return _reference_params(JaxEngine.__init__, skip=("model",))


@pytest.mark.parametrize("param", _jax_engine_params(), ids=lambda p: p.name)
def test_engine_takes_every_reference_parameter(param):
    model = GPTForPretraining("gpt-test", device="cpu")
    base = dict(max_len=16, device="cpu")

    def serve(**kw):
        eng = Engine(model, **{**base, **kw})
        try:
            assert len(eng.submit([1, 2, 3],
                                  max_new_tokens=2).result()) == 2
        finally:
            eng.close()

    if param.name != "max_len":          # None: required in both packages
        serve(**{param.name: param.default})
    assert param.name in ENGINE_OTHER, f"no other value for {param.name}"
    _served_or_named(lambda: serve(**{param.name: ENGINE_OTHER[param.name]},
                                   **ENGINE_WITH.get(param.name, {})))


def test_engine_kv_pool_bytes_matches_reference_pages_in_budget():
    """``Engine(kv_pool_bytes=...)`` holds the reference's
    `pages_in_budget` page count on bf16, int8 and fp8 pools, and keeps
    its refusal of a page count given beside it."""
    from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
    from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
    from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
    from paddle_tpu.serving.paged import pages_in_budget

    jax_model = JaxGPT(JaxGPTModel(jax_gpt_config("gpt-test")))
    model = GPTForPretraining("gpt-test", device="cpu", dtype="bfloat16")
    for budget in (1 << 20, 3_000_000):
        for q in (None, "int8", "fp8"):
            want = pages_in_budget(jax_model, budget, page_size=16,
                                   dtype="bfloat16", kv_quant=q)
            eng = Engine(model, max_len=16, device="cpu", kv_quant=q,
                         kv_pool_bytes=budget)
            assert eng.kv.pages_total == want, (budget, q)
            assert eng.stats().kv_pool_bytes <= budget
    with pytest.raises(ValueError, match="not both"):
        Engine(model, max_len=16, device="cpu", kv_pool_bytes=1 << 20,
               kv_pages=8)


@pytest.mark.parametrize("method", ["tokens", "result"])
def test_request_handle_takes_every_reference_parameter(method):
    from paddle_tpu.serving.request import RequestHandle as JaxHandle

    model = GPTForPretraining("gpt-test", device="cpu")
    params = _reference_params(getattr(JaxHandle, method))
    assert [p.name for p in params] == ["timeout"]
    for value in (None, 30.0):
        eng = Engine(model, max_len=16, device="cpu")
        handle = eng.submit([1, 2, 3], max_new_tokens=3)
        out = getattr(handle, method)(timeout=value)
        assert len(list(out)) == 3


def test_request_timeout_between_steps_and_resume():
    """A step that brings no token within ``timeout`` raises TimeoutError
    from `tokens`/`result`; the request keeps its place and a later call
    finishes it."""
    model = GPTForPretraining("gpt-test", device="cpu")
    eng = Engine(model, max_len=16, device="cpu")
    handle = eng.submit([1, 2, 3], max_new_tokens=3)
    real_step = eng.step

    def slow_idle_step():
        time.sleep(0.05)
        return True

    eng.step = slow_idle_step
    with pytest.raises(TimeoutError, match="no token"):
        handle.result(timeout=0.01)
    eng.step = real_step
    assert len(handle.result(timeout=30.0)) == 3


#: a value other than the default for every reference generate parameter
GENERATE_OTHER = dict(
    max_new_tokens=3, decode_strategy="sampling", temperature=0.7, top_k=5,
    top_p=0.9, eos_token_id=3, pad_token_id=0, seed=1, mesh=object(),
    sharding_rule=object(), weight_quant="int8",
    attention_mask=[[0, 1, 1], [1, 1, 1]], num_beams=2, length_penalty=1.0,
    stream_callback=lambda col: None, beam_kv="gather")


def _jax_generate_params():
    from paddle_tpu.models.generation import GenerationMixin as JaxMixin

    return _reference_params(JaxMixin.generate, skip=("input_ids",))


@pytest.mark.parametrize("param", _jax_generate_params(),
                         ids=lambda p: p.name)
def test_generate_takes_every_reference_parameter(param):
    model = GPTForPretraining("gpt-test", device="cpu")
    ids = [[5, 6, 7], [8, 9, 10]]
    base = dict(max_new_tokens=2)

    def run(**kw):
        out = model.generate(ids, **{**base, **kw})
        assert out.shape[0] == 2 and out.dtype == torch.int64

    run(**{param.name: param.default})
    assert param.name in GENERATE_OTHER, f"no other value for {param.name}"
    _served_or_named(lambda: run(**{param.name: GENERATE_OTHER[param.name]}))


#: the port's name for a reference parameter it takes under another name:
#: a JAX mesh axis name (``shard_map``'s communicator) is a process group
#: in `torch.distributed` (``HybridMesh.group("sp")``; None: the world)
RENAMED = {"axis_name": "group"}


def _sp_surfaces():
    import importlib

    from paddle_tpu import distributed as jdist
    from paddle_tpu.distributed import sequence_parallel as jsp

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import sequence_parallel as psp

    jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
    return [(jfa.flash_attention_with_lse, kernels.flash_attention_with_lse),
            (jsp.ring_attention, psp.ring_attention),
            (jsp.ulysses_attention, psp.ulysses_attention),
            (jsp.sp_attention, psp.sp_attention),
            (jsp.shard_sequence, psp.shard_sequence),
            (jdist.spawn, pdist.spawn)]


@pytest.mark.parametrize("pair", _sp_surfaces(),
                         ids=lambda p: p[0].__name__)
def test_sequence_parallel_surfaces_take_every_reference_parameter(pair):
    """B4's entry, the sequence-parallel functions and `spawn` take the
    reference's parameters in its order, with its defaults, but where a
    parameter is renamed (`RENAMED`); the reference's name is then
    refused by name, and a ``**options`` catch-all stays one."""
    ref, port = pair
    theirs = list(inspect.signature(ref).parameters.values())
    mine = list(inspect.signature(port).parameters.values())
    assert [RENAMED.get(p.name, p.name) for p in theirs] == \
        [p.name for p in mine]
    for a, b in zip(theirs, mine):
        assert a.kind == b.kind, a.name
        if a.name in RENAMED:
            assert b.default is None, b.name        # the world's group
            with pytest.raises(TypeError, match=a.name):
                port(*([torch.zeros((1, 8, 2, 4))] * 3), **{a.name: "sp"})
        else:
            assert a.default == b.default, a.name
