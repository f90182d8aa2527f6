"""The port stands alone: importing paddle_tpu_torch pulls in neither
jax nor paddle_tpu, its entry points refuse to run without a device
when no GPU is visible, arguments of later slices are refused by name,
and chip_smoke.py prints no result without a card."""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.device import resolve_device, resolve_dtype
from paddle_tpu_torch.kernels.paged_attention import fused_paged_attention
from paddle_tpu_torch.models.gpt import GPTForPretraining
from paddle_tpu_torch.serving import Engine

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
           "paddle_tpu_torch.core", "paddle_tpu_torch.core.random",
           "paddle_tpu_torch.kernels.flash_attention",
           "paddle_tpu_torch.kernels.fused_ce", "paddle_tpu_torch.nn",
           "paddle_tpu_torch.nn.clip", "paddle_tpu_torch.nn.layer",
           "paddle_tpu_torch.optimizer",
           "paddle_tpu_torch.optimizer.optimizer",
           "paddle_tpu_torch.optimizer.optimizers",
           "paddle_tpu_torch.distributed",
           "paddle_tpu_torch.distributed.spmd",
           "paddle_tpu_torch.nn.common", "paddle_tpu_torch.nn.norm",
           "paddle_tpu_torch.nn.transformer", "paddle_tpu_torch.models.bert",
           "paddle_tpu_torch.kernels.fused_ln", "paddle_tpu_torch.incubate",
           "paddle_tpu_torch.incubate.nn",
           "paddle_tpu_torch.incubate.nn.functional",
           "paddle_tpu_torch.incubate.nn.layers"]


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
    with pytest.raises(ValueError):
        resolve_dtype("float16")


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 1, 64)
    pool = torch.zeros(2, 1, 8, 64)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    st = torch.zeros(1, dtype=torch.int32)
    vc = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fused_paged_attention(q, pool, pool, bt, st, vc)


@pytest.mark.parametrize("kw", [
    dict(kv_mode="slots"), dict(prefix_cache=True),
    dict(draft_model=lambda ctx, k: []), dict(chunk_tokens=8),
    dict(spec_adaptive=True), dict(weight_quant="int8"),
    dict(mesh=object()), dict(role="prefill"), dict(kv_pool=object()),
    dict(default_deadline_s=1.0), dict(max_queue=4)],
    ids=lambda kw: next(iter(kw)))
def test_engine_later_slice_arguments_raise(kw):
    model = GPTForPretraining("gpt-test", device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        Engine(model, slots=2, max_len=16, device="cpu", **kw)


def test_engine_later_slice_calls_raise():
    model = GPTForPretraining("gpt-test", device="cpu")
    eng = Engine(model, slots=2, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        eng.start()
    with pytest.raises(NotImplementedError, match="later slice"):
        eng.submit(np.arange(1, 4), deadline_s=1.0)
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
