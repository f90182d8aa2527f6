"""One captured step per shape bucket in the port's paged Engine, held
against paddle_tpu's ``Engine(kv_mode="paged")``, whose steps are jitted
once per bucket.

Both engines serve the same ``gpt-test`` weights through the same
staggered traffic over two prompt buckets, on float and int8 pages, with
and without speculation (``spec_k`` 0 and 4): the port builds one
decode step and one prefill step per bucket used, as the reference
traces (``decode_traces == 1``, ``prefill_traces == 2``), and emits the
reference's greedy tokens. On the CPU a `CapturedStep` runs its body
eagerly on its static buffers, through the staging a card uses, and
counts one build a bucket; its names are per engine, so a second engine
on one model builds its own steps under an armed sentinel, a new bucket
registers under its own tag, and a rebuilt step trips the sentinel.
The staging itself and the replay launch accounting are held here too.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu_torch import kernels
from paddle_tpu_torch.jit.capture import CapturedStep
from paddle_tpu_torch.models import GPTForPretraining, load_paddle_tpu_state_dict
from paddle_tpu_torch.observability import RecompileError, get_sentinel
from paddle_tpu_torch.serving import Engine

paddle.seed(211)
JAX_MODEL = JaxGPT(JaxGPTModel(jax_gpt_config("gpt-test")))
JAX_MODEL.eval()
MODEL = load_paddle_tpu_state_dict(
    GPTForPretraining("gpt-test", device="cpu"),
    {k: np.asarray(v._value) for k, v in JAX_MODEL.state_dict().items()})
MAX_NEW, SPEC_K = 6, 4
BUCKETS = (4, 8)
CONFIGS = [(q, k) for q in (None, "int8") for k in (0, SPEC_K)]
ENGINE_KW = dict(slots=2, max_len=8 + MAX_NEW + SPEC_K,
                 prefill_buckets=BUCKETS, page_size=4)
ROWS = [np.random.default_rng(7).integers(1, 255, (n,)).astype("int64")
        for n in (3, 7, 2, 6, 8)]


def _serve(eng, rows=ROWS):
    """One request, a step, two more, a step, the rest, to the end."""
    handles = [eng.submit(rows[0], max_new_tokens=MAX_NEW)]
    eng.step()
    handles += [eng.submit(r, max_new_tokens=MAX_NEW) for r in rows[1:3]]
    eng.step()
    handles += [eng.submit(r, max_new_tokens=MAX_NEW) for r in rows[3:]]
    while eng.step():
        pass
    return [h.result() for h in handles], eng.stats()


@pytest.fixture(scope="module")
def runs():
    """(reference, port) results of every configuration, served once."""
    return {(q, k): (_serve(JaxEngine(JAX_MODEL, kv_mode="paged", kv_quant=q,
                                      spec_k=k, **ENGINE_KW)),
                     _serve(Engine(MODEL, device="cpu", kv_mode="paged",
                                   kv_quant=q, spec_k=k, **ENGINE_KW)))
            for q, k in CONFIGS}


@pytest.mark.parametrize("q,k", CONFIGS, ids=lambda v: str(v))
def test_one_decode_step_and_one_prefill_step_per_bucket(runs, q, k):
    (_, ref), (_, port) = runs[(q, k)]
    assert port.decode_traces == ref.decode_traces == 1
    assert port.prefill_traces == ref.prefill_traces == len(BUCKETS)
    assert port.capture_s == 0.0           # nothing is captured on the CPU
    assert port.completed == len(ROWS) and port.kv_pages_in_use == 0


@pytest.mark.parametrize("q,k", CONFIGS, ids=lambda v: str(v))
def test_greedy_tokens_match_the_reference(runs, q, k):
    (ref_outs, ref), (outs, port) = runs[(q, k)]
    assert outs == ref_outs
    assert port.decode_steps == ref.decode_steps


def test_engines_on_one_model_name_their_steps_apart_under_an_armed_sentinel():
    sentinel = get_sentinel()
    engines = [Engine(MODEL, device="cpu", kv_mode="paged", **ENGINE_KW)
               for _ in range(2)]
    with sentinel.armed():
        outs = [_serve(eng)[0] for eng in engines]
    assert outs[0] == outs[1]
    names = [{fn.name for fn in eng._steps()} for eng in engines]
    assert not names[0] & names[1]
    for eng, ns in zip(engines, names):
        eid = eng.metrics.engine_id
        assert ns == {f"serving.decode[{eid}]",
                      f"serving.prefill[{eid}][b4]",
                      f"serving.prefill[{eid}][b8]"}
        assert all(sentinel.trace_count(n) == 1 for n in ns)


def test_a_new_bucket_registers_under_its_own_tag():
    eng = Engine(MODEL, device="cpu", kv_mode="paged", **ENGINE_KW)
    short = [r for r in ROWS if len(r) <= 4]
    with get_sentinel().armed():
        _serve(eng, short)
        assert eng.stats().prefill_traces == 1
        eng.submit(ROWS[1], max_new_tokens=2).result()   # bucket 8 at last
    s = eng.stats()
    assert (s.prefill_traces, s.decode_traces) == (2, 1)
    name = eng.metrics.step_name("prefill", "b8")
    assert name == f"serving.prefill[{eng.metrics.engine_id}][b8]"
    assert get_sentinel().trace_count(name) == 1


def test_a_rebuilt_step_trips_the_armed_sentinel():
    eng = Engine(MODEL, device="cpu", kv_mode="paged", **ENGINE_KW)
    eng.submit(ROWS[0], max_new_tokens=2).result()
    eng._prefill_fns.clear()                 # a bucket's step built again
    with get_sentinel().armed():
        h = eng.submit(ROWS[2], max_new_tokens=2)
        with pytest.raises(RecompileError, match="serving.prefill"):
            eng.step()
    # the request popped for that admission fails with the cause, and
    # the engine refuses more work
    with pytest.raises(RuntimeError, match="failed while request"):
        h.result()
    with pytest.raises(RuntimeError, match="died"):
        eng.step()


def _step(on_trace=lambda: None):
    def body(a, b, x):
        return a.long().sum() + b.long().sum() + x
    return CapturedStep("test.step", body, "cpu", pool=None,
                        on_trace=on_trace, staged=dict(a=(2, 3), b=()),
                        inputs=dict(x=((4,), torch.float32)))


@pytest.mark.parametrize("b", [0, 5, -3])
def test_captured_step_stages_operands_and_builds_once(b):
    traces = []
    fn = _step(on_trace=lambda: traces.append(1))
    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    x = torch.arange(4, dtype=torch.float32)
    y = fn(a=a, b=b, x=x)
    assert torch.equal(y, x + 15 + b)
    assert fn.static["a"].dtype == torch.int32
    assert fn.static["a"].tolist() == a.tolist() and fn.static["b"] == b
    # a device operand left out keeps its value; the outputs are copies
    y2 = fn(a=a * 0, b=1)
    assert torch.equal(y2, x + 1) and torch.equal(y, x + 15 + b)
    assert torch.equal(fn.run_eager(a=a * 0, b=1), y2)
    assert traces == [1] and fn.captures == 1 and fn.capture_s == 0.0


@pytest.mark.parametrize("bad", ["missing staged", "staged shape",
                                 "input shape", "unknown"])
def test_captured_step_refuses_operands_off_its_bucket(bad):
    fn = _step()
    a = np.zeros((2, 3), np.int32)
    kw = {"missing staged": dict(a=a),
          "staged shape": dict(a=np.zeros((3, 2), np.int32), b=0),
          "input shape": dict(a=a, b=0, x=torch.zeros(5)),
          "unknown": dict(a=a, b=0, y=torch.zeros(4))}[bad]
    with pytest.raises((ValueError, TypeError)):
        fn(**kw)


@pytest.mark.parametrize("slots,w", [(2, 1), (3, 5), (8, 1)])
def test_staged_operands_start_16_byte_aligned(slots, w):
    """The paged kernel reads ``valid_cols`` in 16-byte pieces: every
    staged operand of the verify step starts at a 16-byte offset,
    whatever the slot count and window before it."""
    eng = Engine(MODEL, device="cpu", kv_mode="paged", slots=slots, max_len=12,
                 prefill_buckets=(4,), page_size=4, spec_k=w - 1)
    fn = eng._verify_fn()
    base = fn.static["tokens"].data_ptr()
    for k, t in fn.static.items():
        assert (t.data_ptr() - base) % 16 == 0, k
    assert fn.static["valid_cols"].shape == (slots, 12)


def test_captured_step_reports_to_the_sentinel_without_an_owner():
    """A step has one way to report a build, its owner's ``on_trace``: a
    step made without one is refused, and a build reported under a name
    and no signature counts once a bucket, and armed, trips on a
    rebuild."""
    with pytest.raises(TypeError):
        CapturedStep("test.unowned[x]", lambda a: a + 1, "cpu", pool=None,
                     staged=dict(a=(3,)))

    def make():
        return CapturedStep(
            "test.unowned[x]", lambda a: a + 1, "cpu", pool=None,
            on_trace=lambda: get_sentinel().note_trace("test.unowned[x]"),
            staged=dict(a=(3,)))

    fn = make()
    before = get_sentinel().trace_count("test.unowned[x]")
    for _ in range(3):
        fn(a=np.ones(3, np.int32))
    assert get_sentinel().trace_count("test.unowned[x]") == before + 1
    assert get_sentinel().signatures("test.unowned[x]")[-1] is None
    with get_sentinel().armed(), pytest.raises(RecompileError):
        make()(a=np.ones(3, np.int32))


def test_replays_add_the_captured_launches():
    """What a card's replay does to the counts, by hand: the warm-up and
    the capture count nothing, each replay adds the capture's launches."""
    kernels.reset_kernel_launch_counts()
    kernels.count_launch("paged_attention")
    with kernels.launches_uncounted():
        kernels.count_launch("paged_attention")        # warm-up
        warm = kernels.kernel_launch_counts()
        kernels.count_launch("paged_attention")        # capture
        kernels.count_launch("paged_tail_segment")
        after = kernels.kernel_launch_counts()
    delta = {k: after[k] - warm[k] for k in after if after[k] != warm[k]}
    assert kernels.kernel_launch_counts()["paged_attention"] == 1
    for _ in range(3):
        kernels.add_launches(delta)
    counts = kernels.kernel_launch_counts()
    assert counts["paged_attention"] == 4 and counts["paged_tail_segment"] == 3
    kernels.reset_kernel_launch_counts()


def test_buffers_held_by_a_capture_outlive_the_wrappers_cache():
    held = []
    buf = torch.zeros(4)
    assert kernels.hold(buf) is buf                     # no capture: no-op
    with kernels.held_by_capture(held):
        kernels.hold(buf)
    kernels.hold(torch.ones(1))
    assert len(held) == 1 and held[0] is buf
