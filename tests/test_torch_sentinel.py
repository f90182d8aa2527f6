"""The port's recompile sentinel against paddle_tpu's.

Both sentinels, each on a registry of its own, get the same sequence of
`note_trace` calls (names with and without signatures, repeats of one
signature, a new one); their `counts`, `signatures`, `trace_count` and
the ``xla_traces_total`` counter family they bump must agree, armed and
not. Armed, a second build of one name under a new signature (or none)
raises `RecompileError` in both, a repeat of a recorded signature does
not, and `reset` clears what was recorded. `traced` counts each call of
the wrapped function, with the shape signature of its arguments.
"""
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu.observability.registry import MetricsRegistry as JaxRegistry
from paddle_tpu.observability.sentinel import RecompileError as JaxError
from paddle_tpu.observability.sentinel import RecompileSentinel as JaxSentinel
from paddle_tpu_torch.observability import (MetricsRegistry, RecompileError,
                                            RecompileSentinel, get_sentinel)
from paddle_tpu_torch.observability.sentinel import _signature

#: (name, signature) sequences both sentinels take unarmed
SEQUENCES = {
    "one build each": [("a", "s1"), ("b", None), ("c", "x")],
    "repeat of a recorded signature": [("a", "s1"), ("a", "s1"),
                                       ("a", "s1")],
    "new signature": [("a", "s1"), ("a", "s2"), ("b", None)],
    "no signature twice": [("d", None), ("d", None)],
    "mixed": [("a", "s1"), ("b", None), ("a", "s1"), ("c", "x"),
              ("c", "y"), ("d", None), ("a", "s3")],
}


def _pair():
    return (JaxSentinel(JaxRegistry()), RecompileSentinel(MetricsRegistry()))


def _family(sentinel):
    series = sentinel._registry.get("xla_traces_total").collect()
    return sorted((labels["executable"], value) for labels, value in series)


@pytest.mark.parametrize("seq", list(SEQUENCES), ids=list(SEQUENCES))
def test_note_trace_sequence_matches_reference(seq):
    ref, port = _pair()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, sig in SEQUENCES[seq]:
            ref.note_trace(name, sig)
            port.note_trace(name, sig)
    assert port.counts() == ref.counts()
    for name in ref.counts():
        assert port.trace_count(name) == ref.trace_count(name)
        assert port.signatures(name) == ref.signatures(name)
    assert _family(port) == _family(ref)


@pytest.mark.parametrize("second,raises", [("s2", True), (None, True),
                                           ("s1", False)],
                         ids=["new signature", "no signature",
                              "recorded signature"])
def test_armed_second_build_raises_as_the_reference(second, raises):
    ref, port = _pair()
    for s, err in ((ref, JaxError), (port, RecompileError)):
        s.note_trace("step", "s1")
        with s.armed():
            assert s.is_armed
            if raises:
                with pytest.raises(err, match="step"):
                    s.note_trace("step", second)
            else:
                s.note_trace("step", second)
        assert not s.is_armed
    assert port.counts() == ref.counts() == {"step": 2}


def test_reset_clears_and_arming_nests():
    ref, port = _pair()
    for s, err in ((ref, JaxError), (port, RecompileError)):
        s.note_trace("step", "s1")
        s.reset()
        assert s.counts() == {} and s.trace_count("step") == 0
        s.arm()
        s.arm()
        s.disarm()
        assert s.is_armed
        s.note_trace("step", "s1")           # the first build after reset
        with pytest.raises(err):
            s.note_trace("step", "s2")
        s.disarm()
        s.disarm()                           # never below zero
        assert not s.is_armed


def test_traced_counts_calls_with_their_shape_signature():
    port = RecompileSentinel(MetricsRegistry())
    fn = port.traced("f", lambda x, scale=1.0: x * scale)
    x = torch.zeros((2, 3))
    assert torch.equal(fn(x, scale=2.0), x)
    fn(x, scale=2.0)
    assert port.trace_count("f") == 2
    sigs = port.signatures("f")
    assert sigs[0] == sigs[1] == _signature((x,), {"scale": 2.0})
    assert "float32[2,3]" in sigs[0]
    with port.armed():
        fn(x, scale=2.0)                     # a recorded signature
        with pytest.raises(RecompileError):
            fn(torch.zeros((4, 3)), scale=2.0)


def test_signature_flattens_nested_containers():
    a = torch.zeros((2,), dtype=torch.int32)
    b = np.zeros((3, 1), np.float32)
    sig = _signature(([a, (b, 1)],), {"k": {"v": a}})
    assert sig.endswith("(int32[2], float32[3,1], int, int32[2])")
    assert sig != _signature(([a, (b, 1)],), {"k": {"w": a}})
    assert _signature((a,), {}) != _signature(((a,),), {})


def test_default_sentinel_is_process_wide():
    assert get_sentinel() is get_sentinel()
    assert isinstance(get_sentinel(), RecompileSentinel)
