"""The port's dtypes, places and random state (A2, the rest of
``core/random.py``) against paddle_tpu's.

- dtypes: the reference's table, name for name, as torch dtypes; the
  module constants; `convert_dtype`, `dtype_name`, the predicates and
  `promote_types` answer as the reference's for every name and every
  pair of names; ``device.DTYPES`` takes float16, and so does
  `Layer.to(dtype=)`;
- places: `CPUPlace`, `CUDAPlace(i)` (a CUDA device), `CUDAPinnedPlace`,
  `set_device` / `get_device` / `expected_place`, ``is_compiled_with_*``
  and `device_count`; `TPUPlace` and `NPUPlace` raise naming the GPU.
  ``set_device("cpu")`` is the caller asking for the CPU: an entry given
  no device then builds there. Every test that sets a device puts the
  process's setting back;
- random: ``seed(s)`` makes the draws repeat, `get_rng_state` /
  `set_rng_state` (and the CUDA aliases) put them back, a `Generator`
  reseeds and reports its seed, in both packages; the port's draws come
  from its per-device generators, never from torch's global one.
"""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.core import dtype as jdtype
from paddle_tpu.core import place as jplace
from paddle_tpu.core import random as jrandom
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core import dtype as pdtype
from paddle_tpu_torch.core import place as pplace
from paddle_tpu_torch.core import random as prandom

import _torch_layers as tl

NAMES = list(jdtype._NAME_TO_DTYPE)


@pytest.fixture
def place_kept():
    """Both packages' expected places put back after the test."""
    saved = pdevice.expected_device(), jplace._expected_place
    try:
        yield
    finally:
        pdevice.set_expected_device(saved[0])
        jplace._expected_place = saved[1]


@pytest.fixture
def rng_kept():
    seed = prandom.default_generator().initial_seed
    jseed = jrandom.default_generator().initial_seed
    with tl.rng_state_kept():
        try:
            yield
        finally:
            prandom._DEFAULT._seed = seed
            jrandom._default._seed = jseed


def test_the_table_and_the_constants_are_the_references():
    assert list(pdtype._NAME_TO_DTYPE) == NAMES
    for name in NAMES:
        const = "bool_" if name == "bool" else name
        assert getattr(pdtype, const) is pdtype._NAME_TO_DTYPE[name]
        assert pdtype.dtype_name(getattr(pdtype, const)) == \
            jdtype.dtype_name(getattr(jdtype, const)) == name
    assert pt.float16 is torch.float16 and pt.bool is torch.bool
    assert pt.dtype is torch.dtype


@pytest.mark.parametrize("name", NAMES)
def test_convert_and_the_predicates(name):
    want = jdtype.convert_dtype(name)
    got = pdtype.convert_dtype(name)
    assert isinstance(got, torch.dtype)
    assert pdtype.dtype_name(got) == want.name
    assert pdtype.convert_dtype(got) is got
    assert pdtype.convert_dtype(want) is got        # a numpy dtype
    for pred in ("is_floating_point", "is_integer", "is_complex"):
        assert getattr(pdtype, pred)(name) == getattr(jdtype, pred)(name), \
            pred


def test_convert_refuses_an_unknown_name_as_the_reference():
    for mod in (pdtype, jdtype):
        with pytest.raises(TypeError, match="Unsupported dtype"):
            mod.convert_dtype("float17")
        assert mod.convert_dtype(None) is None


def test_promote_types_for_every_pair():
    """The same dtype for every pair; where the reference refuses (a
    float8 beside another float), the port refuses too."""
    refused = 0
    for a, b in itertools.product(NAMES, NAMES):
        try:
            want = np.dtype(jdtype.promote_types(
                jdtype.convert_dtype(a), jdtype.convert_dtype(b))).name
        except ValueError as e:          # jax's TypePromotionError
            assert "promotion" in str(e)
            refused += 1
            with pytest.raises(RuntimeError):
                pdtype.promote_types(a, b)
            continue
        assert pdtype.dtype_name(pdtype.promote_types(a, b)) == want, (a, b)
    assert refused == 12


def test_float16_in_the_dtype_map():
    assert pdevice.resolve_dtype("float16") is torch.float16
    assert "float16" in pdevice.DTYPES
    # B3 reads float16 pages (ROADMAP A2 closed)
    assert pdevice.resolve_dtype("float16",
                                 pdevice.PAGE_DTYPES) is torch.float16
    lin = pnn.Linear(4, 3, device="cpu").to(dtype="float16")
    assert all(p.dtype == torch.float16 for p in lin.parameters())
    assert pt.resolve_dtype(torch.float16) is torch.float16


def test_places_against_the_reference():
    cpu, jcpu = pplace.CPUPlace(), jplace.CPUPlace()
    assert (cpu.platform, cpu.id, repr(cpu)) == (jcpu.platform, jcpu.id,
                                                 repr(jcpu))
    assert cpu.is_cpu_place() and not cpu.is_gpu_place()
    assert not cpu.is_tpu_place() and jcpu.is_cpu_place()
    gpu = pplace.CUDAPlace(1)
    assert gpu.device == torch.device("cuda", 1) and gpu.is_gpu_place()
    assert (gpu.platform, gpu.id, repr(gpu)) == ("gpu", 1, "Place(gpu:1)")
    assert gpu == pplace.CUDAPlace(1) and gpu != pplace.CUDAPlace(0)
    assert len({gpu, pplace.CUDAPlace(1), cpu}) == 2
    pinned = pplace.CUDAPinnedPlace()
    assert pinned.is_cpu_place() and isinstance(pinned, pplace.CPUPlace)
    for cls in (pplace.TPUPlace, pplace.NPUPlace):
        with pytest.raises(RuntimeError, match="NVIDIA GPUs"):
            cls()
    assert pt.is_compiled_with_cuda() and not pt.is_compiled_with_tpu()
    assert not jplace.is_compiled_with_cuda()
    assert pt.device_count() == torch.cuda.device_count()
    assert pt.Place is pplace.Place


def test_set_device_cpu_is_the_caller_asking_for_the_cpu(place_kept):
    for mod in (pt, jplace):
        place = mod.set_device("cpu")
        assert place.is_cpu_place()
        assert mod.get_device() == "cpu:0"
    assert pplace.expected_place() == pplace.CPUPlace()
    assert pdevice.resolve_device(None) == torch.device("cpu")
    lin = pnn.Linear(2, 3)                          # no device given
    assert lin.weight.device.type == "cpu"
    place = pt.set_device("gpu:1")
    assert place == pplace.CUDAPlace(1) and pt.get_device() == "gpu:1"
    assert pdevice.resolve_device(None) == torch.device("cuda", 1)
    assert pt.set_device("cuda:0") == pplace.CUDAPlace(0)
    for bad, err in (("tpu", RuntimeError), ("xpu:0", ValueError)):
        with pytest.raises(err):
            pt.set_device(bad)


def test_without_a_setting_and_a_gpu_the_rule_stays(place_kept,
                                                    monkeypatch):
    pdevice.set_expected_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.get_device()


def _port_draw():
    return torch.rand(4, generator=prandom.current_generator("cpu"))


def _ref_draw():
    import jax
    return np.asarray(jax.random.uniform(jrandom.next_key(), (4,)))


@pytest.mark.parametrize("draw,mod", [(_port_draw, pt),
                                      (_ref_draw, paddle_tpu)])
def test_seed_and_rng_state_bring_the_draws_back(rng_kept, draw, mod):
    mod.seed(123)
    a = draw()
    state = mod.get_rng_state()
    b = draw()
    mod.set_rng_state(state)
    np.testing.assert_array_equal(np.asarray(draw()), np.asarray(b))
    mod.seed(123)
    np.testing.assert_array_equal(np.asarray(draw()), np.asarray(a))
    assert mod.get_cuda_rng_state is mod.get_rng_state
    assert mod.set_cuda_rng_state is mod.set_rng_state


def test_generator_and_the_default(rng_kept):
    for mod in (prandom, jrandom):
        g = mod.Generator(5)
        assert g.initial_seed == 5
        assert g.manual_seed(9) is g and g.initial_seed == 9
        assert mod.seed(77) is mod.default_generator()
        assert mod.default_generator().initial_seed == 77
    g = prandom.Generator(5)
    x = torch.rand(3, generator=g.device_generator("cpu"))
    g.manual_seed(5)
    assert torch.equal(torch.rand(3, generator=g.device_generator("cpu")), x)
    state = g.get_state()
    y = torch.rand(3, generator=g.device_generator("cpu"))
    g.set_state(state)
    assert torch.equal(torch.rand(3, generator=g.device_generator("cpu")), y)


def test_draws_never_touch_torchs_global_generator(rng_kept):
    before = torch.random.get_rng_state()
    pt.seed(3)
    pnn.functional.dropout(torch.ones(64), 0.5, training=True)
    assert torch.equal(torch.random.get_rng_state(), before)
    assert "cpu" in pt.get_rng_state()


def test_deviation_a_0d_float32_tensor_beside_float16():
    """Promotion agrees for tensors with dimensions; beside a 0-d
    float32 tensor torch keeps float16 (a 0-d tensor does not raise a
    dimensioned operand's category), jnp promotes to float32."""
    import jax.numpy as jnp

    half, one = np.ones(3, np.float16), np.float32(1.0)
    assert (jnp.asarray(half) + jnp.asarray(one)).dtype == jnp.float32
    assert (torch.from_numpy(half) + torch.tensor(one)).dtype == \
        torch.float16
    assert (jnp.asarray(half) + jnp.ones(3, jnp.float32)).dtype == \
        jnp.float32
    assert (torch.from_numpy(half) + torch.ones(3)).dtype == torch.float32
    assert pdtype.promote_types("float16", "float32") is torch.float32
