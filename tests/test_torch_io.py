"""`paddle_tpu_torch.framework.io` against paddle_tpu's ``save``/``load``:
each package reads the other's files.

Inputs come from a numpy seed. Values cross exactly (float32, bfloat16,
int64 and bool, in nested dicts, lists and tuples), with the Parameter
flag and ``stop_gradient``; ``return_numpy`` gives arrays in both. A
gpt-test ``state_dict`` written by ``paddle_tpu.save`` and read by the
port gives the reference's logits within float32 atol 1e-4 (the GPT
parity tests' bound).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.framework import io as jio
from paddle_tpu_torch.framework import io as tio

ATOL = 1e-4
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "int64": (np.int64, torch.int64),
          "bool": (np.bool_, torch.bool)}


def _array(dtype, shape=(3, 5), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int64":
        return rng.integers(-1000, 1000, shape).astype(np.int64)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    return rng.standard_normal(shape).astype(np.float32).astype(
        DTYPES[dtype][0])


def _torch(a, dtype):
    if dtype == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t):
    """A tensor's values as numpy, bfloat16 widened exactly."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jbits(x):
    a = np.asarray(x._value if hasattr(x, "_value") else x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reference_file_loads_in_the_port(tmp_path, dtype):
    a = _array(dtype)
    path = str(tmp_path / "ref.pdparams")
    jio.save({"p": JParameter(jnp.asarray(a)),
              "t": JTensor(jnp.asarray(a), stop_gradient=False),
              "frozen": JTensor(jnp.asarray(a))}, path)
    got = tio.load(path)
    for k in ("p", "t", "frozen"):
        assert got[k].dtype == DTYPES[dtype][1]
        np.testing.assert_array_equal(_bits(got[k]), _jbits(a))
    assert isinstance(got["p"], torch.nn.Parameter)
    assert not isinstance(got["t"], torch.nn.Parameter)
    floating = dtype in ("float32", "bfloat16")
    assert got["t"].requires_grad == floating
    assert not got["frozen"].requires_grad
    arrays = tio.load(path, return_numpy=True)
    assert all(isinstance(v, np.ndarray) for v in arrays.values())
    np.testing.assert_array_equal(arrays["p"], _jbits(a))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_file_loads_in_the_reference(tmp_path, dtype):
    a = _array(dtype, seed=1)
    t = _torch(a, dtype)
    path = str(tmp_path / "port.pdparams")
    param = torch.nn.Parameter(t.clone(), requires_grad=t.is_floating_point())
    tio.save({"p": param, "t": t}, path)
    got = jio.load(path)
    assert isinstance(got["p"], JParameter)
    assert not isinstance(got["t"], JParameter)
    assert got["t"].stop_gradient
    for k in ("p", "t"):
        assert np.asarray(got[k]._value).dtype == np.dtype(DTYPES[dtype][0])
        np.testing.assert_array_equal(_jbits(got[k]), _bits(t))
    arrays = jio.load(path, return_numpy=True)
    np.testing.assert_array_equal(_jbits(arrays["t"]), _bits(t))


def test_nested_containers_both_ways(tmp_path):
    """dict, list and tuple nest as they were; non-tensor leaves pass
    through; numpy arrays stay arrays."""
    a, b = _array("float32", (2, 3), 2), _array("bfloat16", (4,), 3)
    ref_obj = {"layer": [JTensor(jnp.asarray(a)),
                         (JParameter(jnp.asarray(b)), 7, "x")],
               "meta": {"epoch": 3, "raw": np.arange(4)}}
    ref_path = str(tmp_path / "ref.pd")
    jio.save(ref_obj, ref_path)
    got = tio.load(ref_path)
    assert isinstance(got["layer"], list) and isinstance(got["layer"][1],
                                                         tuple)
    assert got["layer"][1][1:] == (7, "x")
    assert isinstance(got["layer"][1][0], torch.nn.Parameter)
    np.testing.assert_array_equal(_bits(got["layer"][0]), a)
    np.testing.assert_array_equal(_bits(got["layer"][1][0]), _jbits(b))
    assert got["meta"]["epoch"] == 3
    np.testing.assert_array_equal(got["meta"]["raw"], np.arange(4))

    port_obj = {"layer": [_torch(a, "float32"),
                          (torch.nn.Parameter(_torch(b, "bfloat16")), 7,
                           "x")],
                "meta": {"epoch": 3, "raw": np.arange(4)}}
    port_path = str(tmp_path / "port.pd")
    tio.save(port_obj, port_path)
    back = jio.load(port_path)
    assert isinstance(back["layer"], list) and isinstance(back["layer"][1],
                                                          tuple)
    assert isinstance(back["layer"][1][0], JParameter)
    np.testing.assert_array_equal(_jbits(back["layer"][0]), a)
    np.testing.assert_array_equal(_jbits(back["layer"][1][0]), _jbits(b))
    assert back["meta"]["epoch"] == 3
    again = tio.load(port_path, return_numpy=True)
    assert again["layer"][1][0].dtype == np.float32
    np.testing.assert_array_equal(again["layer"][1][0], _jbits(b))


@pytest.mark.parametrize("protocol", [2, 3, 5])
def test_other_pickle_protocols(tmp_path, protocol):
    """The payload and ml_dtypes names are written by hand at every
    protocol; numpy's protocol-5 arrays load in the port."""
    b = _array("bfloat16", seed=4)
    t = _torch(b, "bfloat16")
    path = str(tmp_path / "p.pd")
    tio.save({"b": t}, path, protocol=protocol)
    np.testing.assert_array_equal(_jbits(jio.load(path)["b"]), _bits(t))
    assert torch.equal(tio.load(path)["b"], t)
    jio.save({"b": JTensor(jnp.asarray(b))}, path, protocol=protocol)
    np.testing.assert_array_equal(_bits(tio.load(path)["b"]), _jbits(b))


def test_load_places_tensors_on_the_device_asked(tmp_path):
    path = str(tmp_path / "d.pd")
    tio.save({"w": torch.ones(2)}, path)
    assert tio.load(path)["w"].device.type == "cpu"
    assert tio.load(path, device="meta")["w"].device.type == "meta"


def test_gpt_state_dict_saved_by_the_reference_gives_its_logits(tmp_path):
    """gpt-test's ``state_dict`` through ``paddle_tpu.save``, read by the
    port and loaded with `load_paddle_tpu_state_dict`: the port's logits
    are the reference's within float32 atol 1e-4."""
    from paddle_tpu.models.gpt import GPTForPretraining as JGPT
    from paddle_tpu.models.gpt import GPTModel as JGPTModel
    from paddle_tpu.models.gpt import gpt_config as jgpt_config
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         load_paddle_tpu_state_dict)

    paddle.seed(31)
    jmodel = JGPT(JGPTModel(jgpt_config("gpt-test")))
    jmodel.eval()
    path = str(tmp_path / "gpt.pdparams")
    paddle.save(jmodel.state_dict(), path)
    arrays = tio.load(path, return_numpy=True)
    model = load_paddle_tpu_state_dict(
        GPTForPretraining("gpt-test", device="cpu"), arrays)
    model.eval()
    ids = np.random.default_rng(6).integers(0, 256, (2, 16))
    want = np.asarray(jmodel(paddle.to_tensor(ids))._value)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # and the port's own file of the same weights reads back in the
    # reference, key for key
    port_path = str(tmp_path / "port_gpt.pdparams")
    tio.save(dict(model.named_parameters()), port_path)
    back = jio.load(port_path, return_numpy=True)
    for k, v in model.named_parameters():
        np.testing.assert_array_equal(back[k], v.detach().numpy())
