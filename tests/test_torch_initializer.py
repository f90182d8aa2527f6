"""The port's initializers (`nn.initializer`) against paddle_tpu's.

Exactly where an initializer is deterministic: `Constant`, `Assign`,
`Dirac`, `Bilinear`, `calculate_gain`, and the fans every bound derives
from (`_fan_in_out`, 2-D ``[in, out]`` and OIHW). In distribution where
it draws (torch's generator and JAX's key give other numbers from one
seed): the port's draws and the reference's, each of 131072 values, have
the mean and standard deviation the initializer names within 5 sampling
sigmas, lie in its range (XavierUniform's and KaimingUniform's
fan-derived bounds, TruncatedNormal's two standard deviations) and
reach within 2% of a bound's edge; `Orthogonal`'s rows or columns are
orthonormal in both. Draws are float32, then cast: a bfloat16 draw is
the float32 draw of the same generator rounded.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import initializer as jinit
from paddle_tpu_torch.core.random import rng_guard, step_generator
from paddle_tpu_torch.nn import initializer as pinit

import _torch_layers as tl

BIG = (256, 512)                 # 131072 draws
SIGMAS = 5.0


@pytest.fixture(autouse=True)
def _rng_state_kept():
    with tl.rng_state_kept():
        yield


def _port(init, shape, dtype=torch.float32, seed=0):
    with rng_guard(step_generator(seed, "cpu")):
        return init(shape, dtype, "cpu").float().numpy()


def _ref(init, shape):
    return np.asarray(init(shape, jnp.float32), np.float32)


@pytest.mark.parametrize("shape", [(7,), (5, 3), (4, 3, 2), (8, 4, 3, 3),
                                   (2, 6, 3, 3, 3), ()])
def test_fans_match_the_reference(shape):
    assert pinit._fan_in_out(shape) == jinit._fan_in_out(shape)


DETERMINISTIC = {
    "Constant": (lambda m: m.Constant(0.25), (3, 4)),
    "Assign": (lambda m: m.Assign(
        np.arange(12, dtype=np.float32).reshape(3, 4)), (3, 4)),
    "Dirac": (lambda m: m.Dirac(), (4, 4, 3, 3)),
    "Dirac_groups2": (lambda m: m.Dirac(groups=2), (6, 3, 3)),
    "Bilinear": (lambda m: m.Bilinear(), (2, 3, 4, 4)),
    "Bilinear_odd": (lambda m: m.Bilinear(), (1, 1, 5, 3))}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_initializers_equal_the_reference(name):
    make, shape = DETERMINISTIC[name]
    want = _ref(make(jinit), shape)
    got = make(pinit)(shape, "float32", "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    bf = make(pinit)(shape, torch.bfloat16, "cpu")
    np.testing.assert_array_equal(bf.float().numpy(), torch.from_numpy(
        np.array(want)).to(torch.bfloat16).float().numpy())


def test_calculate_gain_and_assign_errors_match_the_reference():
    for name in ("sigmoid", "linear", "conv2d", "tanh", "relu", "selu"):
        assert pinit.calculate_gain(name) == jinit.calculate_gain(name)
    assert pinit.calculate_gain("leaky_relu") == \
        jinit.calculate_gain("leaky_relu")
    assert pinit.calculate_gain("leaky_relu", 0.2) == \
        jinit.calculate_gain("leaky_relu", 0.2)
    for m in (pinit, jinit):
        with pytest.raises(ValueError):
            m.calculate_gain("swish")
    with pytest.raises(ValueError, match="Assign initializer shape"):
        pinit.Assign(np.zeros(3))((4,), "float32", "cpu")
    with pytest.raises(ValueError, match="4-D"):
        pinit.Bilinear()((3, 3), "float32", "cpu")


def _normal_moments(draws, mean, std, what):
    n = draws.size
    assert abs(draws.mean() - mean) <= SIGMAS * std / math.sqrt(n), what
    assert abs(draws.std() - std) <= SIGMAS * std / math.sqrt(2 * n), what


def _uniform_range(draws, limit, what):
    n = draws.size
    assert np.abs(draws).max() <= limit * (1 + 1e-6), what
    assert np.abs(draws).max() >= 0.98 * limit, what
    sd = limit / math.sqrt(3)
    assert abs(draws.mean()) <= SIGMAS * sd / math.sqrt(n), what
    assert abs(draws.std() - sd) <= SIGMAS * 0.45 * sd / math.sqrt(n), what


@pytest.mark.parametrize("shape", [BIG, (32, 64, 8, 8)])
def test_fan_derived_draws_follow_the_reference(shape):
    fi, fo = jinit._fan_in_out(shape)
    xavier = math.sqrt(6.0 / (fi + fo))
    kaiming = math.sqrt(2.0) * math.sqrt(3.0 / fi)
    for draws in (_port(pinit.XavierUniform(), shape),
                  _ref(jinit.XavierUniform(), shape)):
        _uniform_range(draws, xavier, f"XavierUniform {shape}")
    for draws in (_port(pinit.KaimingUniform(), shape),
                  _ref(jinit.KaimingUniform(), shape)):
        _uniform_range(draws, kaiming, f"KaimingUniform {shape}")
    for draws in (_port(pinit.XavierNormal(gain=2.0), shape),
                  _ref(jinit.XavierNormal(gain=2.0), shape)):
        _normal_moments(draws, 0.0, 2.0 * math.sqrt(2.0 / (fi + fo)),
                        f"XavierNormal {shape}")
    for draws in (_port(pinit.KaimingNormal(), shape),
                  _ref(jinit.KaimingNormal(), shape)):
        _normal_moments(draws, 0.0, math.sqrt(2.0 / fi),
                        f"KaimingNormal {shape}")


def test_normal_uniform_and_truncated_draws_follow_the_reference():
    for draws in (_port(pinit.Normal(0.5, 2.0), BIG),
                  _ref(jinit.Normal(0.5, 2.0), BIG)):
        _normal_moments(draws, 0.5, 2.0, "Normal")
    for draws in (_port(pinit.Uniform(-0.5, 1.5), BIG),
                  _ref(jinit.Uniform(-0.5, 1.5), BIG)):
        assert draws.min() >= -0.5 and draws.max() < 1.5
        _uniform_range(draws - 0.5, 1.0, "Uniform")
    # a normal truncated at 2 sigma: std 0.87962566 of the untruncated
    trunc_sd = 0.87962566103423978
    for draws in (_port(pinit.TruncatedNormal(1.0, 3.0), BIG),
                  _ref(jinit.TruncatedNormal(1.0, 3.0), BIG)):
        assert draws.min() >= 1.0 - 6.0 and draws.max() <= 1.0 + 6.0
        assert draws.min() <= 1.0 - 5.9 and draws.max() >= 1.0 + 5.9
        _normal_moments(draws, 1.0, 3.0 * trunc_sd, "TruncatedNormal")


@pytest.mark.parametrize("shape", [(64, 64), (32, 96), (96, 32),
                                   (4, 8, 24)])
def test_orthogonal_is_orthonormal_like_the_reference(shape):
    for q in (_port(pinit.Orthogonal(gain=1.5), shape),
              _ref(jinit.Orthogonal(gain=1.5), shape)):
        w = q.reshape(-1, shape[-1]) / 1.5
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(gram, np.eye(len(gram)), atol=2e-5)


def test_a_draw_is_float32_then_cast():
    for init in (pinit.XavierNormal(), pinit.TruncatedNormal(),
                 pinit.Uniform()):
        f32 = _port(init, (64, 32), seed=3)
        bf16 = _port(init, (64, 32), torch.bfloat16, seed=3)
        np.testing.assert_array_equal(bf16, torch.from_numpy(f32).to(
            torch.bfloat16).float().numpy())
