"""Shared by the port's serving tests: paddle_tpu's ``gpt-test`` and the
port's on the same numpy-seeded weights, prompt rows, and the check that
an engine's pool is whole again after its traffic."""
import numpy as np

from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.models.gpt import gpt_config as jax_gpt_config
from paddle_tpu_torch.models import GPTForPretraining, load_paddle_tpu_state_dict

#: the std of the seeded matrices: wide enough that greedy streams do not
#: repeat one token (the init's 0.02 makes every stream one token)
WEIGHT_STD = 0.3


def seeded_arrays(model, seed):
    """``model``'s state dict with numpy-seeded values: matrices normal
    ``(0, WEIGHT_STD)``, LayerNorm scales and biases perturbed around
    their init."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in model.state_dict().items():
        a = np.asarray(v._value)
        if a.ndim == 2:
            a = (rng.standard_normal(a.shape) * WEIGHT_STD).astype(a.dtype)
        elif a.ndim == 1 and a.dtype == np.float32:
            a = (a + rng.standard_normal(a.shape) * 0.05).astype(a.dtype)
        arrays[k] = a
    return arrays


def both_models(seed):
    """(paddle_tpu model, port model) of ``gpt-test`` in float32 on the
    same seeded weights."""
    jm = JaxGPT(JaxGPTModel(jax_gpt_config("gpt-test")))
    jm.eval()
    arrays = seeded_arrays(jm, seed)
    jm.set_state_dict(arrays)
    return jm, load_paddle_tpu_state_dict(
        GPTForPretraining("gpt-test", device="cpu"), arrays)


def rows(seed, lens):
    """Prompts of ``lens`` tokens in ``[1, 255)`` from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, (n,)).astype("int64") for n in lens]


def assert_pool_whole(eng):
    """After an engine's traffic: no slot maps a page, the only pages in
    use are the prefix tree's (one reference each), and once the tree
    drops them (`evict_to(0)`) every page is free and no reference is
    left. Ends the engine's cache."""
    kv = eng.kv
    assert kv.slot_page_counts() == (0,) * eng.slots
    cached = eng.prefix.cached_pages if eng.prefix is not None else 0
    assert kv.pages_in_use == cached
    assert all(n == 1 for n in kv.pool._refcount.values())
    if eng.prefix is not None:
        assert eng.prefix.evict_to(0) == cached
        assert eng.prefix.cached_pages == 0
    assert kv.pages_in_use == 0 and kv.pages_free == kv.pages_total
    assert kv.pool._refcount == {}
    assert (kv.block_table == kv.pool.sentinel).all()
