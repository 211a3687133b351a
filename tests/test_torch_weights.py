"""The port's checkpoint reader and the weight bridge from the JAX package."""

import jax
import numpy as np
import pytest

from lpr_tpu_torch.weights.checkpoint import (is_side_key, load_state,
                                              params_from_jax, read_npz)

from . import torch_ref

CKPTS = {
    "plate": "checkpoints/plate_det640.npz",
    "char": "checkpoints/char_ocr_synth.npz",
    "lpsr": "checkpoints/lpsr_synth_glare/best_model.npz",
}


@pytest.mark.parametrize("name", sorted(CKPTS))
def test_read_npz_round_trips_every_key(name):
    path = CKPTS[name]
    got = read_npz(path)
    with np.load(path) as ref:
        assert sorted(got) == sorted(ref.files)
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
    state, side = load_state(path)
    assert set(state) | set(side) == set(got)
    assert all(v.dtype == np.float32 for v in state.values())
    assert ("__anchors__" in side) == (name == "char")
    assert not any(is_side_key(k) for k in state)


def _jax_params(name):
    """The JAX package's pytree, from lpr_tpu's load_params."""
    if name == "plate":
        return torch_ref.plate()[1]
    if name == "char":
        return torch_ref.char()[1]
    return torch_ref.lpsr()


@pytest.mark.parametrize("name", sorted(CKPTS))
def test_params_from_jax_equals_npz_state(name):
    """The JAX loader's pytree, carried across with params_from_jax, is
    exactly the state the port reads from the npz."""
    got = params_from_jax(jax.device_get(_jax_params(name)))
    state, _ = load_state(CKPTS[name])
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(got[k], v)
