"""Helpers for the port's trainer tests: a flat state (the port's key
layout) placed into the JAX package's parameter pytree without running its
``init`` (under jit, ``lpsr_init`` alone compiles for ~7 s on the CPU;
eagerly it dispatches op by op), and the fixture that keeps PyTorch on one
thread."""

import jax
import numpy as np
import pytest
import torch


def key_of(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def shapes(init, *args):
    """The pytree of ShapeDtypeStructs that ``init(key, *args)`` builds."""
    return jax.eval_shape(lambda k: init(k, *args), jax.random.PRNGKey(0))


def jax_tree(init, flat, *args):
    """``flat`` ({key path: array}) in the structure of ``init(key,
    *args)``; every key of the structure must be in ``flat`` with its
    shape."""
    def leaf(path, s):
        v = np.asarray(flat[key_of(path)], s.dtype)
        assert v.shape == s.shape, (key_of(path), v.shape, s.shape)
        return v

    return jax.tree_util.tree_map_with_path(leaf, shapes(init, *args))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread in the module that imports this
    fixture: the suite runs several test processes at once, and there
    PyTorch's thread pool, waiting for busy cores, made the trainer tests
    up to 25x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
