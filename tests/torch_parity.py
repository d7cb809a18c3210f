"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: both run on the CPU, on the same numpy inputs.

``tests/conftest.py`` turns JAX x64 on, so every input is handed to JAX as
float32 explicitly.  The suite runs under several xdist workers, so torch
gets two threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)


def f32(tree):
    """numpy/JAX tree -> JAX float32 arrays (ints and bools kept)."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.kind == "f":
            return jnp.asarray(a, jnp.float32)
        return jnp.asarray(a)
    return jax.tree.map(conv, tree)


def np_tree(tree):
    """JAX tree -> numpy tree (``jax.device_get``)."""
    return jax.device_get(tree)


def tt(a, dtype=None):
    """numpy -> torch (CPU), keeping the dtype unless one is given."""
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def tn(t):
    return t.detach().cpu().numpy()


def assert_close(a, b, atol, rtol=0.0, what=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b)
    lim = atol + rtol * np.abs(b)
    assert np.all(err <= lim), f"{what}: max err {err.max():.3e} (atol {atol}, rtol {rtol})"
