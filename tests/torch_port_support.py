"""Shared helpers for the PyTorch-port parity tests: one seeded numpy
parameter tree fed to both packages.

`jax_param_tree` takes the JAX module's parameter shapes from
`jax.eval_shape` (no real init, which is slow on the CPU) and fills them
from a numpy generator, so the same arrays go to the JAX module and, through
`rga3_tpu_torch.convert`, to the port.
"""
from __future__ import annotations

import flax
import jax
import numpy as np


def jax_param_tree(module, *init_args, seed: int = 0, std: float = 0.1,
                   **init_kwargs):
    """Seeded numpy params with the JAX module's tree: norm scales near 1,
    everything else normal(0, std)."""
    shapes = jax.eval_shape(
        module.init, jax.random.PRNGKey(0), *init_args, **init_kwargs
    )
    rng = np.random.default_rng(seed)

    def fill(node):
        out = {}
        for name in sorted(node):
            leaf = node[name]
            if hasattr(leaf, "shape") and not isinstance(leaf, dict):
                if name == "scale" or (name == "weight" and len(leaf.shape) == 1):
                    x = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
                else:
                    x = std * rng.standard_normal(leaf.shape)
                out[name] = x.astype(np.float32)
            else:
                out[name] = fill(leaf)
        return out

    return fill(flax.core.unfreeze(flax.core.meta.unbox(shapes)))


def to_nested_numpy(tree):
    """A params pytree (dicts of arrays) as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)
