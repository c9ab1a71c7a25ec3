"""The port's losses (`rga3_tpu_torch.ops.losses`) against the JAX package's
on the same seeded inputs, f32, within 1e-6 (relative to the loss)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rga3_tpu.ops import losses as jl
from rga3_tpu_torch.ops import losses as tl

TOL = 1e-6


def _close(t, j):
    t, j = float(t), float(j)
    assert abs(t - j) <= TOL * max(1.0, abs(j)), (t, j)


def _masks(seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((5, 24, 20))).astype(np.float32)
    targets = (rng.random((5, 24, 20)) > 0.6).astype(np.float32)
    valid = np.array([1, 0, 1, 1, 0], np.float32)
    return logits, targets, valid


@pytest.mark.parametrize("name", ["dice_loss", "sigmoid_ce_loss"])
def test_mask_losses_match_jax(name):
    x, t, _ = _masks(0)
    _close(getattr(tl, name)(torch.from_numpy(x), torch.from_numpy(t), 3.0),
           getattr(jl, name)(jnp.asarray(x), jnp.asarray(t), 3.0))


@pytest.mark.parametrize("name", ["masked_dice_loss", "masked_sigmoid_ce_loss"])
@pytest.mark.parametrize("all_invalid", [False, True], ids=["some_valid", "none_valid"])
def test_masked_mask_losses_match_jax(name, all_invalid):
    x, t, v = _masks(1)
    if all_invalid:
        v = np.zeros_like(v)
    _close(getattr(tl, name)(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(v)),
           getattr(jl, name)(jnp.asarray(x), jnp.asarray(t), jnp.asarray(v)))


def test_dice_scale_matches_jax():
    x, t, v = _masks(2)
    _close(tl.masked_dice_loss(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(v),
                               scale=10.0),
           jl.masked_dice_loss(jnp.asarray(x), jnp.asarray(t), jnp.asarray(v), scale=10.0))


@pytest.mark.parametrize("masked", ["some", "all"])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (4 * rng.standard_normal((2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int64)
    if masked == "all":
        labels[:] = -100
    else:
        labels[0, :4] = -100
        labels[1, 7] = -100
    _close(tl.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)),
           jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))


def test_losses_take_bf16_inputs_in_f32():
    x, t, v = _masks(4)
    xb = torch.from_numpy(x).bfloat16()
    out = tl.masked_sigmoid_ce_loss(xb, torch.from_numpy(t), torch.from_numpy(v))
    assert out.dtype == torch.float32
    _close(out, jl.masked_sigmoid_ce_loss(jnp.asarray(xb.float().numpy()), jnp.asarray(t),
                                          jnp.asarray(v)))
