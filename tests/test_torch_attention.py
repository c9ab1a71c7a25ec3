"""The port's attention (rga3_tpu_torch.ops.attention) against the JAX
package's: the plain PyTorch versions against `flash_attention` /
`window_attention` in Pallas interpret mode and against `mha_reference`, on
the same seeded numpy inputs, f32 on the CPU. The CUDA kernels themselves
run only on the card (marker `cuda`).

Tolerance 1e-5 absolute on unit-scale inputs: one attention call in f32
with a different summation order (JAX runs at "highest" matmul precision).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rga3_tpu.ops import attention as jatt
from rga3_tpu_torch.ops import attention as tatt

ATOL = 1e-5


def _qkv(rng, b, lq, lk, h, hkv, d):
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# (b, l, h, hkv, d): GQA rep 1, 2 and 7; head dims 16/72/80/128; lengths
# that are not multiples of the kernels' 64-row tile
FLASH_CASES = [
    (1, 100, 2, 2, 16),
    (2, 130, 4, 2, 72),
    (1, 77, 7, 1, 80),
    (1, 200, 4, 2, 128),
]


@pytest.mark.parametrize("b,l,h,hkv,d", FLASH_CASES)
def test_flash_plain_matches_jax_causal_segments(b, l, h, hkv, d):
    rng = np.random.default_rng(l + d)
    q, k, v = _qkv(rng, b, l, l, h, hkv, d)
    seg = np.sort(rng.integers(0, 3, (b, l)), axis=1).astype(np.int32)
    out = tatt.flash_attention(*_t(q, k, v), causal=True,
                               segment_ids=torch.from_numpy(seg)).numpy()
    ref = np.asarray(jatt.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        segment_ids=jnp.asarray(seg)))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    kern = np.asarray(jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        segment_ids=jnp.asarray(seg), interpret=True))
    # causal + sorted segments: every row sees at least itself
    np.testing.assert_allclose(out, kern, atol=ATOL, rtol=0)


@pytest.mark.parametrize("lq,lk,d", [(150, 9, 16), (70, 33, 72)])
def test_flash_plain_matches_jax_cross_attention(lq, lk, d):
    rng = np.random.default_rng(lq)
    q, k, v = _qkv(rng, 2, lq, lk, 4, 4, d)
    out = tatt.flash_attention(*_t(q, k, v)).numpy()
    kern = np.asarray(jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    np.testing.assert_allclose(out, kern, atol=ATOL, rtol=0)


def test_flash_plain_rows_without_valid_keys_follow_mha_reference():
    """A q segment absent from kv: the plain version gives mean(V), as
    `mha_reference` does; rows with a valid key match the Pallas kernel."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 96, 96, 2, 2, 16)
    qs = np.zeros((1, 96), np.int32)
    qs[0, 80:] = 7
    ks = np.zeros((1, 96), np.int32)
    args = (*_t(q, k, v),)
    out = tatt.flash_attention(*args, segment_ids=torch.from_numpy(qs),
                               kv_segment_ids=torch.from_numpy(ks)).numpy()
    ref = np.asarray(jatt.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=jnp.asarray(qs), kv_segment_ids=jnp.asarray(ks)))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[0, 80:], np.broadcast_to(
        v.mean(axis=1), (16, 2, 16)), atol=ATOL)
    kern = np.asarray(jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=jnp.asarray(qs), kv_segment_ids=jnp.asarray(ks),
        interpret=True))
    np.testing.assert_allclose(out[0, :80], kern[0, :80], atol=ATOL, rtol=0)


@pytest.mark.parametrize("lq,lk", [(64, 200), (100, 448)])
def test_flash_plain_matches_jax_head_dim_256_key_validity(lq, lk):
    """The memory attention's call: one head at D = 256, q segment ids all
    1, kv segment ids the keys' validity (whole runs of invalid keys, as
    the bank's empty frames, and single invalid pointer tokens)."""
    rng = np.random.default_rng(lq + lk)
    q, k, v = _qkv(rng, 2, lq, lk, 1, 1, 256)
    qs = np.ones((2, lq), np.int32)
    ks = np.ones((2, lk), np.int32)
    ks[0, lk // 4:lk // 2] = 0
    ks[1, :lk // 2] = 0
    ks[1, -5:-2] = 0
    out = tatt.flash_attention(*_t(q, k, v), segment_ids=torch.from_numpy(qs),
                               kv_segment_ids=torch.from_numpy(ks), scale=1 / 16).numpy()
    kern = np.asarray(jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segment_ids=jnp.asarray(qs),
        kv_segment_ids=jnp.asarray(ks), scale=1 / 16, interpret=True))
    np.testing.assert_allclose(out, kern, atol=ATOL, rtol=0)


def test_flash_causal_requires_equal_lengths():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 9, 2, 16)
    with pytest.raises(NotImplementedError):
        tatt.flash_attention(q, k, k, causal=True)


@pytest.mark.parametrize("window,l,h,d", [
    (16, 256, 4, 72), (64, 512, 2, 72), (256, 512, 2, 72), (64, 128, 3, 16),
])
def test_window_plain_matches_jax(window, l, h, d):
    rng = np.random.default_rng(window + l)
    q, k, v = _qkv(rng, 2, l, l, h, h, d)
    scale = d ** -0.5
    out = tatt.window_attention(*_t(q, k, v), window).numpy()
    kern = np.asarray(jatt.window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window,
        interpret=True))
    np.testing.assert_allclose(out, kern, atol=ATOL, rtol=0)
    ref = np.asarray(jatt.window_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window, scale))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
