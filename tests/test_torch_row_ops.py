"""The statistics of the bf16 LayerNorm kernel (`csrc/row_ops.cu`), modelled
in numpy on the CPU: the kernel's order of f32 sums gives JAX's
`_layernorm` (`rga3_tpu/ops/fused_block.py:99`) and the port's plain
version to within one bf16 ulp, and a one-pass E[x^2] - E[x]^2 would not.

The model follows the kernel step by step, each step rounded to f32: a row
of D bf16 values is D / 8 chunks of 8; a group of G lanes holds it, lane l
the chunks l, l + G, ... (G and the chunks a lane from
`fused_block.layer_norm_tiling`, the kernel's own choice); each lane adds
its chunks' sums in chunk order, a chunk's 8 values as the tree
((x0+x1)+(x2+x3))+((x4+x5)+(x6+x7)); the group joins its lanes with an xor
butterfly (offsets G/2 .. 1); mean = sum / D. The squared deviations,
each product rounded, go the same way; y = ((x - mean) * rs) * g + b with
every operation rounded. rs is 1 / sqrt in f32 here (the card's rsqrtf is
within 2 f32 ulps of it).

The check, against JAX and against `layer_norm_reference`: every output
element within one bf16 ulp, each element's ulp taken at max(|ref|, 2^-8 of
its row's max|ref|), as `tests/test_torch_kernels.py` holds the kernel on
the card; and the variance within 1e-5 of an f64 two-pass one. Rows are
rounded to bf16 before either side sees them, at |mean| / spread up to 1e3:
bf16 keeps 8 bits, so the rounded rows' spread is then a few bf16 steps of
the mean, and a one-pass variance loses most of its bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rga3_tpu.ops.fused_block import _layernorm as jax_layernorm
from rga3_tpu_torch.ops import fused_block as fb

F32 = np.float32
EPS = 1e-6
ROWS = 256
WIDTHS = (16, 144, 576, 1152)


def bf16(a) -> np.ndarray:
    """a rounded to bf16 (nearest, ties to even), as f32."""
    t = torch.from_numpy(np.array(a, dtype=F32))
    return t.to(torch.bfloat16).float().numpy()


def tree8(v: np.ndarray) -> np.ndarray:
    """((v0+v1)+(v2+v3))+((v4+v5)+(v6+v7)) over the last axis, in f32."""
    pairs = v[..., 0::2] + v[..., 1::2]
    return (pairs[..., 0] + pairs[..., 1]) + (pairs[..., 2] + pairs[..., 3])


def group_sum(terms: np.ndarray, lanes: int, per_lane: int) -> np.ndarray:
    """The kernel's sum of (rows, chunks, 8) f32 terms a row: per lane in
    chunk order, then the xor butterfly across the group."""
    chunk = tree8(terms)
    rows, chunks = chunk.shape
    part = np.zeros((rows, lanes), F32)
    for k in range(per_lane):
        for lane in range(lanes):
            c = lane + k * lanes
            if c < chunks:
                part[:, lane] += chunk[:, c]
    idx, o = np.arange(lanes), lanes // 2
    while o:
        part = part + part[:, idx ^ o]
        o //= 2
    assert (part == part[:, :1]).all()  # every lane ends with the same sum
    return part[:, 0]


def kernel_model(x: np.ndarray, g: np.ndarray, b: np.ndarray, one_pass: bool = False):
    """(y rounded to bf16, mean, variance) of bf16-valued f32 rows, in the
    kernel's order; `one_pass` takes the variance as E[x^2] - E[x]^2."""
    rows, d = x.shape
    lanes, per_lane, _ = fb.layer_norm_tiling(d)
    xc = x.reshape(rows, d // 8, 8)
    mean = group_sum(xc, lanes, per_lane) / F32(d)
    if one_pass:
        var = group_sum(xc * xc, lanes, per_lane) / F32(d) - mean * mean
    else:
        dev = xc - mean[:, None, None]
        var = group_sum(dev * dev, lanes, per_lane) / F32(d)
    rs = F32(1) / np.sqrt(var + F32(EPS))
    y = ((x - mean[:, None]) * rs[:, None]) * g + b
    return bf16(y), mean, var


def ulp_err(out: np.ndarray, ref: np.ndarray) -> float:
    """max |out - ref| in bf16 ulps of ref, each ulp at max(|ref|, 2^-8 of
    the row's max|ref|)."""
    ref64 = ref.astype(np.float64)
    floor = np.abs(ref64).max(-1, keepdims=True) * 2.0 ** -8
    _, e = np.frexp(np.maximum(np.abs(ref64), np.maximum(floor, 1e-30)))
    return float((np.abs(out - ref64) / np.ldexp(1.0, e - 8)).max())


def rows_at(d: int, ratio: float, seed: int):
    """bf16 rows of unit spread around +-ratio, gamma and beta."""
    rng = np.random.default_rng(seed)
    x = bf16(rng.standard_normal((ROWS, d)) + ratio * rng.choice([-1.0, 1.0], (ROWS, 1)))
    return x, bf16(1 + 0.1 * rng.standard_normal(d)), bf16(0.1 * rng.standard_normal(d))


def references(x, g, b):
    y_jax = np.asarray(jax_layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), EPS))
    x_t, g_t, b_t = (torch.from_numpy(a).bfloat16() for a in (x, g, b))
    y_port = fb.layer_norm_reference(x_t, g_t, b_t, EPS)
    return bf16(y_jax), y_port.float().numpy()


@pytest.mark.parametrize("ratio", [0.0, 1.0, 10.0, 100.0, 1000.0])
@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_order_matches_jax_and_the_plain_version(d, ratio):
    x, g, b = rows_at(d, ratio, seed=d)
    y, _, var = kernel_model(x, g, b)
    y_jax, y_port = references(x, g, b)
    assert ulp_err(y, y_jax) <= 1.0
    assert ulp_err(y, y_port) <= 1.0
    x64 = x.astype(np.float64)
    exact = ((x64 - x64.mean(-1, keepdims=True)) ** 2).mean(-1)
    assert (np.abs(var - exact) <= 1e-5 * exact).all()  # a constant row: 0 on both sides


@pytest.mark.parametrize("d", WIDTHS[1:])
def test_one_pass_variance_fails_the_same_check(d):
    """At |mean| / spread 1e3 the one-pass variance is off by ~10% and its
    outputs by many ulps (at D = 16 the rounded rows are mostly constant,
    where both give 0)."""
    x, g, b = rows_at(d, 1000.0, seed=d)
    y, _, var = kernel_model(x, g, b, one_pass=True)
    y_jax, _ = references(x, g, b)
    assert ulp_err(y, y_jax) > 1.0
    x64 = x.astype(np.float64)
    exact = ((x64 - x64.mean(-1, keepdims=True)) ** 2).mean(-1)
    assert (np.abs(var - exact) > 1e-5 * exact).any()


@pytest.mark.parametrize("d,lanes", [(144, 4), (288, 8), (576, 16), (1152, 32)])
def test_tiling_at_the_main_path_widths(d, lanes):
    """Hiera-L's widths: groups of 4 / 8 / 16 / 32 lanes of 5 chunks (90% of
    the lanes busy), a block's pass of 256 / lanes rows (18 KB)."""
    got_lanes, per_lane, rows = fb.layer_norm_tiling(d)
    assert (got_lanes, per_lane, rows) == (lanes, 5, 256 // lanes)
    assert rows * 2 * d == 18432


def test_tiling_covers_every_width():
    for d in range(8, fb.LAYER_NORM_MAX_D + 1, 8):
        lanes, per_lane, rows = fb.layer_norm_tiling(d)
        assert lanes * per_lane >= d // 8 and per_lane <= 32 and lanes <= 32
        assert lanes * rows == 256
