"""The int4 dequant-matmul's plain version at the token boundaries of the
TMA tile of `csrc/int4_matmul.cu` (M = 5, the first prefill; 64 and 65, 129
around its 128-token tiles) against the interpret-mode Pallas kernel, and
the tile's launch policy (`ops.quant.int4_splits`) at every projection of
the Qwen2.5-VL-7B LM, on the CPU.

Tolerances as in test_torch_quant.py: f32 within 1e-5 relative (sums of the
same f32 terms in another order); bf16 within 2e-2 of each row's max|ref|
(one rounding of an f32 sum on both sides).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rga3_tpu.ops import quant as jq
from rga3_tpu_torch.ops import quant as tq

SMS = 132  # an H100 SXM's SMs
# (in, out) of q / o, k / v, gate / up, down and lm_head
LM_7B = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (3584, 152064))


@pytest.mark.parametrize("m", [5, 64, 65, 129])
def test_int4_plain_matches_interpret_pallas_at_tile_boundaries(m):
    # in/2 = 256 packed rows and out = 256: the shapes the Pallas route takes
    rng = np.random.default_rng(m)
    w = (0.05 * rng.standard_normal((512, 256))).astype(np.float32)
    x = rng.standard_normal((m, 512)).astype(np.float32)
    q4, sg = jq.quantize_int4(jnp.asarray(w))
    q, s = torch.from_numpy(np.array(q4)), torch.from_numpy(np.array(sg))
    ref = np.asarray(jq.int4_matmul(jnp.asarray(x), q4, sg, interpret=True), np.float32)
    got = tq.int4_matmul(torch.from_numpy(x), q, s).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    ref_b = np.asarray(jq.int4_matmul(jnp.asarray(x, jnp.bfloat16), q4, sg, interpret=True),
                       np.float32)
    got_b = tq.int4_matmul(torch.from_numpy(x).bfloat16(), q, s).float().numpy()
    assert (np.abs(got_b - ref_b).max(-1) / np.abs(ref_b).max(-1)).max() <= 2e-2


def _splits_taken(stages, splits):
    """The splits the C entry point runs for `splits` asked: none empty."""
    per = -(-stages // splits)
    return -(-stages // per)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("in_dim,out", LM_7B)
def test_int4_decode_splits_fill_the_card(m, in_dim, out):
    splits = tq.int4_splits(m, in_dim, out, SMS)
    stages = -(-in_dim // 2 // tq.INT4_STAGE_ROWS)
    tiles = -(-out // tq.int4_decode_cols(out, SMS))
    # the C entry point takes it as it is: 1 <= splits <= stages, none empty
    assert 1 <= splits <= stages and _splits_taken(stages, splits) == splits
    # the units fill the card, or the shape allows no more units of two stages
    finest = _splits_taken(stages, -(-stages // 2))
    assert tiles * splits >= 0.8 * SMS or splits == finest
    # and no fewer splits would have
    assert splits == 1 or tiles * max(
        s for s in range(1, splits) if _splits_taken(stages, s) == s) < 0.8 * SMS


@pytest.mark.parametrize("out,cols", [(512, 128), (3584, 128), (18944, 144), (152064, 128)])
def test_int4_decode_units_widen_only_where_they_then_fit_the_sms(out, cols):
    # 18944 columns: 148 units of 128 put a second block on 16 SMs, 132 of
    # 144 one on each; where both overflow (152064) or both fit, 128
    assert tq.int4_decode_cols(out, SMS) == cols


@pytest.mark.parametrize("m", [1280, 5111])
@pytest.mark.parametrize("in_dim,out", LM_7B[:4])
def test_int4_prefill_takes_no_splits(m, in_dim, out):
    # the C entry point refuses splits above M = 4
    assert tq.int4_splits(m, in_dim, out, SMS) == 1


@pytest.mark.parametrize("m,in_dim,out", [(1, 96, 200), (4, 130, 512), (300, 3584, 200),
                                          (2, 3584, 520)])
def test_int4_generic_shapes_take_no_splits(m, in_dim, out):
    # in or out off a multiple of 16: TMA cannot address the rows, and the
    # generic tile has no splits
    assert tq.int4_splits(m, in_dim, out, SMS) == 1
