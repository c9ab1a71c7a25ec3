"""The port's quantization (rga3_tpu_torch.ops.quant) against the JAX
package's, on the CPU, with numpy-seeded inputs.

Tolerances: quantized bytes and scales identical; the plain int4 product
within 1e-5 relative of the interpret-mode Pallas kernel and of the JAX
unpack route in f32 (sums of the same f32 terms in another order), and in
bf16 within 2e-2 of each row's max|ref| (one rounding of an f32 sum on both
sides, a bf16 ulp is 2^-7 of the row's largest value); the int8 products
within 1e-5 relative in f32 (W8A8's s32 product is exact on both sides).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.qwen25vl.model import Qwen25VL as JaxQwen
from rga3_tpu.models.qwen25vl.vision import (
    compute_vision_layout as jax_layout, layout_device_args as jax_layout_args,
)
from rga3_tpu.ops import quant as jq
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.qwen25vl.language import QuantLinear
from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL
from rga3_tpu_torch.models.qwen25vl.vision import compute_vision_layout, layout_device_args
from rga3_tpu_torch.ops import quant as tq

from torch_port_support import jax_param_tree


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max()
                 / max(np.abs(np.asarray(b, np.float32)).max(), 1e-12))


@pytest.mark.parametrize("bits,in_dim,out", [
    (8, 60, 36), (8, 128, 48), (4, 128, 48), (4, 96, 40), (4, 3584 // 28, 8),
])
def test_quantized_bytes_and_scales_match_jax(bits, in_dim, out):
    w = _rand(in_dim + out, (in_dim, out), 0.05)
    w[:, 0] = 0.0  # an all-zero channel takes scale 1
    jfn, tfn = (jq.quantize_int8, tq.quantize_int8) if bits == 8 else (
        jq.quantize_int4, tq.quantize_int4)
    jqw, js = jfn(jnp.asarray(w))
    tqw, ts = tfn(torch.from_numpy(w))
    assert tqw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if bits == 4:
        np.testing.assert_array_equal(
            tq.dequantize_int4(tqw, ts).numpy(),
            jq.dequantize_qwen_params({"kernel_q4": jqw, "scale_g": js})["kernel"])


# (in, out, M): shapes the Pallas route takes (in % 64 == 0, in/2 a multiple
# of 256, out of 128)
@pytest.mark.parametrize("in_dim,out,m", [(512, 512, 1), (512, 384, 5), (1024, 256, 17)])
def test_int4_plain_matches_interpret_pallas(in_dim, out, m):
    w = _rand(in_dim, (in_dim, out), 0.05)
    x = _rand(m, (m, in_dim))
    q4, sg = jq.quantize_int4(jnp.asarray(w))
    ref = jq.int4_matmul(jnp.asarray(x), q4, sg, interpret=True)
    got = tq.int4_matmul(torch.from_numpy(x), torch.from_numpy(np.array(q4)),
                         torch.from_numpy(np.array(sg)))
    assert _rel(got.numpy(), ref) <= 1e-5
    xb = jnp.asarray(x, jnp.bfloat16)
    ref_b = np.asarray(jq.int4_matmul(xb, q4, sg, interpret=True), np.float32)
    got_b = tq.int4_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(np.array(q4)),
                           torch.from_numpy(np.array(sg))).float().numpy()
    row = np.abs(got_b - ref_b).max(-1) / np.abs(ref_b).max(-1)
    assert row.max() <= 2e-2


@pytest.mark.parametrize("in_dim,out,m", [(96, 128, 2), (64, 128, 3)])
def test_int4_plain_matches_jax_unpack_route(in_dim, out, m):
    w = _rand(in_dim, (in_dim, out), 0.05)
    x = _rand(m, (2, m, in_dim))
    q4, sg = jq.quantize_int4(jnp.asarray(w))
    ref = jq.int4_matmul(jnp.asarray(x), q4, sg)
    got = tq.int4_matmul(torch.from_numpy(x), torch.from_numpy(np.array(q4)),
                         torch.from_numpy(np.array(sg)))
    assert got.shape == (2, m, out)
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("k,n,m", [(60, 36, 40), (64, 48, 33), (3420 // 45, 20, 17)])
def test_int8_and_w8a8_match_jax(k, n, m):
    w = _rand(k, (k, n), 0.05)
    x = _rand(m, (1, m, k))
    jqw, js = jq.quantize_int8(jnp.asarray(w))
    tqw, ts = torch.from_numpy(np.array(jqw)), torch.from_numpy(np.array(js))
    xt = torch.from_numpy(x)
    assert _rel(tq.int8_matmul(xt, tqw, ts).numpy(),
                jq.int8_matmul(jnp.asarray(x), jqw, js)) <= 1e-5
    assert _rel(tq.int8_w8a8_matmul(xt, tqw, ts).numpy(),
                jq.int8_w8a8_matmul(jnp.asarray(x), jqw, js)) <= 1e-5


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_linear_from_linear_matches_the_functions(bits):
    lin = torch.nn.Linear(64, 24, bias=True)
    ql = QuantLinear.from_linear(lin, bits)
    # the kernel takes contiguous buffers; the weight's transpose is not
    assert all(b.is_contiguous() for b in ql.buffers())
    x = torch.from_numpy(_rand(3, (2, 5, 64)))
    w = lin.weight.detach().t()
    if bits == 4:
        q, s = tq.quantize_int4(w)
        ref = tq.int4_matmul(x, q, s) + lin.bias.detach()
    else:
        q, s = tq.quantize_int8(w)
        ref = tq.int8_matmul(x, q, s) + lin.bias.detach()
    with torch.no_grad():
        torch.testing.assert_close(ql(x), ref, rtol=0, atol=0)


@pytest.fixture(scope="module")
def float_tree():
    jcfg = jax_tiny_config(vocab_size=152_000)
    la = jax_layout_args(jax_layout([(1, 4, 4)], jcfg.vision), jcfg.vision)
    return jax_param_tree(JaxQwen(jcfg), jnp.zeros((1, 12), jnp.int32),
                          pixel_patches=jnp.zeros((16, 3 * 2 * 14 * 14)),
                          vision_layout=la, seed=3)


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_jax_serving_tree_loads_strict_and_port_quantizer_agrees(float_tree, mode):
    """A JAX `quantize_for_serving` tree loads into the port's serving
    model with strict=True, and the port's own in-place transform of the
    float model gives the same bytes and scales."""
    jtree = jq.quantize_for_serving(float_tree["params"], mode)
    sd = torch_state_dict_from_flax(jtree)
    cfg = tiny_config(vocab_size=152_000)
    text = {"quant_int4": True} if mode == "int4" else {"quant_int8": True}
    qcfg = cfg.replace(text=cfg.text.replace(**text),
                       vision=cfg.vision.replace(quant_int8=True))
    served = Qwen25VL(qcfg, device="cpu")
    served.load_state_dict(sd, strict=True)
    attn = served.lm.model.layers_0.self_attn
    if mode == "int4":
        assert attn.q_proj.kernel_q4.dtype == torch.int8
        assert attn.q_proj.scale_g.dtype == torch.float32
    assert served.visual.blocks_0.attn_qkv.kernel_q.dtype == torch.int8

    port = Qwen25VL(cfg, device="cpu")
    port.load_state_dict(torch_state_dict_from_flax(float_tree), strict=True)
    tq.quantize_for_serving(port, mode)
    assert port.cfg == qcfg and port.lm.model.cfg == qcfg.text
    mine = port.state_dict()
    assert set(mine) == set(sd)
    for key, val in sd.items():
        assert mine[key].dtype == val.dtype, key
        torch.testing.assert_close(mine[key], val, rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("w8a8", [False, True], ids=["int8", "w8a8"])
def test_vision_tower_int8_matches_jax(float_tree, w8a8):
    """The int8 vision tower on 64 patches: weight-only within 1e-4; W8A8
    (from 32 tokens) within 5e-4 of max|ref|. W8A8 rounds each activation to
    1/127 of its token's absmax, so f32 differences of ~1e-7 between the
    packages move an activation lying at a rounding boundary by one step;
    the port's W8A8 tower differs from its own weight-only tower by ~3e-3
    of max|ref|, six times the bound."""
    grid = [(1, 8, 8)]
    jcfg = jax_tiny_config(vocab_size=152_000)
    jcfg = jcfg.replace(vision=jcfg.vision.replace(quant_int8=True, quant_w8a8=w8a8))
    cfg = tiny_config(vocab_size=152_000)
    cfg = cfg.replace(vision=cfg.vision.replace(quant_int8=True, quant_w8a8=w8a8))
    params = jq.quantize_qwen_params(float_tree, keys=(), include_vision=True)
    tm = Qwen25VL(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    patches = np.random.default_rng(0).integers(0, 256, (64, 3 * 2 * 14 * 14), dtype=np.uint8)
    jl = jax_layout_args(jax_layout(grid, jcfg.vision), jcfg.vision)
    jv = JaxQwen(jcfg).apply(params, jnp.asarray(patches), jl,
                             method=lambda m, x, la: m.encode_vision(x, la))
    with torch.no_grad():
        tv = tm.visual(torch.from_numpy(patches),
                       layout_device_args(compute_vision_layout(grid, cfg.vision), cfg.vision))
    ref = np.asarray(jv)
    atol = 5e-4 * np.abs(ref).max() if w8a8 else 1e-4
    np.testing.assert_allclose(tv.numpy(), ref, atol=atol, rtol=0)
