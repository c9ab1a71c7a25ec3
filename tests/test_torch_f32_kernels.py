"""The f32 variants of the Hiera encoder's kernels (`csrc/f32_ops.cu`) and
the window kernel's windows under 16 tokens, against their plain PyTorch
versions on the card (marker `cuda`; they skip without one). This file
imports nothing of JAX:

    python -m pytest tests/test_torch_f32_kernels.py -m cuda --noconftest

f32 bound: per output row, max |kernel - plain| <= 1e-4 * max |plain|, with
TF32 off (the plain versions' products then run in f32 too): two f32
accumulations of the same terms in different orders differ by a few f32
ulps (~1e-7) of the row. bf16 bound (the small windows): 2e-2, as in
`test_torch_kernels.py`.
"""
import numpy as np
import pytest
import torch

from rga3_tpu_torch.ops import attention as tatt
from rga3_tpu_torch.ops import fused_block as fb

F32_TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tatt.reset_launches()
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _t(rng, shape, dev, dtype=torch.float32, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


def _rel_err(out, ref):
    """max over rows of max |out - ref| / max |ref|."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    d = (out.float() - ref.float()).abs().amax(-1)
    return (d / ref.float().abs().amax(-1).clamp_min(1e-6)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", list(fb.EPILOGUES))
@pytest.mark.parametrize("m,n,k", [(300, 144, 144), (1000, 432, 576), (77, 36, 4608),
                                   (129, 130, 12)])
def test_gemm_f32(dev, m, n, k, epilogue):
    rng = np.random.default_rng(m + n + k)
    a = _t(rng, (m, k), dev)
    w = _t(rng, (n, k), dev, scale=k ** -0.5)
    bias = _t(rng, (n,), dev, scale=0.1)
    res = _t(rng, (m, n), dev) if epilogue.startswith("res") else None
    out = fb.gemm(a, w, bias, epilogue=epilogue, residual=res)
    ref = fb.gemm_reference(a, w, bias, epilogue=epilogue, residual=res)
    assert fb.gemm_f32.launches == 1 and fb.gemm.launches == 0
    assert _rel_err(out, ref) < F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(1000, 144), (37, 1152), (5, 16)])
def test_layer_norm_f32(dev, rows, d):
    rng = np.random.default_rng(rows)
    x = _t(rng, (rows, d), dev, scale=3.0) + 1.5
    g, b = 1 + _t(rng, (d,), dev, scale=0.1), _t(rng, (d,), dev, scale=0.1)
    out = fb.layer_norm(x, g, b, 1e-6)
    assert fb.layer_norm_f32.launches == 1 and fb.layer_norm.launches == 0
    assert _rel_err(out, fb.layer_norm_reference(x, g, b, 1e-6)) < F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("ws,c,stride", [(8, 144, 432), (2, 16, 16), (16, 288, 864)])
def test_window_pool_f32(dev, ws, c, stride):
    rng = np.random.default_rng(ws)
    x = _t(rng, (2, 3 * ws * ws, stride), dev)[:, :, :c]  # the q columns of a qkv
    out = fb.window_pool2x2(x, ws)
    assert fb.window_pool2x2_f32.launches == 1
    assert torch.equal(out, fb.window_pool2x2_reference(x, ws))


# (window, q_window, head dim): Hiera-L's windows and pooled queries, a tiny
# Hiera's 2x2 windows and pooled 1-token queries
WINDOW_F32 = [(64, 64, 72), (16, 4, 72), (256, 64, 72), (256, 256, 72), (4, 4, 16), (4, 1, 16),
              (16, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("w,qw,d", WINDOW_F32)
def test_window_attention_f32(dev, w, qw, d):
    rng = np.random.default_rng(w * qw + d)
    b, nw, h = 2, 6, 3
    qkv = _t(rng, (b, nw * w, 3, h, d), dev)
    q = qkv[:, :, 0]
    if qw != w:  # pooled queries: their own tensor
        q = _t(rng, (b, nw * qw, h, d), dev)
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    out = tatt.window_attention(q, k, v, w, q_window=qw)
    assert tatt.window_attention_f32.launches == 1 and tatt.window_attention.launches == 0
    ref = tatt.window_reference(q, k, v, w, d ** -0.5, q_window=qw)
    assert _rel_err(out, ref) < F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,d", [(2, 1024, 1024, 8, 72), (1, 4096, 9, 8, 16),
                                         (1, 300, 300, 2, 80)])
def test_flash_attention_f32(dev, b, lq, lk, h, d):
    rng = np.random.default_rng(lq + d)
    q, k, v = _t(rng, (b, lq, h, d), dev), _t(rng, (b, lk, h, d), dev), _t(rng, (b, lk, h, d), dev)
    out = tatt.flash_attention(q, k, v)
    assert tatt.flash_attention_f32.launches == 1 and tatt.flash_attention.launches == 0
    assert _rel_err(out, tatt.mha_reference(q, k, v)) < F32_TOL
    with pytest.raises(ValueError):
        tatt.flash_attention(q, q, q, causal=True)


@pytest.mark.cuda
def test_other_dtypes_raise(dev):
    x = torch.zeros(64, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fb.gemm(x, x, x[0])
    with pytest.raises(TypeError):
        fb.layer_norm(x, x[0], x[0], 1e-6)
    q = torch.zeros(1, 16, 1, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        tatt.window_attention(q, q, q, 16)


def _block_params(rng, dev, dtype, c_in, d, f, transition=False):
    def lin(n, k):
        return _t(rng, (n, k), dev, dtype, k ** -0.5), _t(rng, (n,), dev, dtype, 0.1)

    p = {"ln1_g": 1 + _t(rng, (c_in,), dev, dtype, 0.1), "ln1_b": _t(rng, (c_in,), dev, dtype, 0.1),
         "ln2_g": 1 + _t(rng, (d,), dev, dtype, 0.1), "ln2_b": _t(rng, (d,), dev, dtype, 0.1)}
    p["wqkv"], p["bqkv"] = lin(3 * d, c_in)
    p["wproj"], p["bproj"] = lin(d, c_in)
    if transition:
        p["wattn"], p["battn"] = lin(d, d)
    p["w1"], p["b1"] = lin(f, d)
    p["w2"], p["b2"] = lin(d, f)
    return p


# (dtype, embed dim, heads, window side): Hiera-L's stage-1 block in f32; a
# tiny Hiera's 2x2 windows in both dtypes
BLOCKS = [(torch.float32, 144, 2, 8), (torch.float32, 32, 2, 2), (torch.bfloat16, 32, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,heads,ws", BLOCKS)
def test_fused_blocks(dev, dtype, d, heads, ws):
    """The four fused wrappers in f32 and at a tiny Hiera's windows, each
    against its plain version."""
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    rng = np.random.default_rng(d + ws)
    x = _t(rng, (2, 4 * ws * ws, d), dev, dtype)
    p = _block_params(rng, dev, dtype, d, d, 4 * d)
    kw = dict(num_heads=heads, window=ws * ws)
    assert _rel_err(fb.fused_window_block(x, p, **kw), fb.reference_block(x, p, **kw)) < tol
    assert _rel_err(fb.fused_window_block_split(x, p, **kw),
                    fb.reference_block(x, p, split=True, **kw)) < tol
    assert _rel_err(fb.fused_global_block(x, p, num_heads=heads),
                    fb.reference_global_block(x, p, num_heads=heads)) < tol
    pt = _block_params(rng, dev, dtype, d, 2 * d, 8 * d, transition=True)
    kw = dict(num_heads=2 * heads, ws=ws)
    assert _rel_err(fb.fused_transition_block(x, pt, **kw),
                    fb.reference_transition(x, pt, **kw)) < tol
    if dtype == torch.float32:  # the f32 chains count in the f32 kernels' records only
        assert fb.fused_window_block.launches == 0 and fb.gemm.launches == 0
        assert fb.gemm_f32.launches > 0 and fb.layer_norm_f32.launches > 0
        assert fb.window_pool2x2_f32.launches == 2 and tatt.window_attention_f32.launches == 3
    else:
        assert fb.fused_window_block.launches == 1 and tatt.window_attention.launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("w,qw", [(1, 1), (2, 2), (4, 4), (8, 8), (4, 1), (16, 4)])
@pytest.mark.parametrize("d", [16, 72])
def test_small_windows_bf16(dev, w, qw, d):
    """Windows under 16 tokens, packed 16 / w into a warp's MMA tile and
    masked block-diagonally; lengths that end inside a 16-key chunk."""
    rng = np.random.default_rng(w * 10 + qw + d)
    b, h = 2, 3
    nw = 37  # 37 windows: the keys end off a 16-key chunk
    q = _t(rng, (b, nw * qw, h, d), dev, torch.bfloat16)
    k = _t(rng, (b, nw * w, h, d), dev, torch.bfloat16)
    v = _t(rng, (b, nw * w, h, d), dev, torch.bfloat16)
    out = tatt.window_attention(q, k, v, w, q_window=qw)
    assert tatt.window_attention.launches == 1
    ref = tatt.window_reference(q, k, v, w, d ** -0.5, q_window=qw)
    assert _rel_err(out, ref) < BF16_TOL
