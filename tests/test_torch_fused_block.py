"""The port's fused Hiera blocks (rga3_tpu_torch/ops/fused_block.py) against
the JAX package's, on the CPU, with the same seeded numpy inputs.

The port's plain versions (what its wrappers compute for a CPU tensor) meet:
  * the JAX Pallas kernels run in interpret mode, so that their bodies run,
    and the JAX `_reference_*` mirrors: in f32 at rtol = atol = 2e-4, the
    JAX package's own bound for interpret vs reference
    (tests/test_fused_block.py);
  * the interpret-mode kernels in bf16, per token row: max |port - JAX| <=
    2e-2 * max |JAX| of the row, about two bf16 ulps. This pins the rounding
    points (bias added in f32 before rounding, GELU on the rounded sum, bf16
    or f32 residual adds), which f32 cannot tell apart.
Sizes: B 2, L 128, D 64, H 4, window 16; the transition C_in 32 -> C_out 64,
ws 4 (kv windows of 16 tokens, pooled q windows of 4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rga3_tpu.ops import fused_block as jfb
from rga3_tpu_torch.ops import attention as tatt
from rga3_tpu_torch.ops import fused_block as tfb

B, L, D, H, W = 2, 128, 64, 4, 16
C_IN, WS = 32, 4
F32_TOL = 2e-4
ROW_TOL = 2e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _params(seed, c_in, d, transition=False):
    """JAX-layout (in, out) numpy params, f32."""
    rng = np.random.default_rng(seed)
    shapes = {"ln1_g": (c_in,), "ln1_b": (c_in,), "wqkv": (c_in, 3 * d), "bqkv": (3 * d,),
              "wproj": (c_in, d), "bproj": (d,), "ln2_g": (d,), "ln2_b": (d,),
              "w1": (d, 4 * d), "b1": (4 * d,), "w2": (4 * d, d), "b2": (d,)}
    if transition:
        shapes.update(wattn=(d, d), battn=(d,))
    p = {}
    for k, s in shapes.items():
        x = rng.standard_normal(s) * 0.1
        p[k] = (x + 1 if k.endswith("_g") else x).astype(np.float32)
    return p


def _inputs(dt, seed, shape, params):
    """The same values in both packages: rounded to `dt` first."""
    jdt, tdt = DTYPES[dt]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt) for k, v in jp.items()}
    tp = {k: (v.t().contiguous() if v.ndim == 2 else v) for k, v in tp.items()}
    return jx, jp, tx, tp


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.astype(jnp.float32))


def _close(port, jax_out, dt):
    a, b = _np(port), _np(jax_out)
    assert a.shape == b.shape
    if dt == "f32":
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
    else:
        err = np.abs(a - b).max(-1) / np.maximum(np.abs(b).max(-1), 1e-6)
        assert err.max() <= ROW_TOL, err.max()


def _row(v):
    return v.reshape(1, -1)


# ---- the four blocks ---------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("gelu_tanh", [True, False])
def test_window_block(dt, gelu_tanh):
    jx, jp, tx, tp = _inputs(dt, 0, (B, L, D), _params(1, D, D))
    got = tfb.fused_window_block(tx, tp, num_heads=H, window=W, gelu_tanh=gelu_tanh)
    for blk in (64, 16):  # block > window (masked) and block == window
        _close(got, jfb.fused_window_block(jx, jp, num_heads=H, window=W, block_q=blk,
                                           interpret=True, gelu_tanh=gelu_tanh), dt)
    if dt == "f32":
        _close(got, jfb._reference_block(jx, jp, num_heads=H, window=W, eps=1e-6,
                                         scale=(D // H) ** -0.5, gelu_tanh=gelu_tanh), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_global_block(dt):
    jx, jp, tx, tp = _inputs(dt, 2, (B, L, D), _params(3, D, D))
    got = tfb.fused_global_block(tx, tp, num_heads=H)
    _close(got, jfb.fused_global_block(jx, jp, num_heads=H, block_q=64, interpret=True), dt)
    if dt == "f32":
        _close(got, jfb._reference_global_block(jx, jp, num_heads=H, eps=1e-6,
                                                scale=(D // H) ** -0.5), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_split_window_block(dt):
    jx, jp, tx, tp = _inputs(dt, 4, (B, L, D), _params(5, D, D))
    got = tfb.fused_window_block_split(tx, tp, num_heads=H, window=W)
    _close(got, jfb.fused_window_block_split(jx, jp, num_heads=H, window=W, block_q=64,
                                             block_f=128, interpret=True), dt)
    if dt == "f32":
        _close(got, jfb._reference_block(jx, jp, num_heads=H, window=W, eps=1e-6,
                                         scale=(D // H) ** -0.5), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("gelu_tanh", [True, False])
def test_transition_block(dt, gelu_tanh):
    n_win = 8
    jx, jp, tx, tp = _inputs(dt, 6, (B, n_win * WS * WS, C_IN),
                             _params(7, C_IN, 2 * C_IN, transition=True))
    got = tfb.fused_transition_block(tx, tp, num_heads=H, ws=WS, gelu_tanh=gelu_tanh)
    assert got.shape == (B, n_win * WS * WS // 4, 2 * C_IN)
    _close(got, jfb.fused_transition_block(jx, jp, num_heads=H, ws=WS, interpret=True,
                                           gelu_tanh=gelu_tanh), dt)
    if dt == "f32":
        _close(got, jfb._reference_transition(jx, jp, num_heads=H, ws=WS, eps=1e-6,
                                              scale=(2 * C_IN // H) ** -0.5,
                                              gelu_tanh=gelu_tanh), dt)


# ---- the four row kernels ------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ln_qkv(dt):
    jx, jp, tx, tp = _inputs(dt, 8, (B, L, D), _params(9, D, D))
    got = tfb.ln_qkv(tx, tp["ln1_g"], tp["ln1_b"], tp["wqkv"], tp["bqkv"], eps=1e-6)
    want = jfb._ln_qkv_call(jx, _row(jp["ln1_g"]), _row(jp["ln1_b"]), jp["wqkv"],
                            _row(jp["bqkv"]), block_q=64, eps=1e-6, interpret=True)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_proj_mlp(dt):
    jx, jp, tx, tp = _inputs(dt, 10, (B, L, D), _params(11, D, D))
    ja, _, ta, _ = _inputs(dt, 12, (B, L, D), {})
    got = tfb.proj_mlp(ta, tx, tp["wproj"], tp["bproj"], tp["ln2_g"], tp["ln2_b"],
                       tp["w1"], tp["b1"], tp["w2"], tp["b2"], eps=1e-6)
    want = jfb._proj_mlp_call(ja, jx, jp["wproj"], _row(jp["bproj"]), _row(jp["ln2_g"]),
                              _row(jp["ln2_b"]), jp["w1"], _row(jp["b1"]), jp["w2"],
                              _row(jp["b2"]), block_q=64, eps=1e-6, interpret=True)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_proj_ln(dt):
    jx, jp, tx, tp = _inputs(dt, 13, (B, L, D), _params(14, D, D))
    ja, _, ta, _ = _inputs(dt, 15, (B, L, D), {})
    y, ln2y = tfb.proj_ln(ta, tx, tp["wproj"], tp["bproj"], tp["ln2_g"], tp["ln2_b"], eps=1e-6)
    jy, jln2y = jfb._proj_ln_call(ja, jx, jp["wproj"], _row(jp["bproj"]), _row(jp["ln2_g"]),
                                  _row(jp["ln2_b"]), block_q=64, eps=1e-6, interpret=True)
    _close(y, jy, dt)
    _close(ln2y, jln2y, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp_blocked(dt):
    jx, jp, tx, tp = _inputs(dt, 16, (B, L, D), _params(17, D, D))
    jl, _, tl, _ = _inputs(dt, 18, (B, L, D), {})
    got = tfb.mlp_blocked(tl, tx, tp["w1"], tp["b1"], tp["w2"], tp["b2"])
    want = jfb._mlp_blocked_call(jl, jx, jp["w1"], _row(jp["b1"]), jp["w2"], _row(jp["b2"]),
                                 block_q=64, block_f=128, interpret=True)
    _close(got, want, dt)


# ---- the pieces the kernels are built from --------------------------------------

def test_window_pool_matches_jax():
    x = np.random.default_rng(19).standard_normal((3 * 8 * 8, 24)).astype(np.float32)
    want = np.asarray(jfb._pool_win_2x2(jnp.asarray(x), 3, 8))
    got = tfb.window_pool2x2_reference(torch.from_numpy(x)[None], 8)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_pooled_window_reference_is_per_window_attention():
    rng = np.random.default_rng(20)
    q = torch.from_numpy(rng.standard_normal((2, 12, 3, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 48, 3, 8)).astype(np.float32))
            for _ in range(2))
    got = tatt.window_attention(q, k, v, 16, q_window=4, scale=0.3)
    for w in range(3):
        want = tatt.mha_reference(q[:, 4 * w:4 * w + 4], k[:, 16 * w:16 * w + 16],
                                  v[:, 16 * w:16 * w + 16], scale=0.3)
        torch.testing.assert_close(got[:, 4 * w:4 * w + 4], want, rtol=0, atol=0)


@pytest.mark.parametrize("epilogue", ["bias", "gelu_tanh", "gelu_erf", "res_bf16", "res_f32"])
def test_gemm_reference_epilogues(epilogue):
    """In bf16: the rounding points the kernel's epilogues follow."""
    rng = np.random.default_rng(21)

    def bf(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()

    a, w, bias, res = bf(5, 16), bf(8, 16), bf(8), bf(5, 8)
    got = tfb.gemm(a, w, bias, epilogue=epilogue, residual=res)
    acc = a.float() @ w.float().t()
    h = (acc + bias.float()).bfloat16()
    want = {
        "bias": h,
        "gelu_tanh": torch.nn.functional.gelu(h.float(), approximate="tanh").bfloat16(),
        "gelu_erf": torch.nn.functional.gelu(h.float()).bfloat16(),
        "res_bf16": (res.float() + h.float()).bfloat16(),
        "res_f32": (res.float() + bias.float() + acc).bfloat16(),
    }[epilogue]
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0)


def test_cpu_tensors_launch_no_fused_kernel():
    tatt.reset_launches()
    jx, jp, tx, tp = _inputs("f32", 22, (1, 32, D), _params(23, D, D))
    tfb.fused_window_block(tx, tp, num_heads=H, window=W)
    tfb.fused_global_block(tx, tp, num_heads=H)
    wrappers = (tfb.gemm, tfb.layer_norm, tfb.window_pool2x2, tfb.ln_qkv, tfb.proj_mlp,
                tfb.proj_ln, tfb.mlp_blocked, tfb.fused_window_block,
                tfb.fused_window_block_split, tfb.fused_global_block,
                tfb.fused_transition_block)
    assert all(f.launches == 0 and f.shapes == {} for f in wrappers)
    for f in wrappers:
        f.launches, f.shapes = 2, {("k",): [2, None]}
    tatt.reset_launches()
    assert all(f.launches == 0 and f.shapes == {} for f in wrappers)


def _counting_ops():
    """The plain operation table with a count of each operation's calls."""
    from types import SimpleNamespace

    counts = {}

    def counted(name, fn):
        def call(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return call

    ops = SimpleNamespace(**{k: counted(k, v) for k, v in vars(tfb._PLAIN).items()})
    return ops, counts


@pytest.mark.parametrize("kind,want", [
    # one LayerNorm before each pair of products; the window block chains
    # the kernels itself (one Pallas kernel), the global and split blocks
    # call rows 4-7 (which the table's plain versions then compute)
    ("window", {"layer_norm": 2, "gemm": 4, "window": 1}),
    ("global", {"ln_qkv": 1, "flash": 1, "proj_mlp": 1}),
    ("split", {"ln_qkv": 1, "window": 1, "proj_ln": 1, "mlp_blocked": 1}),
    # LN1 once for both the shortcut's and the qkv product
    ("transition", {"layer_norm": 2, "gemm": 5, "pool": 2, "window": 1}),
])
def test_block_chains(kind, want):
    ops, counts = _counting_ops()
    tr = kind == "transition"
    _, _, tx, tp = _inputs("f32", 24, (1, 4 * WS * WS, C_IN if tr else D),
                           _params(25, C_IN if tr else D, D, transition=tr))
    if kind == "transition":
        out = tfb._transition(ops, tx, tp, H, WS, 1e-6, 0.25, True)
        ref = tfb.reference_transition(tx, tp, num_heads=H, ws=WS, scale=0.25)
    elif kind == "global":
        out = tfb._global_block(ops, tx, tp, H, 1e-6, 0.25, True)
        ref = tfb.reference_global_block(tx, tp, num_heads=H, scale=0.25)
    else:
        split = kind == "split"
        out = tfb._window_block(ops, tx, tp, H, W, 1e-6, 0.25, True, split)
        ref = tfb.reference_block(tx, tp, num_heads=H, window=W, scale=0.25, split=split)
    assert counts == want
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
