"""The port's CoTracker3 at the shipped compute dtype (bf16) against the JAX
package's, one rounding point at a time, on the CPU.

The reference is run op by op (`jax.disable_jit()`): that program is what
fixes where flax rounds to bf16. Each module of the port must give the
reference's bf16 bits on at least 99% of its elements, and differ on the
others by at most one bf16 step (2^-8) of the tensor's largest value. Its
ops sum their products in another order than XLA's, so a rounded f32 sum
lands on the other side of a bf16 tie now and then: one op alone keeps the
reference's bits on 99.98% of its elements or more, and a flip in q or k
reaches every logit it enters, so the attention keeps them on 99.4-99.8%.
The same gate rejects a port that rounds once where the reference rounds
twice (an f32 GELU, pool or fused bias rounded at the end: 55-71% of the
bits) or keeps the attention logits in f32 (46%), so it catches a
misplaced rounding point: `test_gate_rejects_single_rounding` holds that.
`-s` prints each comparison's share.

Held here: flax `Dense` / `Conv` with `dtype=bf16` (input and kernel cast,
the product rounded, the bias added in bf16), the tanh GELU, the pyramid's
2x2 average, `instance_norm` and `_pre_norm` (f32 statistics, cast back),
`norm_context` (a LayerNorm with no dtype: f32 out), the attention (f32
logits and softmax), the correlation embedding (bf16 operands, f32 sums), and
the stencil sampler's bf16 fractional weights (in `test_torch_cotracker3.py`).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as nn
import torch
import torch.nn.functional as F

from rga3_tpu.models.stom import cotracker3 as jct
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.models.stom import cotracker3 as tct

from torch_port_support import jax_param_tree

EXACT = 0.99         # share of elements with the reference's bits
SPREAD = 2.0 ** -8   # the others: within one bf16 step of the tensor's largest value

BF = jnp.bfloat16


def _agreement(got, ref):
    """(share of equal bf16 values, max |got - ref| / max |ref|)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return (got == ref).mean(), np.abs(got - ref).max() / np.abs(ref).max()


def _bits_agree(got, ref) -> bool:
    same, spread = _agreement(got, ref)
    print(f"bit-identical share {same:.5f}, max |diff| / max |ref| {spread:.3e}")
    return same >= EXACT and spread <= SPREAD


def _assert_bits(got, ref):
    same, spread = _agreement(got, ref)
    print(f"bit-identical share {same:.5f}, max |diff| / max |ref| {spread:.3e}")
    assert same >= EXACT, f"bit-identical share {same:.5f}"
    assert spread <= SPREAD, f"max |diff| / max |ref| {spread:.3e}"


def _eager(fn, *args):
    """The reference op by op, as f32 numpy."""
    with jax.disable_jit():
        return np.asarray(fn(*args).astype(jnp.float32))


def _bf16(x: np.ndarray):
    """(the JAX bf16 array, the same values as a torch bf16 tensor)."""
    j = jnp.asarray(x).astype(BF)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _dense(d_in, d_out, seed):
    jm = nn.Dense(d_out, dtype=BF)
    params = jax_param_tree(jm, jnp.zeros((1, d_in)), seed=seed, std=d_in ** -0.5)
    tm = tct.Dense(d_in, d_out, torch.bfloat16)
    tm.load_state_dict(torch_state_dict_from_flax(params["params"]), strict=True)
    return jm, params, tm


def _conv(c_in, c_out, k, stride, seed):
    pad = (k - 1) // 2
    jm = nn.Conv(c_out, (k, k), strides=stride, padding=pad, dtype=BF)
    params = jax_param_tree(jm, jnp.zeros((1, 16, 16, c_in)), seed=seed,
                            std=(k * k * c_in) ** -0.5)
    tm = tct.Conv(c_in, c_out, k, stride, pad, torch.bfloat16)
    tm.load_state_dict(torch_state_dict_from_flax(params["params"]), strict=True)
    return jm, params, tm


def test_gelu_tanh():
    x, xt = _bf16(np.random.default_rng(0).normal(0, 2, (64, 33, 96)))
    _assert_bits(_f32(tct._gelu_tanh(xt)), _eager(lambda v: nn.gelu(v, approximate=True), x))


def test_avg_pool2():
    # the pyramid's maps, (B*T, h, w, C) in the reference, NCHW in the port
    x, xt = _bf16(np.random.default_rng(1).normal(0, 2, (4, 41, 57, 96)))
    ref = _eager(lambda v: nn.avg_pool(v, (2, 2), strides=(2, 2), padding="VALID"), x)
    _assert_bits(_f32(tct._avg_pool2(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)), ref)


@pytest.mark.parametrize("norm", ["instance_norm", "_pre_norm"])
def test_norms(norm):
    x, xt = _bf16(np.random.default_rng(2).normal(1, 3, (4, 20, 28, 96)))
    ref = _eager(getattr(jct, norm), x)
    if norm == "instance_norm":  # NCHW in the port
        got = tct.instance_norm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    else:
        got = tct._pre_norm(xt)
    assert got.dtype == torch.bfloat16
    _assert_bits(_f32(got), ref)


def test_norm_context_layernorm_f32_out():
    """flax `nn.LayerNorm()` with no dtype on bf16 tokens: f32 statistics by
    E[x^2] - E[x]^2 and an f32 output (not rounded to bf16)."""
    jm = nn.LayerNorm(epsilon=1e-5)
    params = jax_param_tree(jm, jnp.zeros((1, 256)), seed=3)
    tm = tct.LayerNorm(256)
    tm.load_state_dict(torch_state_dict_from_flax(params["params"]), strict=True)
    x, xt = _bf16(np.random.default_rng(3).normal(1, 3, (8, 48, 256)))
    with jax.disable_jit():
        ref = jm.apply(params, x)
    got = tm(xt)
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), np.asarray(ref), rtol=0, atol=2e-6)


# the small file's layers: the update transformer's qkv / out / mlp, the
# correlation MLP's first layer (7x7 stencil squared), the input transform
@pytest.mark.parametrize("d_in,d_out", [(256, 768), (1024, 256), (2401, 256), (710, 256)])
def test_dense(d_in, d_out):
    jm, params, tm = _dense(d_in, d_out, seed=d_in)
    x, xt = _bf16(np.random.default_rng(4).normal(0, 1, (8, 48, d_in)))
    _assert_bits(_f32(tm(xt)), _eager(lambda v: jm.apply(params, v), x))


# the encoder's stem (7x7 / 2), a residual conv (3x3), a downsample (1x1 / 2)
@pytest.mark.parametrize("c_in,c_out,k,stride", [(3, 48, 7, 2), (48, 72, 3, 1), (72, 96, 1, 2)])
def test_conv(c_in, c_out, k, stride):
    jm, params, tm = _conv(c_in, c_out, k, stride, seed=k)
    x, xt = _bf16(np.random.default_rng(5).normal(0, 1, (2, 40, 56, c_in)))
    ref = _eager(lambda v: jm.apply(params, v), x)
    _assert_bits(_f32(tm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)), ref)


@pytest.mark.parametrize("cross", [False, True])
def test_attention(cross):
    """Self attention over time, and cross attention from bf16 queries to
    `norm_context`'s f32 output (which `to_kv` casts to bf16)."""
    jm = jct.Attention(256, 8, dtype=BF)
    params = jax_param_tree(jm, jnp.zeros((16, 8, 256)), seed=6, std=1 / 16)
    tm = tct.Attention(256, 8, torch.bfloat16)
    tm.load_state_dict(torch_state_dict_from_flax(params["params"]), strict=True)
    rng = np.random.default_rng(6)
    x, xt = _bf16(rng.normal(0, 1, (16, 8, 256)))
    if cross:
        ctx = rng.normal(0, 1, (16, 48, 256)).astype(np.float32)
        ref = _eager(lambda v, c: jm.apply(params, v, context=c), x, jnp.asarray(ctx))
        got = tm(xt, context=torch.from_numpy(ctx))
    else:
        ref = _eager(lambda v: jm.apply(params, v), x)
        got = tm(xt)
    _assert_bits(_f32(got), ref)


def test_corr_embedding():
    """The correlation volume of bf16 stencil samples and support patches,
    summed in f32 (`preferred_element_type`), divided by sqrt(C) in f32,
    then the bf16 correlation MLP (cotracker3.py's iteration body)."""
    cfg = tct.cotracker3_small_config()
    p, c = cfg.patch_points, cfg.latent_dim
    rng = np.random.default_rng(7)
    neigh, neigh_t = _bf16(rng.normal(0, 1, (1, 4, 16, p, c)))
    support, support_t = _bf16(rng.normal(0, 1, (1, 16, p, c)))
    fc1 = nn.Dense(cfg.corr_mlp_hidden, dtype=BF)
    fc2 = nn.Dense(cfg.corr_mlp_out, dtype=BF)
    p1 = jax_param_tree(fc1, jnp.zeros((1, p * p)), seed=8, std=(p * p) ** -0.5)
    p2 = jax_param_tree(fc2, jnp.zeros((1, cfg.corr_mlp_hidden)), seed=9,
                        std=cfg.corr_mlp_hidden ** -0.5)

    def reference(nb, sp):
        vol = jnp.einsum("tnpc,nqc->tnpq", nb, sp,
                         preferred_element_type=jnp.float32) / np.sqrt(c)
        h = nn.gelu(fc1.apply(p1, vol.reshape(nb.shape[0], -1, p * p)), approximate=True)
        return fc2.apply(p2, h)

    model = tct.CoTracker3Offline(cfg)
    model.corr_mlp_fc1.load_state_dict(torch_state_dict_from_flax(p1["params"]), strict=True)
    model.corr_mlp_fc2.load_state_dict(torch_state_dict_from_flax(p2["params"]), strict=True)
    ref = _eager(reference, neigh[0], support[0])
    with torch.no_grad():
        got = model.corr_embedding(neigh_t, support_t)[0]
    assert got.dtype == torch.bfloat16
    _assert_bits(_f32(got), ref)


# -- the gate's power: one rounding where the reference rounds twice fails it --


def _once_gelu(xt):
    return F.gelu(xt.float(), approximate="tanh").to(torch.bfloat16)


def _once_pool(xt):
    return F.avg_pool2d(xt.float(), 2).to(torch.bfloat16)


class _F32LogitsAttention(tct.Attention):
    """The attention with its logits summed and kept in f32 (not rounded to
    bf16 before the division), for the gate's power."""

    def forward(self, x, context=None):
        h, hd = self.num_heads, self.dim // self.num_heads
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        q, k, v = (t.reshape(*t.shape[:-1], h, hd).transpose(-2, -3) for t in (q, k, v))
        att = torch.matmul(q.float(), k.float().transpose(-1, -2)) / hd ** 0.5
        out = torch.matmul(torch.softmax(att, dim=-1).to(v.dtype), v)
        return self.to_out(out.transpose(-2, -3).reshape(*x.shape[:-1], self.dim))


@pytest.mark.parametrize("case", ["gelu", "avg_pool", "dense_fused_bias", "conv_fused_bias",
                                  "attention_f32_logits"])
def test_gate_rejects_single_rounding(case):
    rng = np.random.default_rng(10)
    if case == "gelu":
        x, xt = _bf16(rng.normal(0, 2, (64, 33, 96)))
        ref = _eager(lambda v: nn.gelu(v, approximate=True), x)
        got = _once_gelu(xt)
    elif case == "avg_pool":
        x, xt = _bf16(rng.normal(0, 2, (4, 40, 56, 96)))
        ref = _eager(lambda v: nn.avg_pool(v, (2, 2), strides=(2, 2), padding="VALID"), x)
        got = _once_pool(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    elif case == "dense_fused_bias":
        jm, params, tm = _dense(256, 768, seed=11)
        params["params"]["bias"] = rng.normal(0, 1, 768).astype(np.float32)
        x, xt = _bf16(rng.normal(0, 1, (8, 48, 256)))
        ref = _eager(lambda v: jm.apply(params, v), x)
        bias = torch.from_numpy(params["params"]["bias"])
        got = (F.linear(xt.float(), tm.weight.detach().to(torch.bfloat16).float())
               + bias.to(torch.bfloat16).float()).to(torch.bfloat16)
    elif case == "attention_f32_logits":
        jm = jct.Attention(256, 8, dtype=BF)
        params = jax_param_tree(jm, jnp.zeros((16, 8, 256)), seed=6, std=1 / 16)
        tm = _F32LogitsAttention(256, 8, torch.bfloat16)
        tm.load_state_dict(torch_state_dict_from_flax(params["params"]), strict=True)
        x, xt = _bf16(rng.normal(0, 1, (16, 8, 256)))
        ref = _eager(lambda v: jm.apply(params, v), x)
        got = tm(xt)
    else:
        jm, params, tm = _conv(48, 72, 3, 1, seed=12)
        params["params"]["bias"] = rng.normal(0, 1, 72).astype(np.float32)
        x, xt = _bf16(rng.normal(0, 1, (2, 40, 56, 48)))
        ref = _eager(lambda v: jm.apply(params, v), x)
        bias = torch.from_numpy(params["params"]["bias"]).to(torch.bfloat16).float()
        got = F.conv2d(xt.permute(0, 3, 1, 2).float(),
                       tm.weight.detach().to(torch.bfloat16).float(), bias, 1, 1)
        got = got.to(torch.bfloat16).permute(0, 2, 3, 1)
    assert not _bits_agree(_f32(got), ref)
