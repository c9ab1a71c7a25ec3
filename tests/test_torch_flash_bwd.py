"""The flash-attention backward of the port against the JAX package's, on
the CPU in f32: `flash_attention_bwd_reference` (the plain backward the card
kernel `csrc/flash_attention_bwd.cu` is held to) and autograd through the
port's CPU `flash_attention`, both against `jax.vjp` of
`rga3_tpu.ops.attention.flash_attention` (its `mha_reference` route on the
CPU), within 1e-5 of each gradient's max. Every row of these cases has a
valid key."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rga3_tpu.ops import attention as ja
from rga3_tpu_torch.ops import attention as ta

TOL = 1e-5

# (b, lq, lk, h, hkv, d, causal, right_padding)
CASES = [
    (2, 40, 40, 4, 4, 16, True, False),
    (2, 40, 40, 7, 1, 16, False, False),
    (2, 48, 48, 14, 2, 128, True, True),  # the LM's: GQA rep 7, causal, padding
    (1, 33, 33, 2, 2, 128, False, True),
    (2, 64, 7, 8, 8, 16, False, False),  # the decoder's image->token: lk = 7
    (1, 20, 3, 7, 1, 128, False, False),
]


def _inputs(b, lq, lk, h, hkv, d, padding, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    seg = None
    if padding:  # the collate's attention mask: 1 on the text, 0 on the pads
        seg = np.zeros((b, lq), np.int32)
        for i, n in enumerate(rng.integers(lq // 2, lq, b)):
            seg[i, :n] = 1
    return q, k, v, do, seg


def _jax_grads(q, k, v, do, seg, causal):
    kw = dict(causal=causal, segment_ids=None if seg is None else jnp.asarray(seg))
    out, vjp = jax.vjp(lambda q_, k_, v_: ja.flash_attention(q_, k_, v_, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,padding", CASES)
def test_flash_backward_matches_jax(b, lq, lk, h, hkv, d, causal, padding):
    q, k, v, do, seg = _inputs(b, lq, lk, h, hkv, d, padding, seed=lq + h + d)
    jout, jgrads = _jax_grads(q, k, v, do, seg, causal)
    kw = dict(causal=causal, segment_ids=None if seg is None else torch.from_numpy(seg))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ta.flash_attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(do))
    _close(out, jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want)
    with torch.no_grad():
        o, lse = ta.mha_reference(tq, tk, tv, **kw, return_lse=True)
        plain = ta.flash_attention_bwd_reference(tq, tk, tv, o, lse, torch.from_numpy(do), **kw)
        # the wrapper computes the plain backward for CPU tensors, launching nothing
        n = ta.flash_attention_bwd.launches
        wrapped = ta.flash_attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(do), **kw)
        assert ta.flash_attention_bwd.launches == n
    for got, alt, want in zip(plain, wrapped, jgrads):
        _close(got, want)
        assert torch.equal(got, alt)


def test_lse_is_the_rows_log_sum_exp():
    q, k, v, _, seg = _inputs(2, 24, 24, 4, 2, 16, True, seed=3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = ta.mha_reference(tq, tk, tv, causal=True, segment_ids=torch.from_numpy(seg),
                              return_lse=True)
    kr = np.repeat(k, 2, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) / 4.0
    allowed = np.tril(np.ones((24, 24), bool))[None, None] & (
        seg[:, None, :, None] == seg[:, None, None, :])
    s = np.where(allowed, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_causal_backward_needs_equal_lengths():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(NotImplementedError):
        ta.flash_attention_bwd(q, k, k, q, torch.zeros(1, 2, 8), q, causal=True)
