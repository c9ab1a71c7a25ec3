"""The arithmetic of the f32 kernels' 3xTF32 products (`csrc/f32_ops.cu`),
modelled in plain torch on the CPU: how close the split products come to
f32, and that one TF32 product would not.

Each f32 operand x is split into two TF32 values (10 explicit mantissa
bits), both rounded to nearest with ties away from zero (`cvt.rna.tf32.f32`):
hi = rna(x), lo = rna(x - hi). A product is a_lo b_hi + a_hi b_lo + a_hi
b_hi, each term exact in f32 (11 x 11 significant bits) and summed in f32,
which is what the tensor cores do with TF32 operands and f32 accumulators.
Here `rna_tf32` works on the int32 bits, and the f32 matmuls of the CPU
stand in for the accumulation.

Bounds, per output row against an f64 product, as max |err| / max |ref|:
the split stays under SPLIT_TOL = 1e-5 (10x inside the card's F32_TOL of
1e-4) at the encoder's K and at a 256-key and a 4096-key attention row
block; one TF32 product a term misses F32_TOL at the same sizes, so the
test tells the two apart.
"""
import numpy as np
import pytest
import torch

F32_TOL = 1e-4
SPLIT_TOL = 1e-5


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (ties away from zero), as f32: add half
    of the last kept bit to the magnitude bits and clear the 13 dropped
    ones (finite inputs; a carry into the exponent is the right result)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: three TF32 products in f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with one TF32 product a term."""
    return rna_tf32(a) @ rna_tf32(b)


def attend(q, k, v, scale, mm):
    """softmax(q k^T * scale) v with both products through `mm` and the
    softmax in f32, as the attention kernel runs it (one row block)."""
    s = mm(q, k.t().contiguous()) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(p, v) / p.sum(-1, keepdim=True)


def row_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    d = (out.double() - ref).abs().amax(-1)
    return (d / ref.abs().amax(-1)).max().item()


def _randn(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("x,want", [(1.0, 1.0), (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),
                                    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
                                    (1.0 + 2.0 ** -12, 1.0), (3.0 * 2.0 ** -20, 3.0 * 2.0 ** -20),
                                    (2.0 - 2.0 ** -12, 2.0), (0.0, 0.0)])
def test_rna_tf32_rounds_to_nearest_ties_away(x, want):
    got = rna_tf32(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert (got.view(torch.int32) & 0x1FFF).item() == 0


def test_split_keeps_22_bits():
    x = _randn(np.random.default_rng(0), (100000,), 10.0)
    hi, lo = split_tf32(x)
    assert ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).eq(0).all()
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert (resid <= 2.0 ** -22 * x.double().abs()).all()
    # the high part alone misses by up to half a TF32 ulp
    assert ((x.double() - hi.double()).abs() / x.double().abs()).max() > 2.0 ** -13


@pytest.mark.parametrize("k", [144, 576, 4608])
def test_split_matmul_row_error(k):
    """The encoder's products: A (M, K) against W (N, K) at its K."""
    rng = np.random.default_rng(k)
    a = _randn(rng, (64, k))
    w = _randn(rng, (144, k), k ** -0.5)
    ref = a.double() @ w.double().t()
    assert row_err(mm_3xtf32(a, w.t().contiguous()), ref) < SPLIT_TOL
    assert row_err(mm_tf32(a, w.t().contiguous()), ref) > F32_TOL


@pytest.mark.parametrize("keys", [256, 4096])
def test_split_attention_row_error(keys):
    """A 64-row block of the encoder's attention (D = 72): a stage-3 window
    of 256 keys and a global block of 4096."""
    rng = np.random.default_rng(keys)
    d = 72
    q, k, v = _randn(rng, (64, d)), _randn(rng, (keys, d)), _randn(rng, (keys, d))
    scale = d ** -0.5
    s = (q.double() @ k.double().t()) * scale
    p = torch.softmax(s, -1)
    ref = p @ v.double()
    assert row_err(attend(q, k, v, scale, mm_3xtf32), ref) < SPLIT_TOL
    assert row_err(attend(q, k, v, scale, mm_tf32), ref) > F32_TOL
