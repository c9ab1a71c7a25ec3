"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker `cuda`; they skip without one). This file imports nothing of
JAX, so that it runs on a machine without it:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

Inputs are bf16 on both sides; the bound is per output row (b, token,
head): max_d |kernel - plain| <= 2e-2 * max_d |plain|, on rows that have at
least one valid key. bf16 outputs with f32 accumulation in both put a right
kernel about one bf16 ulp (2^-7) of the row's largest value away; a kernel
that skipped keys or tiles is off by the order of the row itself.
"""
import numpy as np
import pytest
import torch

from rga3_tpu_torch.ops import attention as tatt

TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, torch.bfloat16)


def _rel_err(out, ref, rows=None):
    """max over rows of max_d |out - ref| / max_d |ref|."""
    d = (out.float() - ref.float()).abs().amax(-1)
    m = ref.float().abs().amax(-1).clamp_min(1e-6)
    r = d / m
    if rows is not None:
        r = r[:, rows]
    return r.max().item()


# (b, l, h, hkv, d): GQA rep 1, 2, 7; every head dim the kernel takes;
# lengths off the 64-row tile
FLASH_CASES = [
    (1, 100, 2, 2, 16), (2, 130, 4, 2, 72), (1, 77, 7, 1, 80),
    (2, 190, 4, 4, 72), (1, 333, 16, 16, 80), (1, 200, 28, 4, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,hkv,d", FLASH_CASES)
def test_flash_causal_segments(dev, b, l, h, hkv, d):
    rng = np.random.default_rng(d)
    q = _bf16(rng, (b, l, h, d), dev)
    k = _bf16(rng, (b, l, hkv, d), dev)
    v = _bf16(rng, (b, l, hkv, d), dev)
    seg = torch.from_numpy(np.sort(rng.integers(0, 3, (b, l)), axis=1)).to(dev)
    tatt.reset_launches()
    out = tatt.flash_attention(q, k, v, causal=True, segment_ids=seg)
    tatt.flash_attention(q, k, v, causal=True, segment_ids=seg)
    assert tatt.flash_attention.launches == 2
    [(key, (count, segs))] = tatt.flash_attention.shapes.items()
    assert key[:2] == ((b, l, h, d), q.stride()) and key[5] is True and count == 2
    assert torch.equal(segs[0], seg.int()) and torch.equal(segs[1], seg.int())
    ref = tatt.mha_reference(q, k, v, causal=True, segment_ids=seg)
    assert _rel_err(out, ref) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,d", [(4096, 9, 16), (300, 70, 80), (65, 1, 72)])
def test_flash_cross_attention(dev, lq, lk, d):
    rng = np.random.default_rng(lq)
    q = _bf16(rng, (2, lq, 4, d), dev)
    k = _bf16(rng, (2, lk, 4, d), dev)
    v = _bf16(rng, (2, lk, 4, d), dev)
    out = tatt.flash_attention(q, k, v)
    assert _rel_err(out, tatt.mha_reference(q, k, v)) < TOL


@pytest.mark.cuda
def test_flash_block_skipping_and_rows_without_keys(dev):
    """Segments in contiguous runs (the ViT's grids): kv tiles outside a q
    tile's range are skipped; a q segment absent from kv gives finite rows
    (zero or a mean of V), and every other row matches."""
    rng = np.random.default_rng(3)
    l = 700
    q, k, v = (_bf16(rng, (1, l, 4, 80), dev) for _ in range(3))
    qs = torch.from_numpy(np.repeat(np.arange(5), 140)[None].astype(np.int32)).to(dev)
    ks = qs.clone()
    ks[ks == 4] = 3  # segment 4 has no keys
    out = tatt.flash_attention(q, k, v, segment_ids=qs, kv_segment_ids=ks)
    ref = tatt.mha_reference(q, k, v, segment_ids=qs, kv_segment_ids=ks)
    valid = (qs[0] != 4).cpu()
    assert torch.isfinite(out).all()
    assert _rel_err(out, ref, rows=valid) < TOL


@pytest.mark.cuda
def test_flash_strided_inputs(dev):
    """q, k, v as views of one packed tensor (no copies)."""
    rng = np.random.default_rng(4)
    qkv = _bf16(rng, (2, 257, 3, 8, 72), dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = tatt.flash_attention(q, k, v)
    assert _rel_err(out, tatt.mha_reference(q, k, v)) < TOL


@pytest.mark.cuda
def test_flash_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 64, 2, 16, device=dev)  # f32
    with pytest.raises(TypeError):
        tatt.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 2, 24, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tatt.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("window,l,h", [(16, 1024, 4), (64, 4096, 2), (256, 1024, 8),
                                        (512, 1024, 2)])
def test_window_matches_plain(dev, window, l, h):
    rng = np.random.default_rng(window)
    qkv = _bf16(rng, (2, l, 3, h, 72), dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    tatt.reset_launches()
    out = tatt.window_attention(q, k, v, window)
    assert tatt.window_attention.launches == 1
    [(key, (count, _))] = tatt.window_attention.shapes.items()
    assert key[:5] == ((2, l, h, 72), q.stride(), k.stride(), v.stride(), window)
    assert key[5] == pytest.approx(72 ** -0.5)
    assert count == 1
    ref = tatt.window_reference(q, k, v, window, 72 ** -0.5)
    assert _rel_err(out, ref) < TOL


@pytest.mark.cuda
def test_window_rejects_unsupported_windows(dev):
    q = torch.zeros(1, 96, 2, 72, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tatt.window_attention(q, q, q, 48)
