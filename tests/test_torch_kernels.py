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
    assert len(segs) == 2  # every launch's (q, kv) segment ids
    assert all(torch.equal(qs, seg.int()) and torch.equal(ks, seg.int()) for qs, ks in segs)
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
    q = torch.zeros(1, 64, 2, 16, device=dev, dtype=torch.float16)  # neither bf16 nor f32
    with pytest.raises(TypeError):
        tatt.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 2, 16, device=dev)  # f32: the f32 forward takes no mask
    with pytest.raises(ValueError):
        tatt.flash_attention(q, q, q, causal=True)
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


# ---- head dim 256: the SAM2 tracker's memory attention ----------------------


def _bank_segments(dev, frames_valid, ptr_valid, ltok=4096, ptr_tokens=4):
    """kv segment ids (validity) of the tracker's static bank: 7 frame
    slots of `ltok` keys, then the pointers' tokens; one row per list."""
    rows = []
    for fv, pv in zip(frames_valid, ptr_valid):
        rows.append(np.concatenate([np.repeat(np.asarray(fv, np.int32), ltok),
                                    np.repeat(np.asarray(pv, np.int32), ptr_tokens)]))
    return torch.from_numpy(np.stack(rows)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(300, 4161), (4096, 4096), (65, 1000)])
def test_flash_head_dim_256_ragged_keys(dev, lq, lk):
    """D = 256 with lengths off the 64-key tile, with and without the
    all-ones segment ids of the memory self-attention."""
    rng = np.random.default_rng(lk)
    q = _bf16(rng, (2, lq, 1, 256), dev)
    k, v = (_bf16(rng, (2, lk, 1, 256), dev) for _ in range(2))
    ref = tatt.mha_reference(q, k, v, scale=1 / 16)
    assert _rel_err(tatt.flash_attention(q, k, v, scale=1 / 16), ref) < TOL
    ones_q = torch.ones(2, lq, dtype=torch.int32, device=dev)
    ones_k = torch.ones(2, lk, dtype=torch.int32, device=dev)
    out = tatt.flash_attention(q, k, v, segment_ids=ones_q, kv_segment_ids=ones_k, scale=1 / 16)
    assert _rel_err(out, ref) < TOL


# (valid frame slots, valid pointers) of each of the two batch rows
BANKS = {
    "frame1": ([[1, 0, 0, 0, 0, 0, 0]] * 2, [[1] + [0] * 15] * 2),
    "half": ([[1, 0, 1, 0, 1, 0, 1], [1, 1, 0, 0, 0, 1, 1]], [[1, 0] * 8, [1] * 9 + [0] * 7]),
    "full": ([[1] * 7] * 2, [[1] * 16] * 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("bank", list(BANKS))
def test_flash_head_dim_256_memory_bank(dev, bank):
    """The tracker's cross-attention: 4096 queries against the 28736-key
    bank, kv segment ids its validity; whole invalid frames are skipped tile
    by tile, the pointer tile is masked per key. Two launches at one shape
    with other banks are recorded with each launch's segment ids."""
    rng = np.random.default_rng(len(bank))
    lq, lk = 4096, 7 * 4096 + 64
    q = _bf16(rng, (2, lq, 1, 256), dev)
    k, v = (_bf16(rng, (2, lk, 1, 256), dev) for _ in range(2))
    qs = torch.ones(2, lq, dtype=torch.int32, device=dev)
    ks = _bank_segments(dev, *BANKS[bank])
    tatt.reset_launches()
    out = tatt.flash_attention(q, k, v, segment_ids=qs, kv_segment_ids=ks, scale=1 / 16)
    full = _bank_segments(dev, *BANKS["full"])
    tatt.flash_attention(q, k, v, segment_ids=qs, kv_segment_ids=full, scale=1 / 16)
    [(key, (count, segs))] = tatt.flash_attention.shapes.items()
    assert count == 2 and torch.equal(segs[0][1], ks) and torch.equal(segs[1][1], full)
    ref = tatt.mha_reference(q, k, v, segment_ids=qs, kv_segment_ids=ks, scale=1 / 16)
    assert torch.isfinite(out).all() and _rel_err(out, ref) < TOL


@pytest.mark.cuda
def test_flash_segment_record_is_bounded(dev):
    """The wrapper keeps the segment ids of a call's first SEGMENT_RECORDS
    launches and counts every launch: a long track holds a bounded record."""
    rng = np.random.default_rng(10)
    q = _bf16(rng, (1, 64, 1, 256), dev)
    seg = torch.ones(1, 64, dtype=torch.int32, device=dev)
    tatt.reset_launches()
    n = tatt.SEGMENT_RECORDS + 3
    for _ in range(n):
        tatt.flash_attention(q, q, q, segment_ids=seg, kv_segment_ids=seg)
    [(_, (count, segs))] = tatt.flash_attention.shapes.items()
    assert count == n and len(segs) == tatt.SEGMENT_RECORDS


@pytest.mark.cuda
def test_flash_head_dim_256_rows_without_keys_are_zero(dev):
    """A batch row whose bank has no valid key visits no kv tile and gives
    zeros (the Pallas kernel's rule; the plain version gives mean(V)); the
    other row, one valid frame, matches the plain version."""
    rng = np.random.default_rng(8)
    lq, lk = 1024, 7 * 1024 + 64
    q = _bf16(rng, (2, lq, 1, 256), dev)
    k, v = (_bf16(rng, (2, lk, 1, 256), dev) for _ in range(2))
    qs = torch.ones(2, lq, dtype=torch.int32, device=dev)
    ks = _bank_segments(dev, [[0, 0, 0, 1, 0, 0, 0], [0] * 7], [[0] * 16] * 2, ltok=1024)
    out = tatt.flash_attention(q, k, v, segment_ids=qs, kv_segment_ids=ks, scale=1 / 16)
    ref = tatt.mha_reference(q, k, v, segment_ids=qs, kv_segment_ids=ks, scale=1 / 16)
    assert torch.all(out[1] == 0)
    assert _rel_err(out[:1], ref[:1]) < TOL


@pytest.mark.cuda
def test_flash_backward_refuses_head_dim_256(dev):
    """No backward kernel at D = 256 (the tracker does not train): the
    backward raises, and so does a forward that would need it, before any
    launch."""
    rng = np.random.default_rng(9)
    q, k, v, o, do = (_bf16(rng, (1, 128, 1, 256), dev) for _ in range(5))
    lse = torch.zeros(1, 1, 128, device=dev)
    tatt.reset_launches()
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_attention_bwd(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="backward"):
        tatt.flash_attention(q.requires_grad_(), k, v)
    assert tatt.flash_attention.launches == 0 and tatt.flash_attention_bwd.launches == 0
    with torch.no_grad():
        tatt.flash_attention(q, k, v)
    assert tatt.flash_attention.launches == 1


# ---- the tensor-core forward tiles (csrc/attention_mma.cuh) ----------------


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 72, 80, 128, 256])
def test_flash_lse_matches_plain(dev, d):
    """The forward's log-sum-exp (the backward's residual) against the plain
    one, causal with segments and GQA: within 1e-2 on rows with a key; -inf
    (and a zero output) on the rows of a q tile whose segment no kv tile
    holds, which visits no tile. q tile 3 (rows 192-255) is segment 7, absent
    from the kv segments; rows 256-319 attend to keys 192-255 (segment 2)."""
    rng = np.random.default_rng(d + 1)
    b, l, h, hkv = 2, 320, 4, 2
    q = _bf16(rng, (b, l, h, d), dev)
    k = _bf16(rng, (b, l, hkv, d), dev)
    v = _bf16(rng, (b, l, hkv, d), dev)
    qs = np.empty((b, l), np.int32)
    qs[:, :192] = np.sort(rng.integers(0, 3, (b, 192)), axis=1)
    qs[:, 192:256], qs[:, 256:] = 7, 2
    ks = qs.copy()
    ks[:, 192:256] = 2
    qs, ks = torch.from_numpy(qs).to(dev), torch.from_numpy(ks).to(dev)
    out, lse = tatt._flash_forward(q, k, v, *tatt._segments(q, b, l, l, qs, ks), True,
                                   d ** -0.5, with_lse=True)
    kw = dict(causal=True, segment_ids=qs, kv_segment_ids=ks)
    ref, lse_ref = tatt.mha_reference(q, k, v, **kw, return_lse=True)
    allowed = tatt._allowed(b, l, l, dev, True, qs, ks)[:, 0]
    has_key = allowed.any(-1)  # (B, L)
    assert lse.shape == (b, h, l) and lse.dtype == torch.float32
    rows = has_key[:, None, :].expand(b, h, l)
    assert (lse - lse_ref)[rows].abs().max().item() < 1e-2
    unvisited = torch.zeros(l, dtype=torch.bool, device=dev)
    unvisited[192:256] = True
    assert not has_key[:, unvisited].any()
    assert torch.all(lse[:, :, unvisited] == -torch.inf)
    assert torch.all(out[:, unvisited] == 0)
    assert _row_err(out, ref, has_key) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,h", [(1, 4), (63, 4), (65, 4), (4784, 16)])
def test_flash_lengths(dev, l, h, causal):
    """Lengths off and around the 64-row tiles at D = 80, up to the ViT's
    4784 patches with its 16 heads."""
    rng = np.random.default_rng(l)
    q, k, v = (_bf16(rng, (1, l, h, 80), dev) for _ in range(3))
    out = tatt.flash_attention(q, k, v, causal=causal)
    ref = tatt.mha_reference(q, k, v, causal=causal)
    assert torch.isfinite(out).all() and _rel_err(out, ref) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("window,q_window,n_windows", [
    (16, 16, 81), (16, 4, 81), (64, 64, 17), (64, 16, 17), (256, 256, 5), (256, 64, 5)])
def test_window_pairs_match_plain(dev, window, q_window, n_windows):
    """Every window / q_window pair of Hiera-L's blocks at D = 72, k and v
    views of a packed kv, with query counts off the 64-row block where the
    pair allows (81 windows of 16 and 17 of 64)."""
    rng = np.random.default_rng(window + q_window)
    b, h, lk = 2, 4, window * n_windows
    kv = _bf16(rng, (b, lk, 2, h, 72), dev)
    k, v = kv[:, :, 0], kv[:, :, 1]
    q = _bf16(rng, (b, n_windows * q_window, h, 72), dev)
    out = tatt.window_attention(q, k, v, window, q_window=q_window)
    ref = tatt.window_reference(q, k, v, window, 72 ** -0.5, q_window=q_window)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert _rel_err(out, ref) < TOL


@pytest.mark.cuda
def test_attention_rejects_unaligned_rows(dev):
    """The kernels copy 16-byte rows: an offset view or a stride that is not
    a multiple of 8 elements raises before any launch."""
    rng = np.random.default_rng(11)
    flat = _bf16(rng, (1 + 64 * 2 * 72,), dev)
    off = flat[1:].view(1, 64, 2, 72)  # data pointer 2 bytes past alignment
    wide = _bf16(rng, (1, 64, 2, 76), dev)[..., :72]  # head stride 76
    good = _bf16(rng, (1, 64, 2, 72), dev)
    tatt.reset_launches()
    for bad in (off, wide):
        with pytest.raises(ValueError, match="16-byte"):
            tatt.flash_attention(bad, good, good)
        with pytest.raises(ValueError, match="16-byte"):
            tatt.flash_attention(good, bad, good)
        with pytest.raises(ValueError, match="16-byte"):
            tatt.window_attention(good, good, bad, 16)
    assert tatt.flash_attention.launches == tatt.window_attention.launches == 0


# ---- the fused-block kernels (ops/fused_block.py) ---------------------------

def _linear_params(rng, n, k, dev):
    w = _bf16(rng, (n, k), dev) * (k ** -0.5)
    return w.contiguous(), _bf16(rng, (n,), dev) * 0.1


# (m, n, k): K = 144 (9*16, not a multiple of 32, a ragged 64-deep TMA
# step), N not a power of two, M off the 128-row tile; the widest K and N of
# Hiera-L; the four stage-3 products (M = 32768) the main path launches most;
# N = 144 and 432, whole tiles of the 144-wide tile; N = 150, even but not a
# multiple of 8 (the output leaves in pairs, not 16-byte pieces)
GEMM_SHAPES = [(300, 432, 144), (1000, 144, 288), (257, 1728, 576), (130, 4608, 1152),
               (128, 1152, 4608), (32768, 2304, 576), (32768, 576, 2304),
               (32768, 1728, 576), (32768, 576, 576), (1000, 144, 144), (200, 150, 144)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
@pytest.mark.parametrize("epilogue", ["bias", "gelu_tanh", "gelu_erf", "res_bf16", "res_f32"])
def test_gemm_matches_plain(dev, m, n, k, epilogue):
    from rga3_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(m + n + k)
    a = _bf16(rng, (m, k), dev)
    w, bias = _linear_params(rng, n, k, dev)
    res = _bf16(rng, (m, n), dev) if epilogue.startswith("res") else None
    tatt.reset_launches()
    out = fb.gemm(a, w, bias, epilogue=epilogue, residual=res)
    assert fb.gemm.launches == 1
    ref = fb.gemm_reference(a, w, bias, epilogue=epilogue, residual=res)
    assert out.shape == ref.shape == (m, n) and torch.isfinite(out).all()
    assert _rel_err(out, ref) < TOL


@pytest.mark.cuda
def test_gemm_beyond_the_old_grid_limit(dev):
    """More rows than 65535 tiles of 128: the persistent grid walks them
    all."""
    from rga3_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(12)
    m, n, k = 65535 * 128 + 72, 16, 16
    a = _bf16(rng, (m, k), dev)
    w, bias = _linear_params(rng, n, k, dev)
    out = fb.gemm(a, w, bias)
    ref = fb.gemm_reference(a, w, bias)
    assert out.shape == (m, n) and torch.isfinite(out).all()
    assert _rel_err(out, ref) < TOL


@pytest.mark.cuda
def test_gemm_rejects_unaligned_pointers(dev):
    """TMA reads 16-byte aligned rows: an offset view of a, w or the
    residual raises ValueError before any launch."""
    from rga3_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(13)
    m, n, k = 64, 48, 32
    a = _bf16(rng, (m, k), dev)
    w, bias = _linear_params(rng, n, k, dev)
    res = _bf16(rng, (m, n), dev)

    def offset(t):  # the same values, 2 bytes past 16-byte alignment
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    tatt.reset_launches()
    for args in ((offset(a), w, res), (a, offset(w), res), (a, w, offset(res))):
        with pytest.raises(ValueError, match="16-byte"):
            fb.gemm(args[0], args[1], bias, epilogue="res_bf16", residual=args[2])
    assert fb.gemm.launches == 0
    out = fb.gemm(a, w, bias, epilogue="res_bf16", residual=res)
    assert _rel_err(out, fb.gemm_reference(a, w, bias, epilogue="res_bf16", residual=res)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(100, 64), (8192, 1152), (37, 144)])
def test_layer_norm_matches_plain(dev, rows, d):
    from rga3_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(d)
    x = _bf16(rng, (rows, d), dev) * 3 + 1
    g, b = 1 + 0.1 * _bf16(rng, (d,), dev), 0.1 * _bf16(rng, (d,), dev)
    out = fb.layer_norm(x, g, b, 1e-6)
    assert _rel_err(out, fb.layer_norm_reference(x, g, b, 1e-6)) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("ws,c", [(8, 288), (4, 576), (16, 1152)])
def test_window_pool_matches_plain(dev, ws, c):
    """Exact: a max of bf16 values. The input is the q slice of a packed qkv."""
    from rga3_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(ws)
    qkv = _bf16(rng, (2, 4 * ws * ws, 3 * c), dev)
    q = qkv[:, :, :c]
    out = fb.window_pool2x2(q, ws)
    assert torch.equal(out, fb.window_pool2x2_reference(q, ws))


@pytest.mark.cuda
@pytest.mark.parametrize("window,h", [(16, 8), (64, 4), (256, 16)])
def test_window_pooled_queries_match_plain(dev, window, h):
    """The transition block's attention: q windows of window / 4 = 4/16/64."""
    rng = np.random.default_rng(window + 1)
    lk = 4096
    kv = _bf16(rng, (2, lk, 3, h, 72), dev)
    q = _bf16(rng, (2, lk // 4, h, 72), dev)
    k, v = kv[:, :, 1], kv[:, :, 2]
    out = tatt.window_attention(q, k, v, window, q_window=window // 4)
    ref = tatt.window_reference(q, k, v, window, 72 ** -0.5, q_window=window // 4)
    assert _rel_err(out, ref) < TOL


def _block_params(rng, c_in, d, f, dev, transition=False):
    p = {"ln1_g": 1 + 0.1 * _bf16(rng, (c_in,), dev), "ln1_b": 0.1 * _bf16(rng, (c_in,), dev),
         "ln2_g": 1 + 0.1 * _bf16(rng, (d,), dev), "ln2_b": 0.1 * _bf16(rng, (d,), dev)}
    p["wqkv"], p["bqkv"] = _linear_params(rng, 3 * d, c_in, dev)
    p["wproj"], p["bproj"] = _linear_params(rng, d, c_in, dev)
    if transition:
        p["wattn"], p["battn"] = _linear_params(rng, d, d, dev)
    p["w1"], p["b1"] = _linear_params(rng, f, d, dev)
    p["w2"], p["b2"] = _linear_params(rng, d, f, dev)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("kind,d,h,window", [
    ("window", 144, 2, 64), ("window", 288, 4, 16), ("window", 576, 8, 256),
    ("split", 1152, 16, 64), ("global", 576, 8, 0)])
def test_fused_blocks_match_plain(dev, kind, d, h, window):
    from rga3_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(d)
    x = _bf16(rng, (2, 1024, d), dev)
    p = _block_params(rng, d, d, 4 * d, dev)
    tatt.reset_launches()
    if kind == "global":
        out = fb.fused_global_block(x, p, num_heads=h)
        ref = fb.reference_global_block(x, p, num_heads=h)
    else:
        wrapper = fb.fused_window_block_split if kind == "split" else fb.fused_window_block
        out = wrapper(x, p, num_heads=h, window=window)
        ref = fb.reference_block(x, p, num_heads=h, window=window, split=kind == "split")
    assert torch.isfinite(out).all() and _rel_err(out, ref) < TOL
    # rows 4-7 are launched on their own by the global and split blocks only,
    # as in the JAX package; every block runs two LayerNorms and four products
    rows = {"window": (0, 0, 0, 0), "global": (1, 1, 0, 0), "split": (1, 0, 1, 1)}[kind]
    assert (fb.ln_qkv.launches, fb.proj_mlp.launches, fb.proj_ln.launches,
            fb.mlp_blocked.launches) == rows
    assert (fb.layer_norm.launches, fb.gemm.launches) == (2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,ws,h", [(144, 8, 4), (288, 4, 8), (576, 16, 16)])
def test_transition_block_matches_plain(dev, c_in, ws, h):
    from rga3_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(c_in)
    d = 2 * c_in
    x = _bf16(rng, (2, 4 * ws * ws, c_in), dev)
    p = _block_params(rng, c_in, d, 4 * d, dev, transition=True)
    tatt.reset_launches()
    out = fb.fused_transition_block(x, p, num_heads=h, ws=ws)
    ref = fb.reference_transition(x, p, num_heads=h, ws=ws)
    assert out.shape == (2, ws * ws, d) and _rel_err(out, ref) < TOL
    # LN1 once for both products, the pool on the shortcut and on q; no
    # row 4-7 wrapper of its own
    assert (fb.layer_norm.launches, fb.gemm.launches, fb.window_pool2x2.launches) == (2, 5, 2)
    assert fb.ln_qkv.launches == fb.proj_mlp.launches == 0


@pytest.mark.cuda
def test_fused_kernels_reject_what_they_do_not_take(dev):
    from rga3_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(5)
    w, bias = _linear_params(rng, 64, 12, dev)
    with pytest.raises(ValueError):  # K not a multiple of 8
        fb.gemm(_bf16(rng, (16, 12), dev), w, bias)
    w, bias = _linear_params(rng, 64, 32, dev)
    with pytest.raises(TypeError):  # f32 input
        fb.gemm(torch.zeros(16, 32, device=dev), w, bias)
    with pytest.raises(ValueError):  # non-contiguous input
        fb.gemm(_bf16(rng, (32, 16), dev).t(), w, bias)
    with pytest.raises(ValueError):  # a residual epilogue without its residual's shape
        fb.gemm(_bf16(rng, (16, 32), dev), w, bias, epilogue="res_bf16",
                residual=_bf16(rng, (16, 32), dev))
    with pytest.raises(TypeError):  # an f32 bias
        fb.gemm(_bf16(rng, (16, 32), dev), w, bias.float())
    with pytest.raises(ValueError):  # odd window side
        fb.window_pool2x2(_bf16(rng, (1, 9, 16), dev), 3)
    g12 = torch.ones(12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # layer norm width not a multiple of 8
        fb.layer_norm(_bf16(rng, (4, 12), dev), g12, g12 - 1, 1e-6)
    with pytest.raises(TypeError):  # f32 gamma and beta
        fb.layer_norm(_bf16(rng, (4, 16), dev), torch.ones(16, device=dev),
                      torch.zeros(16, device=dev), 1e-6)
    q = _bf16(rng, (1, 32, 2, 72), dev)
    k = _bf16(rng, (1, 64, 2, 72), dev)
    with pytest.raises(ValueError):  # q windows neither window nor window / 4
        tatt.window_attention(q, k, k, 64, q_window=32)


# ---- the int4 dequant-matmul (csrc/int4_matmul.cu). A grid of M (<= 4 the
# decode tile, 5-8 two decode launches, > 8 the prefill tile, ragged at 17
# and 300), group-32 scales
# (64, 3584, 18944) and per-channel scales (96), out ragged against the
# 128-column tiles (200: the generic tile); then the Qwen2.5-VL-7B LM's
# projections: prefill at the tile's token boundaries (64, 128 rows), a
# chat prompt (1280) and a ragged batch of four (5111); decode with its
# split sum (out 512, 3584) and without (18944, the lm_head's 152064);
# per-channel scales with a stage half empty (in 96). Each case is launched
# twice and must give equal bits; a split call leaves the workspace's
# counters zero.
INT4_GRID = [(m, i, o) for m in (1, 4, 16, 17, 300) for i in (64, 96, 3584, 18944)
             for o in (200, 512, 3584)]
INT4_LM = [(m, i, o) for m in (5, 8, 64, 65, 128, 129, 300, 1280)
           for i, o in ((3584, 512), (3584, 3584), (18944, 3584))]
INT4_LM += [(5, 3584, 18944), (129, 3584, 18944), (1280, 3584, 18944),
            (5111, 3584, 18944), (5111, 18944, 3584)]
INT4_LM += [(m, i, o) for m in (1, 2, 3, 4)
            for i, o in ((3584, 512), (3584, 3584), (18944, 3584), (3584, 18944),
                         (3584, 152064))]
INT4_LM += [(m, 96, 256) for m in (1, 4, 5, 300)]


def _int4_weights(rng, in_dim, out, dev):
    from rga3_tpu_torch.ops import quant as tq

    w = torch.from_numpy((0.05 * rng.standard_normal((in_dim, out))).astype(np.float32))
    q, s = tq.quantize_int4(w)
    return q.to(dev), s.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m,in_dim,out", INT4_GRID + INT4_LM)
def test_int4_matmul_matches_plain(dev, m, in_dim, out):
    from rga3_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(m + in_dim + out)
    q, s = _int4_weights(rng, in_dim, out, dev)
    x = _bf16(rng, (m, in_dim), dev)
    tatt.reset_launches()
    y = tq.int4_matmul(x, q, s)
    y2 = tq.int4_matmul(x, q, s)
    torch.cuda.synchronize()
    per_call = 2 if tq.INT4_DECODE_ROWS < m <= 2 * tq.INT4_DECODE_ROWS else 1
    assert tq.int4_matmul.launches == 2 * per_call
    assert y.shape == (m, out) and y.dtype == torch.bfloat16
    assert torch.equal(y, y2)
    ref = tq.int4_matmul_reference(x, q, s)
    assert torch.isfinite(y).all() and _rel_err(y, ref) < TOL
    if tq.int4_splits(min(m, tq.INT4_DECODE_ROWS), in_dim, out) > 1:
        assert not tq._workspaces[y.device.index][:1024].any()
    if per_call == 2:  # the prefill tile at these M, one launch
        tile = tq.int4_matmul_launch(x, q, s)
        assert torch.isfinite(tile).all() and _rel_err(tile, ref) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("in_dim,out", [(3584, 512), (3584, 18944), (18944, 3584), (96, 256)])
def test_int4_matmul_rows_do_not_depend_on_m(dev, in_dim, out):
    """Up to M = 8 a row's bits are those of a one-row call (speculative
    decoding's verify relies on it)."""
    from rga3_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(in_dim + out)
    q, s = _int4_weights(rng, in_dim, out, dev)
    x = _bf16(rng, (8, in_dim), dev)
    ones = torch.cat([tq.int4_matmul(x[i:i + 1], q, s) for i in range(8)])
    for m in range(2, 9):
        assert torch.equal(tq.int4_matmul(x[:m], q, s), ones[:m]), m


@pytest.mark.cuda
def test_int4_matmul_rejects_what_it_does_not_take(dev):
    from rga3_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(9)
    q, s = _int4_weights(rng, 128, 64, dev)
    with pytest.raises(ValueError):  # odd input dim
        tq.int4_matmul(_bf16(rng, (2, 127), dev), q, s)
    with pytest.raises(TypeError):  # f32 x
        tq.int4_matmul(torch.zeros(2, 128, device=dev), q, s)
    with pytest.raises(TypeError):  # bf16 scales
        tq.int4_matmul(_bf16(rng, (2, 128), dev), q, s.bfloat16())
    with pytest.raises(ValueError):  # non-contiguous x
        tq.int4_matmul(_bf16(rng, (128, 4), dev).t(), q, s)
    with pytest.raises(ValueError):  # non-contiguous packed weight
        tq.int4_matmul(_bf16(rng, (2, 128), dev), q.t().contiguous().t(), s)


# ---- the flash backward (csrc/flash_attention_bwd.cu), through autograd of
# flash_attention and held against flash_attention_bwd_reference on the
# plain log-sum-exp. (b, lq, lk, h, hkv, d, causal, segments): the training
# slice's calls (the LM: B=2, L=512, 28/4 heads, D=128, causal, right
# padding in a segment of its own; the SAM decoder's image->token
# attention: lq=4096, lk=7, 8 heads, D=16) and small ones (lk < 16, GQA rep
# 2 and 7, D 72 / 80, lengths off the 64-row tile, segment runs).
FLASH_BWD_CASES = [
    (2, 512, 512, 28, 4, 128, True, "pad"),
    (8, 4096, 7, 8, 8, 16, False, None),
    (1, 100, 100, 2, 2, 16, True, "runs"),
    (2, 130, 130, 4, 2, 72, True, "runs"),
    (1, 77, 77, 7, 1, 80, False, "runs"),
    (2, 65, 9, 4, 4, 80, False, None),
    (1, 200, 200, 28, 4, 128, False, "pad"),
    (2, 190, 190, 4, 4, 72, False, None),
    # the decoder call as the train step makes it (Lk = 9: 9 of 64 kv rows);
    # causal q ranges split into four chunks (rep 1, segment runs); rep 7
    # with the q range split into four chunks
    (8, 4096, 9, 8, 8, 16, False, None),
    (1, 1024, 1024, 2, 2, 80, True, "runs"),
    (1, 1024, 77, 7, 1, 72, False, None),
]


def _segment_ids(rng, kind, b, l, dev):
    if kind is None:
        return None
    if kind == "pad":  # the collate's attention mask: 1 on the text, 0 on the pads
        seg = np.zeros((b, l), np.int32)
        for i, n in enumerate(rng.integers(l // 2, l, b)):
            seg[i, :n] = 1
        return torch.from_numpy(seg).to(dev)
    return torch.from_numpy(np.sort(rng.integers(0, 3, (b, l)), axis=1).astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,segs", FLASH_BWD_CASES)
def test_flash_bwd_matches_plain(dev, b, lq, lk, h, hkv, d, causal, segs):
    rng = np.random.default_rng(lq + lk + d)
    q = _bf16(rng, (b, lq, h, d), dev).requires_grad_()
    k = _bf16(rng, (b, lk, hkv, d), dev).requires_grad_()
    v = _bf16(rng, (b, lk, hkv, d), dev).requires_grad_()
    seg = _segment_ids(rng, segs, b, lq, dev)
    kw = dict(causal=causal, segment_ids=seg)
    tatt.reset_launches()
    out = tatt.flash_attention(q, k, v, **kw)
    do = _bf16(rng, out.shape, dev)
    out.backward(do)
    torch.cuda.synchronize()
    assert tatt.flash_attention.launches == 1 and tatt.flash_attention_bwd.launches == 1
    [(key, (count, recorded))] = tatt.flash_attention_bwd.shapes.items()
    assert key[0] == (b, lq, h, d) and key[5] is causal and count == 1
    assert (recorded is None) == (seg is None)
    with torch.no_grad():
        ref_out, lse = tatt.mha_reference(q, k, v, **kw, return_lse=True)
        _, lse_k = tatt._flash_forward(q, k, v, *tatt._segments(q, b, lq, lk, seg, None),
                                       causal, d ** -0.5, with_lse=True)
        ref = tatt.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    assert (lse_k - lse).abs().max().item() < 1e-3
    assert _rel_err(out, ref_out) < TOL
    for got, want in zip((q.grad, k.grad, v.grad), ref):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got).all()
    # a query row with one valid key (causal row 0 of each segment) has an
    # exact dq of zero: P is one-hot and dO . V - D cancels, so both sides
    # hold rounding noise (~1e-7) there, held to an absolute bound; every
    # other row is held per row
    n_keys = tatt._allowed(b, lq, lk, dev, causal, seg, None)
    n_keys = torch.full((b, lq), lk, device=dev) if n_keys is None else (
        n_keys.expand(b, 1, lq, lk).sum(-1)[:, 0])
    multi = n_keys >= 2
    assert _row_err(q.grad, ref[0], multi) < TOL
    lone = q.grad[~multi].float()
    assert lone.numel() == 0 or lone.abs().max().item() <= 1e-3 * ref[0].float().abs().max().item()
    assert _rel_err(k.grad, ref[1]) < TOL and _rel_err(v.grad, ref[2]) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,hkv,d,causal,segs", [
    (2, 512, 512, 28, 4, 128, True, "pad"), (8, 4096, 9, 8, 8, 16, False, None)])
def test_flash_bwd_is_deterministic(dev, b, lq, lk, h, hkv, d, causal, segs):
    """The split grid's partials are summed in a fixed order: two launches
    give the same bits (the decoder call runs on several q chunks)."""
    from rga3_tpu_torch.ops import _kernels

    rng = np.random.default_rng(14)
    q = _bf16(rng, (b, lq, h, d), dev)
    k = _bf16(rng, (b, lk, hkv, d), dev)
    v = _bf16(rng, (b, lk, hkv, d), dev)
    seg = _segment_ids(rng, segs, b, lq, dev)
    q_seg, kv_seg = tatt._segments(q, b, lq, lk, seg, None)
    o, lse = tatt._flash_forward(q, k, v, q_seg, kv_seg, causal, d ** -0.5, with_lse=True)
    do = _bf16(rng, o.shape, dev)
    kw = dict(causal=causal, segment_ids=seg)
    first = tatt.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = tatt.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    words = _kernels.library().rga3_flash_attention_bwd_scratch_words(b, lq, lk, h, hkv, d)
    chunks = (words - (b * h * lq + 3) // 4 * 4) // (2 * b * h * lk * d)
    assert chunks == (1 if lk > 9 else 5)


def _row_err(out, ref, rows):
    """`_rel_err` over the (b, token) rows selected by a (B, L) mask."""
    d = (out.float() - ref.float()).abs().amax(-1)
    m = ref.float().abs().amax(-1).clamp_min(1e-6)
    return (d / m)[rows].max().item()


@pytest.mark.cuda
def test_flash_bwd_strided_and_rows_without_keys(dev):
    """q, k, v as views of one packed qkv; a q segment with no keys gets
    zero dq, and (with zero do on those rows) dk / dv match the plain
    backward."""
    rng = np.random.default_rng(6)
    b, l, h, d = 1, 300, 4, 72
    qkv = _bf16(rng, (b, l, 3, h, d), dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    qs = torch.from_numpy(np.repeat(np.arange(3), 100)[None].astype(np.int32)).to(dev)
    ks = qs.clone()
    ks[ks == 2] = 1  # segment 2 has no keys
    kw = dict(segment_ids=qs, kv_segment_ids=ks)
    out, lse = tatt._flash_forward(q, k, v, *tatt._segments(q, b, l, l, qs, ks), False,
                                   d ** -0.5, with_lse=True)
    do = _bf16(rng, out.shape, dev)
    no_key = (qs[0] == 2)
    do[:, no_key] = 0
    dq, dk, dv = tatt.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    _, lse_r = tatt.mha_reference(q, k, v, **kw, return_lse=True)
    ref = tatt.flash_attention_bwd_reference(q, k, v, out, lse_r, do, **kw)
    assert torch.all(dq[:, no_key] == 0)
    keep = (~no_key).cpu()
    assert _rel_err(dq, ref[0], rows=keep) < TOL
    assert _rel_err(dk, ref[1]) < TOL and _rel_err(dv, ref[2]) < TOL


def _grads(fn, inputs, gout):
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out.backward(gout)
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.cuda
def test_window_attention_grad_matches_plain(dev):
    rng = np.random.default_rng(7)
    q, k, v = (_bf16(rng, (2, 1024, 4, 72), dev) for _ in range(3))
    g = _bf16(rng, q.shape, dev)
    tatt.reset_launches()
    out, grads = _grads(lambda *t: tatt.window_attention(*t, 64), (q, k, v), g)
    assert tatt.window_attention.launches == 1 and out.grad_fn is None
    ref_out, ref = _grads(lambda *t: tatt.window_reference(*t, 64, 72 ** -0.5), (q, k, v), g)
    assert _rel_err(out, ref_out) < TOL
    for got, want in zip(grads, ref):
        assert _rel_err(got, want) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["window", "global"])
def test_fused_block_grad_matches_plain(dev, kind):
    from rga3_tpu_torch.ops import fused_block as fb

    rng = np.random.default_rng(8)
    d, h = 144, 2
    x = _bf16(rng, (2, 1024, d), dev)
    p = _block_params(rng, d, d, 4 * d, dev)
    keys = tuple(p)
    if kind == "window":
        fused = lambda x, *w: fb.fused_window_block(x, dict(zip(keys, w)), num_heads=h,
                                                     window=64)
        plain = lambda x, *w: fb.reference_block(x, dict(zip(keys, w)), num_heads=h, window=64)
    else:
        fused = lambda x, *w: fb.fused_global_block(x, dict(zip(keys, w)), num_heads=h)
        plain = lambda x, *w: fb.reference_global_block(x, dict(zip(keys, w)), num_heads=h)
    g = _bf16(rng, x.shape, dev)
    tatt.reset_launches()
    out, grads = _grads(fused, (x, *p.values()), g)
    wrapper = fb.fused_window_block if kind == "window" else fb.fused_global_block
    assert wrapper.launches == 1
    ref_out, ref = _grads(plain, (x, *p.values()), g)
    assert _rel_err(out, ref_out) < TOL
    for name, got, want in zip(("x",) + keys, grads, ref):
        rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
        assert rel < TOL, (name, rel)


@pytest.mark.cuda
def test_int4_matmul_raises_under_grad(dev):
    from rga3_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(10)
    q, s = _int4_weights(rng, 128, 64, dev)
    x = _bf16(rng, (4, 128), dev).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tq.int4_matmul(x, q, s)
    with torch.no_grad():
        assert tq.int4_matmul(x, q, s).shape == (4, 64)
