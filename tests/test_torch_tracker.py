"""The port's SAM2 memory tracker (`models/sam2/video.py`, `memory.py`, the
point prompts and the memory steps of `model.py`) against the JAX package's,
on one seeded parameter tree and the same inputs, f32 on the CPU.

The oracle is the JAX `track_video` under `jax.jit` (its `lax.scan`), which
on the CPU takes the dense branch of the memory attention; the port runs
its eager frame loop. Cases: language prompts for O = 1 and 2, point
prompts, the eval stride 2, and T = 18 frames, so that the 6-slot mask ring
and the 15-slot pointer ring both wrap.

Tolerance: per frame, masks and object pointers within 1e-4 of the frame's
max|ref| (a module stack in f32 whose sums run in another order, fed back
through the memory for up to 17 frames); modules alone 1e-5 absolute.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rga3_tpu.models.sam2 import memory as jmem
from rga3_tpu.models.sam2 import video as jvideo
from rga3_tpu.models.sam2.config import tiny_sam2_config as jax_tiny_sam2
from rga3_tpu.models.sam2.model import Sam2Model as JaxSam2
from rga3_tpu.ops import rope as jrope
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.models.sam2 import memory as tmem
from rga3_tpu_torch.models.sam2 import video as tvideo
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
from rga3_tpu_torch.models.sam2.model import Sam2Model
from rga3_tpu_torch.ops import rope as trope

from torch_port_support import jax_param_tree

IMAGE = 64
TRACK_TOL = 1e-4  # of the frame's max|ref|
ATOL = 1e-5


@pytest.fixture(scope="module")
def tracker():
    """(JAX model, params, port model, port model at stride 2) on one tree."""
    jm = JaxSam2(jax_tiny_sam2(IMAGE))
    params = jax_param_tree(jm, jnp.zeros((2, IMAGE, IMAGE, 3)), jnp.zeros((2, 1, 32)), seed=11)
    sd = torch_state_dict_from_flax(params)
    ports = {}
    for stride in (1, 2):
        tm = Sam2Model(tiny_sam2_config(IMAGE).replace(memory_temporal_stride_for_eval=stride),
                       device="cpu")
        tm.load_state_dict(sd, strict=True)
        ports[stride] = tm.eval()
    return jm, params, ports


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jax_track(jm, params, frames, **prompts):
    names = sorted(prompts)

    def run(p, fr, *vals):
        return jvideo.track_video(jm, p, fr, **dict(zip(names, vals)))

    out = jax.jit(run)(params, jnp.asarray(frames), *(jnp.asarray(prompts[n]) for n in names))
    return {k: np.asarray(v) for k, v in out.items()}


# name: (objects, frames, stride, prompt)
TRACK_CASES = {
    "language_o1_t18": (1, 18, 1, "language"),
    "language_o2_t18": (2, 18, 1, "language"),
    "points_o2": (2, 6, 1, "points"),
    "language_o1_stride2_t18": (1, 18, 2, "language"),
}


@pytest.mark.parametrize("case", list(TRACK_CASES))
def test_track_video_matches_jax(tracker, case):
    jm, params, ports = tracker
    n_obj, t, stride, kind = TRACK_CASES[case]
    rng = np.random.default_rng(len(case))
    frames = rng.standard_normal((t, IMAGE, IMAGE, 3)).astype(np.float32)
    if kind == "language":
        prompts = {"language_embd": rng.standard_normal((n_obj, 1, 32)).astype(np.float32)}
    else:  # one positive click each
        prompts = {"point_coords": rng.uniform(0, IMAGE, (n_obj, 1, 2)).astype(np.float32),
                   "point_labels": np.ones((n_obj, 1), np.int32)}
    jm_s = JaxSam2(jm.cfg.replace(memory_temporal_stride_for_eval=stride))
    ref = _jax_track(jm_s, params, frames, **prompts)
    out = tvideo.track_video(ports[stride], torch.from_numpy(frames), device="cpu",
                             **{k: torch.from_numpy(v) for k, v in prompts.items()})
    assert out["high_res_masks"].shape == (t, n_obj, IMAGE, IMAGE)
    assert out["obj_ptrs"].shape == (t, n_obj, 32)
    for key in ("high_res_masks", "obj_ptrs"):
        got, want = out[key].numpy(), ref[key]
        for f in range(t):
            scale = max(np.abs(want[f]).max(), 1e-6)
            err = np.abs(got[f] - want[f]).max()
            assert err <= TRACK_TOL * scale, (key, f, err, scale)


def test_track_video_needs_the_model_device(tracker):
    _, _, ports = tracker
    with pytest.raises(ValueError):
        tvideo.track_video(ports[1], torch.zeros(2, IMAGE, IMAGE, 3),
                           language_embd=torch.zeros(1, 1, 32), device="meta")


def test_segment_video_with_language_matches_jax(tracker):
    jm, params, ports = tracker
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((3, IMAGE, IMAGE, 3)).astype(np.float32)
    lang = rng.standard_normal((1, 32)).astype(np.float32)
    ref = jvideo.segment_video_with_language(jm, params, jnp.asarray(frames),
                                             jnp.asarray(lang), chunk=2)
    out = tvideo.segment_video_with_language(ports[1], _t(frames), _t(lang), chunk=2,
                                             device="cpu")
    assert out.shape == (3, 1, IMAGE, IMAGE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TRACK_TOL, rtol=0)


def test_axial_rope_matches_jax():
    jc, js = jrope.axial_cos_sin(8, 8, 32, 10_000.0)
    tc, ts = trope.axial_cos_sin(8, 8, 32, 10_000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    x = np.random.default_rng(0).standard_normal((2, 1, 64, 32)).astype(np.float32)
    ref = jrope.apply_rotary_interleaved(jnp.asarray(x), jc, js)
    out = trope.apply_rotary_interleaved(_t(x), tc, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _sub(params, *path):
    node = params["params"]
    for p in path:
        node = node[p]
    return {"params": node}


@pytest.mark.parametrize("which", ["self_attn", "cross_attn_image"])
def test_rope_attention_matches_jax(tracker, which):
    """Self-attention, and cross-attention with the memory frames' keys
    RoPE'd as repeats of the grid (`rope_k_repeat`), pointer tokens
    excluded from RoPE, and invalid keys."""
    jm, params, ports = tracker
    cfg = jm.cfg
    rng = np.random.default_rng(3)
    lq = cfg.feat_size ** 2
    q = rng.standard_normal((2, lq, 32)).astype(np.float32)
    jmod = jmem.RoPEAttention(cfg)
    kw = {}
    if which == "self_attn":
        k = v = q
    else:
        jmod = jmem.RoPEAttention(cfg, kv_in_dim=cfg.mem_dim, rope_k_repeat=True)
        lk = 3 * lq + 8  # three memory frames, four pointers of two tokens
        k = rng.standard_normal((2, lk, cfg.mem_dim)).astype(np.float32)
        v = rng.standard_normal((2, lk, cfg.mem_dim)).astype(np.float32)
        valid = np.ones((2, lk), bool)
        valid[0, lq:2 * lq] = False
        valid[1, 3 * lq + 2:3 * lq + 6] = False
        kw = dict(num_k_exclude_rope=8, k_valid=valid)
    ref = jmod.apply(_sub(params, "memory_attention", "layers_1", which), jnp.asarray(q),
                     jnp.asarray(k), jnp.asarray(v),
                     **{n: jnp.asarray(x) if n == "k_valid" else x for n, x in kw.items()})
    tmod = getattr(ports[1].memory_attention.layers_1, which)
    with torch.no_grad():
        out = tmod(_t(q), _t(k), _t(v), **{n: _t(x) if n == "k_valid" else x
                                           for n, x in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_memory_flash_branch_on_the_cpu_follows_the_dense_branch():
    """The flash-branch helper (the kernel's call on the card) computes
    `mha_reference` on the CPU: equal to the dense branch on rows with a
    valid key. A row with none: the dense branch (-1e30) and the plain flash
    version (the kernels' mask value) both give mean(V) over all keys;
    the kernel gives zeros there (tests/test_torch_kernels.py)."""
    rng = np.random.default_rng(9)
    q = _t(rng.standard_normal((2, 64, 1, 32)).astype(np.float32))
    k = _t(rng.standard_normal((2, 200, 1, 32)).astype(np.float32))
    v = _t(rng.standard_normal((2, 200, 1, 32)).astype(np.float32))
    valid = torch.zeros(2, 200, dtype=torch.bool)
    valid[0, 17:130] = True  # batch row 1 has no valid key
    flash = tmem.memory_flash_attention(q, k, v, valid, 32 ** -0.5)
    dense = tmem.memory_dense_attention(q, k, v, valid)
    np.testing.assert_allclose(flash[0].numpy(), dense[0].numpy(), atol=ATOL, rtol=0)
    mean_v = v[1].mean(0, keepdim=True).expand(64, 1, 32)
    np.testing.assert_allclose(dense[1].numpy(), mean_v.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(flash[1].numpy(), mean_v.numpy(), atol=ATOL, rtol=0)
    full = tmem.memory_flash_attention(q, k, v, None, 32 ** -0.5)
    np.testing.assert_allclose(full.numpy(), tmem.memory_dense_attention(q, k, v, None).numpy(),
                               atol=ATOL, rtol=0)


def test_memory_encoder_matches_jax(tracker):
    jm, params, ports = tracker
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    s = cfg.feat_size
    pix = rng.standard_normal((2, s, s, cfg.d_model)).astype(np.float32)
    masks = 4 * rng.standard_normal((2, IMAGE, IMAGE, 1)).astype(np.float32)
    ref = jax.jit(lambda p, a, b: jm.apply(
        p, a, b, method=lambda m, p_, x_: m.encode_new_memory(p_, x_)))(
        params, jnp.asarray(pix), jnp.asarray(masks))
    with torch.no_grad():
        out = ports[1].encode_new_memory(_t(pix), _t(masks))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("frame_idx", [1, 2, 7, 17])
def test_build_memory_matches_jax(tracker, frame_idx):
    """Bank order (cond frame, t_pos 1..6, pointer tokens), positional
    encodings and validity, from one bank state with every slot written."""
    jm, params, ports = tracker
    cfg = jm.cfg
    rng = np.random.default_rng(frame_idx)
    ltok, n_ring, n_ptr = cfg.feat_size ** 2, cfg.num_maskmem - 1, cfg.max_obj_ptrs_in_encoder - 1
    ring_frame = [-1] * n_ring
    for f in range(1, frame_idx):  # frames written so far (stride 1)
        ring_frame[tvideo.ring_slot(cfg, f)] = f
    ptr_frame = [-1] * n_ptr
    for f in range(1, frame_idx):
        ptr_frame[f % n_ptr] = f
    arrays = {
        "cond_feat": rng.standard_normal((2, ltok, cfg.mem_dim)),
        "cond_ptr": rng.standard_normal((2, cfg.hidden_dim)),
        "prev_feat": rng.standard_normal((2, ltok, cfg.mem_dim)),
        "ring_feat": rng.standard_normal((n_ring, 2, ltok, cfg.mem_dim)),
        "ptr_ring": rng.standard_normal((n_ptr, 2, cfg.hidden_dim)),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    prev = frame_idx - 1 if frame_idx > 1 else -1
    jstate = {k: jnp.asarray(v) for k, v in arrays.items()}
    jstate.update(cond_valid=jnp.asarray(True), prev_frame=jnp.asarray(prev, jnp.int32),
                  ring_frame=jnp.asarray(ring_frame, jnp.int32),
                  ptr_frame=jnp.asarray(ptr_frame, jnp.int32))
    tstate = {k: _t(v) for k, v in arrays.items()}
    tstate.update(cond_valid=True, prev_frame=prev, ring_frame=ring_frame, ptr_frame=ptr_frame)
    pos = rng.standard_normal((ltok, cfg.mem_dim)).astype(np.float32)
    tpos = np.asarray(params["params"]["maskmem_tpos_enc"])
    ref = jvideo._build_memory(jm, params, cfg, jstate, jnp.asarray(frame_idx),
                               jnp.asarray(pos), jnp.asarray(tpos))
    with torch.no_grad():
        out = tvideo._build_memory(ports[1], cfg, tstate, frame_idx, _t(pos), _t(tpos))
    assert out[3] == int(ref[3])
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    # every memory frame the bank holds at this frame is valid
    n_valid = 1 + min(frame_idx - 1, cfg.num_maskmem - 1)
    assert out[2][0, :cfg.num_maskmem * ltok].sum().item() == n_valid * ltok


def test_point_prompted_heads_match_jax(tracker):
    """forward_sam_heads with clicks (positive, negative, padding): the same
    masks, IoUs, best-IoU pick and pointer as the JAX package."""
    jm, params, ports = tracker
    cfg = jm.cfg
    rng = np.random.default_rng(6)
    s = cfg.feat_size
    pix = rng.standard_normal((2, s, s, 32)).astype(np.float32)
    hr = (rng.standard_normal((2, 4 * s, 4 * s, 4)).astype(np.float32),
          rng.standard_normal((2, 2 * s, 2 * s, 8)).astype(np.float32))
    coords = rng.uniform(0, IMAGE, (2, 3, 2)).astype(np.float32)
    labels = np.array([[1, 0, -1], [1, 1, 0]], np.int32)
    ref = jax.jit(lambda p, *a: jm.apply(
        p, a[0], a[1:3], None, *a[3:], method=lambda m, *b: m.forward_sam_heads(*b)))(
        params, jnp.asarray(pix), *(jnp.asarray(x) for x in hr), jnp.asarray(coords),
        jnp.asarray(labels))
    with torch.no_grad():
        out = ports[1].forward_sam_heads(_t(pix), tuple(_t(x) for x in hr), None,
                                         _t(coords), _t(labels))
    np.testing.assert_array_equal(out["ious"].argmax(-1).numpy(),
                                  np.asarray(ref["ious"]).argmax(-1))
    for key in ("low_res_multimasks", "ious", "high_res_masks", "obj_ptr"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=0)
