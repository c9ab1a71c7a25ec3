"""The port's SAM2 image path (Hiera, forward_image,
decode_features_with_language) against the JAX package's, on one seeded
parameter tree and the same inputs, f32 on the CPU, for each route of the
tiny Hiera: the default fused config (fused window, global and transition
blocks), the same with `fused_block_max_dim` below stage 4's width (the split
window block), and the unfused path. On the CPU the JAX package runs its
fused routes through their `_reference_*` mirrors, the port through its
plain versions.

Tolerance 1e-4 absolute: a module stack in f32 (the trunk's 8 blocks, the
neck and the two-way decoder) whose sums run in another order.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rga3_tpu.models.sam2.config import tiny_sam2_config as jax_tiny_sam2
from rga3_tpu.models.sam2.hiera import Hiera as JaxHiera
from rga3_tpu.models.sam2.model import Sam2Model as JaxSam2
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
from rga3_tpu_torch.models.sam2.model import Sam2Model

from torch_port_support import jax_param_tree

ATOL = 1e-4
# the tiny Hiera's stage widths are 16/32/64/128 and its stage 4 is its one
# transition block: 32 sends stage 3's windowed blocks through the split
# window block (and its global block to the unfused path)
ROUTES = {
    "fused": {},
    "split": {"fused_block_max_dim": 32},
    "unfused": {"use_fused_block": False, "use_fused_transition": False},
}


def _configs(route):
    jcfg, tcfg = jax_tiny_sam2(64), tiny_sam2_config(64)
    return (jcfg.replace(hiera=jcfg.hiera.replace(**ROUTES[route])),
            tcfg.replace(hiera=tcfg.hiera.replace(**ROUTES[route])))


@pytest.fixture(scope="module", params=list(ROUTES))
def pair(request):
    jcfg, tcfg = _configs(request.param)
    jm = JaxSam2(jcfg)
    params = jax_param_tree(
        jm, jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 1, 32)), seed=3)
    tm = Sam2Model(tcfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    return jm, params, tm


def test_hiera_matches_jax(pair):
    jm, params, tm = pair
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    trunk = {"params": params["params"]["image_encoder"]["trunk"]}
    jout = jax.jit(JaxHiera(jm.cfg.hiera).apply)(trunk, jnp.asarray(x))
    with torch.no_grad():
        tout = tm.image_encoder.trunk(torch.from_numpy(x))
    assert len(tout) == len(jout) == 4
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


def test_forward_image_matches_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    fwd = jax.jit(lambda p, x: jm.apply(p, x, method=lambda m, x_: m.forward_image(x_)))
    jout = fwd(params, jnp.asarray(imgs))
    with torch.no_grad():
        tout = tm.forward_image(torch.from_numpy(imgs))
    for key in ("backbone_fpn", "vision_pos_enc"):
        for a, b in zip(jout[key], tout[key]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


def test_decode_features_with_language_matches_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(1)
    s0 = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    s1 = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    s2 = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    lang = rng.standard_normal((2, 1, 32)).astype(np.float32)
    dec = jax.jit(lambda p, *a: jm.apply(
        p, *a, method=lambda m, a_, b_, c_, l_: m.decode_features_with_language(a_, b_, c_, l_)))
    jout = dec(params, *(jnp.asarray(x) for x in (s0, s1, s2, lang)))
    with torch.no_grad():
        tout = tm.decode_features_with_language(
            *(torch.from_numpy(x) for x in (s0, s1, s2, lang)))
    for key in ("low_res_multimasks", "ious", "high_res_masks", "obj_ptr",
                "object_score_logits"):
        np.testing.assert_allclose(
            tout[key].numpy(), np.asarray(jout[key]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("multimask", [True, False], ids=["multimask", "single"])
def test_decode_frames_with_language_training_matches_jax(pair, multimask):
    """The training path's decode (`training=True`, the backbone cut): with
    one mask the first one is taken (no stability selection), as in JAX;
    gradients reach conv_s0 / conv_s1 below the cut and not the trunk."""
    jm, params, tm = pair
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    lang = rng.standard_normal((2, 1, 32)).astype(np.float32)
    kw = dict(multimask_output=multimask, training=True, stop_backbone_grad=True)
    dec = jax.jit(lambda p, x, l: jm.apply(
        p, x, l, method=lambda m, x_, l_: m.decode_frames_with_language(x_, l_, **kw)))
    jout = dec(params, jnp.asarray(imgs), jnp.asarray(lang))
    tout = tm.decode_frames_with_language(torch.from_numpy(imgs), torch.from_numpy(lang), **kw)
    for key in ("low_res_multimasks", "ious", "low_res_masks", "high_res_masks", "obj_ptr"):
        np.testing.assert_allclose(
            tout[key].detach().numpy(), np.asarray(jout[key]), atol=ATOL, rtol=0)
    tm.zero_grad()
    tout["high_res_masks"].square().mean().backward()
    dec_p = tm.sam_mask_decoder
    assert dec_p.conv_s0.weight.grad is not None and dec_p.conv_s1.weight.grad is not None
    assert all(p.grad is None for p in tm.image_encoder.parameters())
    tm.zero_grad()
    if not multimask:
        with pytest.raises(NotImplementedError):  # the stability selection
            tm.decode_frames_with_language(torch.from_numpy(imgs), torch.from_numpy(lang),
                                           multimask_output=False)


def test_one_state_dict_runs_fused_and_unfused_alike():
    """One converted state_dict loads into the fused and the unfused port
    models (the parameter tree does not depend on the route) and they agree
    in f32: the counterpart of tests/test_fused_block.py::
    test_hiera_fused_path_parity_and_tree."""
    jcfg, _ = _configs("fused")
    params = jax_param_tree(
        JaxSam2(jcfg), jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 1, 32)), seed=6)
    state = torch_state_dict_from_flax(params)
    imgs = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    outs = []
    for route in ("fused", "split", "unfused"):
        tm = Sam2Model(_configs(route)[1], device="cpu")
        tm.load_state_dict(state, strict=True)
        with torch.no_grad():
            outs.append(tm.forward_image(imgs)["backbone_fpn"])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL, rtol=0)


def test_window_partition_roundtrip_matches_jax():
    from rga3_tpu.models.sam2 import hiera as jh
    from rga3_tpu_torch.models.sam2 import hiera as th

    x = np.random.default_rng(2).standard_normal((2, 10, 13, 3)).astype(np.float32)
    jw, jpad = jh.window_partition(jnp.asarray(x), 4)
    tw, tpad = th.window_partition(torch.from_numpy(x), 4)
    assert tuple(jpad) == tuple(tpad)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    back = th.window_unpartition(tw, 4, tpad, (10, 13))
    np.testing.assert_array_equal(back.numpy(), x)
