"""The port's CoTrackerLite (`rga3_tpu_torch/models/stom/cotracker.py`)
against the JAX package's, on the CPU, from one seeded parameter tree
(`torch_port_support.jax_param_tree`, through the weight bridge).

Modules and the whole tracker in f32 within 1e-5 (ATOL), relative to the
largest value compared where that exceeds 1: `ConvBlock` at stride 1 and 2
on even and odd sizes (flax's "SAME" pads a stride-2 conv on an even size
asymmetrically), `FeatureEncoder`, GroupNorm and LayerNorm at eps 1e-6,
`UpdateBlock` over both axes, `bilinear_sample`, `_sincos_embed`; the
forward at the JAX test's tiny dims and at the default width; the gradients of the flat training loss against
`jax.grad` per leaf within GRAD_RTOL of the leaf's largest gradient (the
attention's key bias, whose gradient is zero in exact arithmetic, within
ZERO_GRAD_ATOL of zero in both packages). The weight files both ways
(`save_params` / `load_params`).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rga3_tpu.models.stom import cotracker as jlite
from rga3_tpu.models.stom import synth as jsynth
from rga3_tpu_torch.convert import flax_tree_from_torch, torch_state_dict_from_flax
from rga3_tpu_torch.models.stom import cotracker as tlite

from torch_port_support import jax_param_tree

ATOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_GRAD_ATOL = 1e-8
TINY = dict(dim=64, heads=4, depth=1, num_scales=2, iterations=2)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one thread: these models are small (thousands of
    tiny ops), and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(t):
    return t.detach().float().numpy()


def _close(got, ref, atol=ATOL):
    """|got - ref| within atol times max(1, max|ref|)."""
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol * scale)


def _port(module, params):
    module.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("stride,hw", [(1, (12, 16)), (1, (11, 13)), (2, (12, 16)),
                                       (2, (11, 13))])
def test_conv_block(stride, hw):
    x = np.random.default_rng(0).normal(0, 1, (2, *hw, 16)).astype(np.float32)
    jm = jlite.ConvBlock(32, stride=stride)
    params = jax_param_tree(jm, jnp.zeros(x.shape), seed=1)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = _port(tlite.ConvBlock(16, 32, stride), params)
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape
    _close(_np(got), ref)


@pytest.mark.parametrize("hw", [(32, 40), (30, 38), (29, 35)])
def test_feature_encoder(hw):
    x = np.random.default_rng(1).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    jm = jlite.FeatureEncoder(dim=32)
    params = jax_param_tree(jm, jnp.zeros(x.shape), seed=2)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = _port(tlite.FeatureEncoder(32), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, -(-hw[0] // 4), -(-hw[1] // 4), 32)
    _close(_np(got), ref)


def test_norms_eps():
    """flax's GroupNorm and LayerNorm use eps 1e-6: on inputs of variance
    ~1e-4, torch's 1e-5 would be off by ~5%."""
    import flax.linen as nn

    x = np.random.default_rng(6).normal(0.0, 1e-2, (2, 6, 7, 16)).astype(np.float32)
    jm = nn.GroupNorm(num_groups=8)
    params = jax_param_tree(jm, jnp.zeros(x.shape), seed=6)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = _port(tlite.GroupNorm(16), params)
    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1)
    _close(_np(got), ref)
    jm = nn.LayerNorm()
    params = jax_param_tree(jm, jnp.zeros(x.shape), seed=7)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = _port(tlite.LayerNorm(16, eps=1e-6), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(_np(got), ref)


@pytest.mark.parametrize("axis", ["time", "track"])
def test_update_block(axis):
    x = np.random.default_rng(2).normal(0, 1, (5, 6, 32)).astype(np.float32)
    jm = jlite.UpdateBlock(32, 4, axis)
    params = jax_param_tree(jm, jnp.zeros(x.shape), seed=3)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = _port(tlite.UpdateBlock(32, 4, axis), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(_np(got), ref)


def test_bilinear_sample_and_sincos():
    rng = np.random.default_rng(3)
    fmap = rng.normal(0, 1, (9, 11, 5)).astype(np.float32)
    xy = np.concatenate([rng.uniform(-2, 13, (40, 2)),
                         [[0, 0], [10, 8], [10.5, 8.7], [-1, 4.2]]]).astype(np.float32)
    ref = np.asarray(jlite.bilinear_sample(jnp.asarray(fmap), jnp.asarray(xy)))
    got = tlite.bilinear_sample(torch.from_numpy(fmap), torch.from_numpy(xy))
    _close(_np(got), ref)
    d = rng.uniform(-3, 3, (4, 6, 2)).astype(np.float32)
    for dim in (64, 256):
        ref = np.asarray(jlite._sincos_embed(jnp.asarray(d), dim))
        _close(_np(tlite._sincos_embed(torch.from_numpy(d), dim)), ref)
    np.testing.assert_array_equal(tlite._offset_grid(3), jlite._offset_grid(3))


def _clip(t, size, n, seed):
    frames, queries, gt = jsynth.make_synthetic_batch(
        np.random.default_rng(seed), t=t, h=size, w=size, n_points=n)
    return frames, queries, gt


@pytest.mark.parametrize("dims,clip", [(TINY, (6, 44, 12)), ({}, (4, 64, 8))],
                         ids=["tiny", "default"])
def test_forward(dims, clip):
    """The whole tracker; `dims` {} is the default width (dim 256, 8 heads,
    3 block pairs, 4 scales, 4 iterations). At 44 px the 11 x 11 stride-4
    map pools to 5 x 5 (flax's avg_pool is VALID)."""
    t, size, n = clip
    frames, queries, _ = _clip(t, size, n, seed=4)
    jm = jlite.CoTrackerLite(**dims)
    params = jax_param_tree(jm, jnp.asarray(frames), jnp.asarray(queries), seed=5, std=0.05)
    tracks, vis = jax.jit(jm.apply)(params, jnp.asarray(frames), jnp.asarray(queries))
    tm = _port(tlite.CoTrackerLite(**dims), params)
    with torch.no_grad():
        got_t, got_v = tm(torch.from_numpy(frames), torch.from_numpy(queries))
    assert got_t.shape == (t, n, 2) and got_v.shape == (t, n)
    _close(_np(got_t), np.asarray(tracks), atol=1e-4)
    _close(_np(got_v), np.asarray(vis), atol=1e-4)


def test_gradients():
    """The flat training loss (`train_cotracker`'s lite objective) and its
    gradients: Lite does not stop the gradient through the positions."""
    from rga3_tpu_torch.tools.train_cotracker import _bce_ones, _huber

    frames, queries, gt = _clip(4, 32, 6, seed=6)
    jm = jlite.CoTrackerLite(**TINY)
    params = jax_param_tree(jm, jnp.asarray(frames), jnp.asarray(queries), seed=7, std=0.05)

    def loss_fn(p):
        tracks, vis = jm.apply(p, jnp.asarray(frames), jnp.asarray(queries))
        err = tracks - jnp.asarray(gt)
        huber = jnp.where(jnp.abs(err) < 4.0, 0.5 * err ** 2, 4.0 * (jnp.abs(err) - 2.0))
        bce = jnp.mean(jnp.maximum(vis, 0) - vis + jnp.log1p(jnp.exp(-jnp.abs(vis))))
        return huber.mean() + 0.1 * bce

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tm = _port(tlite.CoTrackerLite(**TINY), params)
    tracks, vis = tm(torch.from_numpy(frames), torch.from_numpy(queries))
    got = _huber(tracks - torch.from_numpy(gt)).mean() + 0.1 * _bce_ones(vis)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    ref = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in tm.named_parameters():
        r = ref[name].numpy()
        if name.endswith("attn.key.bias"):  # softmax is blind to a key bias
            assert np.abs(r).max() <= ZERO_GRAD_ATOL and _np(p.grad.abs()).max() <= ZERO_GRAD_ATOL
            continue
        np.testing.assert_allclose(_np(p.grad), r, rtol=0,
                                   atol=GRAD_RTOL * max(float(np.abs(r).max()), 1e-8),
                                   err_msg=name)


def test_flax_tree_and_weight_files(tmp_path):
    """flax_tree_from_torch gives the JAX tree (keys, shapes) at default
    width; the port's save_params file restores through JAX's load_params,
    and JAX's save_params file through the port's load_params."""
    frames, queries, _ = _clip(2, 32, 3, seed=8)
    jm = jlite.CoTrackerLite()
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(frames),
                          jnp.asarray(queries))
    tm = tlite.CoTrackerLite()
    tm.init_weights(torch.Generator().manual_seed(0))
    tree = flax_tree_from_torch(tm)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), like["params"])

    port_file = str(tmp_path / "port.npz")
    tlite.save_params(port_file, tm)
    back = jlite.load_params(port_file, like)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_tree = dict(jax.tree_util.tree_leaves_with_path({"params": tree}))
    for k, v in flat_back:
        np.testing.assert_array_equal(np.asarray(v), flat_tree[k])

    rng = np.random.default_rng(9)
    jax_params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), like)
    jax_file = str(tmp_path / "jax.npz")
    jlite.save_params(jax_file, jax_params)
    other = tlite.load_params(jax_file, tlite.CoTrackerLite())
    want = torch_state_dict_from_flax(jax_params)
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k]), k
