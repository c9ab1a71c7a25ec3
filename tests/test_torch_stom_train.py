"""The port's tracker training (`rga3_tpu_torch/tools/train_cotracker.py`), its
weight files and its scorer (`tools/bench_stom_synth.py`) against the JAX
package's `scripts/train_cotracker.py` / `bench_stom_synth.py` and
`models/stom/cotracker3.py`, on the CPU, from one seeded parameter tree.

  * Steps: two steps of the flat lite, flat cotracker3 and layered (batch 2)
    steps against JAX's optax steps built as the script builds them (the
    first at learning rate 0): losses within LOSS_RTOL (LOSS_RTOL_ITERS2 at
    the layered step's 2 refinement iterations), aux errors within
    AUX_ATOL px, the parameters' updates within UPDATE_MAX x lr per element and
    UPDATE_MEAN x lr in a leaf's mean of JAX's (those of zero-gradient
    leaves, which Adam turns into steps of random sign in both packages,
    within Adam's bound).
  * CoTracker3's gradient (F8): each layered step's gradients at
    `tiny_cotracker3_config()` with 2 refinement iterations against JAX's
    per leaf, within GRAD_RTOL of the leaf's largest gradient. JAX stops the
    gradient through the track estimates at each iteration; without that
    the port's gradients are off by ~100x the leaf's scale. Leaves whose
    gradient is zero in exact arithmetic (a conv bias before an instance
    norm, the key half of `to_kv`'s bias) within ZERO_GRAD_ATOL of zero.
  * Weight files (F9): the flax tree of the port's CoTracker3 is JAX's
    (keys, shapes); `save_cotracker3` files both ways, bit-equal to the
    weights rounded to f16; a resume from the shipped `cotracker3_small.npz`
    at `--preset small` gives JAX's first-step loss (bf16 compute, within
    RESUME_RTOL).
  * The CLIs at `--tiny --device cpu` for a few steps (the files they write
    read by JAX), and `bench_stom_synth` against the JAX script in process.
"""
import json
import os
import sys

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from rga3_tpu.models.stom import cotracker as jlite
from rga3_tpu.models.stom import cotracker3 as jct
from rga3_tpu.models.stom import synth as jsynth
from rga3_tpu_torch.convert import flax_tree_from_torch, torch_state_dict_from_flax
from rga3_tpu_torch.models.stom import cotracker as tlite
from rga3_tpu_torch.models.stom import cotracker3 as tct
from rga3_tpu_torch.tools import bench_stom_synth as tbench
from rga3_tpu_torch.tools import train_cotracker as tcli
from scripts import bench_stom_synth as jbench
from scripts import train_cotracker as jcli

from torch_port_support import jax_param_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "rga3_tpu", "models", "stom", "weights", "cotracker3_small.npz")
GRAD_RTOL = 2e-3
ZERO_GRAD_ATOL = 1e-5
LOSS_RTOL = 1e-5
# past one refinement iteration a rounding difference grows ~30x an
# iteration (the flow embedding's sin/cos run at up to ~1000 rad a pixel)
LOSS_RTOL_ITERS2 = 1e-4
AUX_ATOL = 1e-3
# the parameters' moves after the second step (lr(1) = 1.5e-4), per element
# and in the mean over a leaf: Adam divides each element's moment by its
# own scale, so an element whose gradients cancel magnifies a rounding
# difference; a wrong schedule, clip, decay or bias correction moves every
# element by a share of lr
UPDATE_MAX = 0.25  # x lr(1)
UPDATE_MEAN = 5e-3  # x lr(1)
RESUME_RTOL = 1e-2
TINY_LITE = dict(dim=64, heads=4, depth=1, num_scales=2, iterations=2)  # --tiny
STEPS = 10  # the schedule's length: warmup 2, so the two steps take lr 0 and lr / 2



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one thread: these models are small (thousands of
    tiny ops), and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _args(*argv):
    return tcli.parse_args([*argv, "--device", "cpu"])


def _jax_cfg(cfg):
    """The JAX package's CoTracker3Config of the port's."""
    return jct.CoTracker3Config(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _layered_batch(b, t, h, w, n, seed):
    rng = np.random.default_rng(seed)
    clips = [jsynth.make_training_clip(rng, t=t, h=h, w=w, n_points=n) for _ in range(b)]
    frames = np.stack([np.clip(c[0] * 255.0 + 0.5, 0, 255).astype(np.uint8) for c in clips])
    return (frames,) + tuple(np.stack([c[i] for c in clips]) for i in (1, 2, 3))


def _recording(tx):
    """`tx` after a transformation that keeps the gradient it was given in
    its state (`state[0]`) and passes it on unchanged."""
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    return optax.chain(keep, tx)


def _port_model(cls_or_model, params):
    model = cls_or_model
    model.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    return model


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _zero_grad_leaf(name):
    return (name.startswith("fnet.") and name.endswith(".bias")
            and not name.startswith("fnet.conv3")) or name.endswith("attn.key.bias")


def _check_grads(grads, jax_grads, hidden):
    ref = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax_grads))
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        got, want = g.numpy(), ref[name].numpy()
        if name.endswith("to_kv.bias"):  # its key half is blind to the softmax
            assert max(np.abs(got[:hidden]).max(), np.abs(want[:hidden]).max()) <= ZERO_GRAD_ATOL
            got, want = got[hidden:], want[hidden:]
        elif _zero_grad_leaf(name):
            assert max(np.abs(got).max(), np.abs(want).max()) <= ZERO_GRAD_ATOL, name
            continue
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(want).max()), err_msg=name)


def _two_steps(jstep, jparams, jstate, tstep, batches):
    """Both packages' steps over the batches: per step (JAX loss, port loss,
    JAX aux, port aux, JAX's optimizer state); the parameters after them."""
    out = []
    for batch in batches:
        jparams, jstate, jloss, jaux = jstep(jparams, jstate, *map(jnp.asarray, batch))
        tloss, taux = tstep(*_torch(*batch))
        out.append((float(jloss), tloss.item(), np.asarray(jaux, np.float32).ravel(),
                    torch.stack([torch.as_tensor(a) for a in (
                        taux if isinstance(taux, tuple) else (taux,))]).numpy(), jstate))
    return out, jparams


def _recorded_grads(opt, model):
    """The gradients each of `opt`'s updates took (read at its zero_grad)."""
    seen = []

    def record_then_zero():
        seen.append({n: p.grad.clone() for n, p in model.named_parameters()})
        type(opt).zero_grad(opt)

    opt.zero_grad = record_then_zero
    return seen


def _check_updates(model, before, jparams_after, lr, hidden=None):
    """The parameters' moves against JAX's, within UPDATE_MAX x lr per
    element and UPDATE_MEAN x lr in a leaf's mean. Where the gradient is
    zero in exact arithmetic, Adam normalises rounding noise to a step of
    random sign: there both moves only stay within Adam's bound, 1.5 x lr."""
    after = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams_after))
    moved = []
    for name, p in model.named_parameters():
        want = after[name].numpy() - before[name].numpy()
        got = p.detach().numpy() - before[name].numpy()
        zero = np.zeros(want.shape, bool)
        if name.endswith("to_kv.bias"):
            zero[:hidden] = True
        elif _zero_grad_leaf(name):
            zero[:] = True
        assert max(np.abs(got[zero]).max(initial=0), np.abs(want[zero]).max(initial=0)) <= 1.5 * lr
        if zero.all():
            continue
        diff = np.abs(got[~zero] - want[~zero])
        assert diff.max() <= UPDATE_MAX * lr and diff.mean() <= UPDATE_MEAN * lr, (
            name, diff.max() / lr, diff.mean() / lr)
        moved.append(np.abs(want[~zero]).mean())
    assert np.mean(moved) > 0.1 * lr  # the second step moved the parameters


def _jax_adamw(lr, steps, warmup_cap, clip):
    """The JAX script's optimizer (`train_cotracker.py`: flat `main`,
    layered `train_layered`)."""
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, lr, min(warmup_cap, steps // 10 + 1), steps), weight_decay=1e-5)
    return optax.chain(optax.clip_by_global_norm(clip), tx) if clip else tx


@pytest.mark.parametrize("arch", ["lite", "cotracker3"])
def test_flat_steps(arch):
    args = _args("--arch", arch, "--tiny", "--steps", str(STEPS), "--size", "32",
                 "--frames", "4", "--points", "6")
    rng = np.random.default_rng(1)
    batches = [jsynth.make_synthetic_batch(rng, t=4, h=32, w=32, n_points=6) for _ in range(2)]
    if arch == "lite":
        jm, model = jlite.CoTrackerLite(**TINY_LITE), tlite.tiny_lite()
    else:  # the CLI's model at one refinement iteration (past one they are
        # chaotic) and one block of each kind (half the JAX step's compile)
        cfg = tct.tiny_cotracker3_config().replace(model_resolution=(32, 32), iters=1,
                                                   time_depth=1, space_depth=1)
        jm, model = jct.CoTracker3Offline(_jax_cfg(cfg)), tct.CoTracker3Offline(cfg)
    params = jax_param_tree(jm, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]),
                            seed=4, std=0.05)
    tx = _jax_adamw(args.lr, args.steps, 100, None)
    jstep = jcli.build_train_step(jm, tx, arch=arch)
    _port_model(model, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tcli.make_optimizer(model, args.lr, args.steps, min(100, args.steps // 10 + 1), None)
    tstep = tcli.build_train_step(model, opt, arch=arch)
    out, jafter = _two_steps(jstep, params, tx.init(params), tstep, batches)
    for jl, tl, ja, ta, _ in out:
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(ta, ja, rtol=LOSS_RTOL)
    _check_updates(model, before, jafter, opt.schedule(1))


def test_layered_steps_and_gradients():
    """Two layered steps at `--tiny` (2 refinement iterations, batch 2), and
    each step's gradients per leaf (F8: JAX stops the gradient through the
    track estimates at each iteration, and so must the port)."""
    args = _args("--curriculum", "layered", "--arch", "cotracker3", "--tiny", "--steps",
                 str(STEPS), "--size", "32", "--width", "48", "--batch", "2", "--frames", "4",
                 "--points", "8")
    model, cfg, opt, tstep = tcli.build_layered(args)
    assert cfg.model_resolution == (32, 48) and cfg.iters == 2
    batches = [_layered_batch(2, 4, 32, 48, 8, seed=s) for s in (5, 6)]
    jm = jct.CoTracker3Offline(_jax_cfg(cfg))
    params = jax_param_tree(jm, jnp.asarray(batches[0][0][0]), jnp.asarray(batches[0][1][0]),
                            seed=5)
    tx = _recording(_jax_adamw(args.lr, args.steps, 200, 1.0))
    jstep = jcli.build_train_step_occl(jm, tx, conf_thr=max(12.0 * 32 / 384.0, 3.0))
    _port_model(model, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads = _recorded_grads(opt, model)
    out, jafter = _two_steps(jstep, params, tx.init(params), tstep, batches)
    for (jl, tl, ja, ta, jstate), g in zip(out, grads):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL_ITERS2)
        np.testing.assert_allclose(ta, ja, atol=AUX_ATOL)
        _check_grads(g, jstate[0], cfg.hidden_size)
    _check_updates(model, before, jafter, opt.schedule(1), cfg.hidden_size)


def test_flax_tree_is_jaxs():
    """F9: `flax_tree_from_torch` of the port's CoTracker3 has JAX's keys and
    shapes (`kernel` in flax's layouts, LayerNorm `scale`)."""
    cfg = tct.tiny_cotracker3_config()
    jm = jct.CoTracker3Offline(_jax_cfg(cfg))
    mh, mw = cfg.model_resolution
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((2, mh, mw, 3)),
                          jnp.zeros((4, 3)))
    tree = flax_tree_from_torch(tct.CoTracker3Offline(cfg))

    def shapes(t):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), t)

    assert shapes(tree) == shapes(like["params"])


def test_save_cotracker3_both_ways(tmp_path):
    """F9: the port's file through JAX's `load_cotracker3` and JAX's through
    the port's, each bit-equal to the weights rounded to f16."""
    cfg = tct.tiny_cotracker3_config()
    model = tct.CoTracker3Offline(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    port_file = str(tmp_path / "port.npz")
    tct.save_cotracker3(port_file, model, cfg)
    jparams, jcfg = jct.load_cotracker3(port_file)
    assert jcfg == _jax_cfg(cfg)
    want = {k: v.numpy().astype(np.float16).astype(np.float32)
            for k, v in model.state_dict().items()}
    got = torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)

    jm = jct.CoTracker3Offline(_jax_cfg(cfg))
    mh, mw = cfg.model_resolution
    params = jax_param_tree(jm, jnp.zeros((2, mh, mw, 3)), jnp.zeros((4, 3)), seed=6)
    jax_file = str(tmp_path / "jax.npz")
    jct.save_cotracker3(jax_file, params, jm.cfg)
    back, back_cfg = tct.load_cotracker3(jax_file, device="cpu")
    assert back_cfg == cfg
    want = torch_state_dict_from_flax(jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float16).astype(np.float32), params))
    for k, v in back.state_dict().items():
        assert torch.equal(v, want[k]), k
    # a tree goes out as a module does
    tree_file = str(tmp_path / "tree.npz")
    tct.save_cotracker3(tree_file, flax_tree_from_torch(model), cfg)
    with np.load(tree_file) as a, np.load(port_file) as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)


def _jax_occl_loss(jm, params, frames, queries, gt, vis, conf_thr, gamma=0.8):
    """The JAX script's layered loss (`build_train_step_occl`'s `loss_fn`,
    held equal to the port's by the gradient test) on JAX's forward, without
    the gradient (compiling the small model's backward takes ~30 s here)."""
    from scripts.train_cotracker import _bce, _huber

    out = jax.vmap(lambda f, q: jm.apply(params, f, q))(frames, queries)
    tracks = out["tracks"]
    w = gamma ** jnp.arange(tracks.shape[1] - 1, -1, -1, dtype=jnp.float32)
    per_iter = _huber(tracks - gt[:, None]).mean(axis=(0, 2, 3, 4))
    visf = vis.astype(jnp.float32)
    dist = jnp.linalg.norm(tracks[:, -1] - gt, axis=-1)
    conf = _bce(out["conf"], (dist < conf_thr).astype(jnp.float32))
    return jnp.sum(w * per_iter) / jnp.sum(w) + 0.1 * (_bce(out["vis"], visf) + conf)


def test_resume_shipped_small_first_step_loss():
    """`--resume cotracker3_small.npz --preset small` (bf16): the loss the
    port's first step takes (`occl_loss` of the resumed model, without the
    backward) on one batch equals JAX's loss of `load_params` of the file,
    and differs from the loss of the port's fresh initialisation."""
    argv = ["--curriculum", "layered", "--arch", "cotracker3", "--preset", "small", "--steps",
            str(STEPS), "--size", "64", "--width", "96", "--train-iters", "1", "--batch", "1",
            "--frames", "4", "--points", "8"]
    args = _args(*argv, "--resume", SHIPPED)
    model, cfg, _, _ = tcli.build_layered(args)
    assert cfg.compute_dtype == "bfloat16" and cfg.latent_dim == 96
    batch = _layered_batch(1, 4, 64, 96, 8, seed=8)
    jm = jct.CoTracker3Offline(_jax_cfg(cfg))
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(batch[0][0]),
                          jnp.asarray(batch[1][0]))
    params = jlite.load_params(SHIPPED, like)
    jloss = jax.jit(_jax_occl_loss, static_argnums=(0, 6))(
        jm, params, *map(jnp.asarray, batch), 3.0)
    conf_thr = max(12.0 * cfg.model_resolution[0] / 384.0, 3.0)  # the CLI's
    with torch.no_grad():
        loss, _ = tcli.occl_loss(model, *_torch(*batch), conf_thr=conf_thr)
        fresh, _ = tcli.occl_loss(tcli.build_layered(_args(*argv))[0], *_torch(*batch),
                                  conf_thr=conf_thr)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RESUME_RTOL)
    assert abs(fresh.item() - float(jloss)) > 10 * RESUME_RTOL * float(jloss)


def test_cli_layered_and_resume(tmp_path, capsys):
    """The layered CLI at --tiny for 3 steps, its file read by JAX's
    `load_cotracker3`, then resumed for 2 more."""
    out = str(tmp_path / "ct3.npz")
    common = ["--curriculum", "layered", "--arch", "cotracker3", "--tiny", "--batch", "2",
              "--frames", "4", "--points", "8", "--pool-size", "4", "--out", out,
              "--device", "cpu"]
    first = tcli.main([*common, "--steps", "3"])
    assert len(first["losses"]) == 3 and np.isfinite(first["losses"]).all()
    assert sum(first["fresh"]) >= 2 and set(first["report"]) == set(jsynth.BENCH_CASES)
    jparams, jcfg = jct.load_cotracker3(out)
    assert jcfg.model_resolution == (64, 96)
    second = tcli.main([*common, "--steps", "2", "--resume", out])
    assert "resumed from" in capsys.readouterr().out and np.isfinite(second["losses"]).all()


@pytest.mark.parametrize("arch", ["lite", "cotracker3"])
def test_cli_flat(tmp_path, arch):
    out = str(tmp_path / f"{arch}.npz")
    res = tcli.main(["--arch", arch, "--tiny", "--steps", "2", "--frames", "4", "--points",
                     "6", "--size", "32", "--out", out, "--device", "cpu"])
    assert len(res["losses"]) == 2 and np.isfinite(res["held_out_px"])
    model = res["model"]
    if arch == "lite":  # JAX's load_params reads the file into its tree
        jm = jlite.CoTrackerLite(**TINY_LITE)
        like = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((4, 32, 32, 3)),
                              jnp.zeros((6, 3)))
        got = torch_state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, jlite.load_params(out, like)))
        for k, v in model.state_dict().items():
            assert torch.equal(got[k], v.cpu()), k


def _jax_bench(argv, monkeypatch, capsys):
    """The JAX script's JSON. Its random initialisation, which `--ckpt`
    overwrites leaf by leaf, is taken abstractly (a flax `init` of the
    tracker takes ~25 s here)."""
    init = jct.CoTracker3Offline.init

    def abstract_init(self, rng, *args):
        shapes = jax.eval_shape(lambda: init(self, rng, *args))
        return jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)

    monkeypatch.setattr(jct.CoTracker3Offline, "init", abstract_init)
    monkeypatch.setattr(sys, "argv", ["bench_stom_synth.py", *argv])
    jbench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("backend", ["lk", "cotracker3"])
def test_bench_stom_synth(backend, tmp_path, monkeypatch, capsys):
    argv = ["--backend", backend]
    if backend == "cotracker3":
        cfg = jct.tiny_cotracker3_config()
        jm = jct.CoTracker3Offline(cfg)
        params = jax_param_tree(jm, jnp.zeros((8, 64, 64, 3)), jnp.zeros((16, 3)), seed=9,
                                std=0.05)
        ckpt = str(tmp_path / "ct3.npz")
        jlite.save_params(ckpt, params)
        argv += ["--tiny", "--ckpt", ckpt]
    want = _jax_bench(argv, monkeypatch, capsys)
    got = tbench.main([*argv, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == got
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert v.keys() == got[k].keys()
            np.testing.assert_allclose([got[k][m] for m in v], list(v.values()), atol=2e-3,
                                       err_msg=k)
        else:
            assert got[k] == v, k


def test_clip_pool_takes_every_clip_once_and_stops():
    """The producer thread against the consumer under a short switch
    interval: the clips taken in are the producer's stream in order, none
    lost or repeated; close() joins the thread; a producer's error is
    raised by next_batch."""
    counter = iter(range(10 ** 6))

    def make(rng):
        i = next(counter)
        return (np.full((2,), i), np.zeros(1), np.zeros(1), np.zeros(1))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = tcli.ClipPool(make, np.random.default_rng(0), pool_size=6, batch=2)
        seen = []
        for _ in range(200):
            before = len(pool.pool)
            batch = pool.next_batch(np.random.default_rng(1))
            assert batch[0].shape == (2, 2)
            seen.append(pool.fresh)
            assert len(pool.pool) >= min(before, 3)
        pool.close()
        assert not pool._thread.is_alive()
    finally:
        sys.setswitchinterval(interval)
    # every clip taken is in the pool or was replaced, in stream order: the
    # largest id taken is fresh - 1
    assert max(int(c[0][0]) for c in pool.pool) == pool.fresh - 1
    assert seen == sorted(seen) and pool.fresh >= 3

    def failing(rng):
        raise OSError("no texture")

    pool = tcli.ClipPool(failing, np.random.default_rng(0), pool_size=4, batch=2)
    try:
        with pytest.raises(RuntimeError, match="clip producer failed"):
            pool.next_batch(np.random.default_rng(0))
    finally:
        pool.close()
