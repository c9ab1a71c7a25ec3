"""The port's `parallel/` slice on the CPU: the mesh, the fsdp sharding rule,
the train step over gloo ranks, the optax carry and the kernel wrappers'
device.

* the rank grid of `mesh_rank_array` is the JAX package's
  `mesh_device_array` on the fake multi-slice pods of
  `tests/test_mesh_topology.py` (a node for a slice), including its refusal
  of fsdp across nodes;
* `infer_param_sharding` gives every trainable tensor of the tiny UniGR the
  fsdp dimension JAX's shards, at fsdp 2, 4 and 8 (JAX on the 8 virtual CPU
  devices): the dimension is checked through the weight bridge's own layout
  transform, by converting an array that counts along JAX's dimension;
* 2 gloo ranks over (data 2) and over (fsdp 2), grad accum 1 and 2, 2
  ranks that each take the one row of a 1-row micro-batch, and 4 ranks over
  (data 2 x fsdp 2) on 2-row micro-batches (each fsdp pair on one row),
  against one process over 3 steps (f32, lr 1e-3, the first step at lr 0), on
  micro-batches whose ranks hold different label-token and valid-mask
  counts, one rank none in the first: the aux trace within 1e-6 relative,
  each trainable tensor's move (final minus start) within 1e-5 of its
  scale (L2 norms: the moves' difference against the tensor's; Adam divides
  by the root of each element's second moment, so an element whose
  gradient is small against its rounding takes a step a percent off, 1.06e-5
  of the embedding's largest element in one of 9.7M measured), the same
  elements moved, both ranks' tensors bit-equal, the frozen ones unchanged;
* the 2-rank (data 2) run against JAX's `build_train_step` under
  `make_mesh(MeshConfig(data=2, fsdp=4))` on the same global batch, at
  `tests/test_torch_train.py`'s tolerances (losses 1e-5, parameters within
  3 sums of the learning rates);
* JAX's optax state after 2 steps carried into the port
  (`convert.load_optax_state`): the port's third step equals JAX's third
  (parameters within 1e-5, mu and nu within 1e-6; bf16 mu per tensor, in
  L2 within 1e-2 of its norm), with mu in f32 and in bf16;
* the fsdp-2 state saved by rank 0 as whole tensors in one file, restored
  bit for bit by both ranks into a fresh sharded state and by one process
  into an unsharded one;
* `AverageMeter.all_reduce`, `broadcast_scalar`, `replicate_to_host` and
  the row split over 2 ranks; the rank grid of a mesh with a tensor axis;
* every kernel wrapper hands the library the device of its tensors and the
  current stream there, and raises ValueError on tensors of two devices
  before anything launches (a stub library on the CPU).
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rga3_tpu.config import MeshConfig as JaxMeshConfig
from rga3_tpu.config import SegHeadConfig as JaxSegHead, TrainConfig as JaxTrainConfig
from rga3_tpu.data import collate as jc
from rga3_tpu.data.processor import ChatMessage as JaxMessage, QwenVLProcessor as JaxProcessor
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.sam2 import tiny_sam2_config as jax_tiny_sam2
from rga3_tpu.models.unigr import UniGR as JaxUniGR, UniGRConfig as JaxUniGRConfig
from rga3_tpu.parallel.mesh import make_mesh as jax_make_mesh, mesh_device_array
from rga3_tpu.parallel.sharding import infer_param_sharding as jax_infer_param_sharding
from rga3_tpu.train import optimizer as jopt
from rga3_tpu.train.step import build_train_step as jax_build_train_step
from rga3_tpu.train.step import make_train_state as jax_make_train_state
from rga3_tpu_torch import convert
from rga3_tpu_torch.config import MeshConfig, SegHeadConfig, TrainConfig
from rga3_tpu_torch.data import collate as tc
from rga3_tpu_torch.data.processor import ChatMessage, QwenVLProcessor
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
from rga3_tpu_torch.ops import _kernels
from rga3_tpu_torch.ops import attention as tatt
from rga3_tpu_torch.ops import fused_block as fb
from rga3_tpu_torch.ops import quant as tq
from rga3_tpu_torch.parallel import (
    infer_param_sharding, make_mesh, mesh_rank_array, shard_batch_spec,
)
from rga3_tpu_torch.parallel.mesh import Mesh, batch_axes
from rga3_tpu_torch.train import checkpoints
from rga3_tpu_torch.train import optimizer as topt
from rga3_tpu_torch.train.checkpoints import CheckpointManager
from rga3_tpu_torch.train.step import make_train_state

import torch_dist_support as tds
from torch_port_support import jax_param_tree

SEG_ID = 151665
T = 2
KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28, video_max_pixels=16 * 28 * 28)
BUDGET = 128  # vision patches a sample
TRAIN = dict(lr=1e-3, epochs=1, steps_per_epoch=10, warmup_ratio=0.1, grad_clip=1.0)
LOSS_KEYS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss", "mask_loss")
# two global micro-batches of 4 rows; under 2 ranks rows 0-1 go to rank 0:
# in the first, rank 0 holds no valid mask (no [SEG] in row 0, no masks in
# row 1); every row's answer has its own length
ANSWERS = ["no object here .", "it is not in this video at all , sorry about that .",
           "[SEG] .", "sure it is [SEG] .",
           "sure , the one on the left [SEG] .", "nothing .", "[SEG] .",
           "it is the red one moving away [SEG] ."]
HAS_MASKS = [True, False, True, True, True, False, True, True]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port's side on 2 torch threads, as each spawned rank runs (the
    driver runs several test workers at once; restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the rank grid against the JAX package's device mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FakeDevice:
    id: int
    process_index: int
    slice_index: int
    platform: str = "cpu"
    device_kind: str = "cpu"


def _pod(n_slices, per_slice):
    return [FakeDevice(s * per_slice + i, s, s) for s in range(n_slices) for i in range(per_slice)]


LAYOUTS = [(2, 4, (2, 4, 1)), (2, 4, (4, 2, 1)), (2, 4, (2, 2, 2)), (1, 8, (2, 4, 1)),
           (4, 2, (4, 2, 1)), (2, 4, (1, 8, 1)), (2, 4, None)]


@pytest.mark.parametrize("n_slices,per_slice,shape", LAYOUTS,
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_mesh_rank_array_matches_jax(n_slices, per_slice, shape):
    devs = _pod(n_slices, per_slice)
    nodes = [f"node{d.slice_index}" for d in devs]
    if shape is None:  # the default config of each package
        want = np.asarray(jax_make_mesh(None, devices=devs).devices)
        got = make_mesh(None, nodes=nodes)
        assert got.cfg == MeshConfig(data=n_slices, fsdp=per_slice)
        assert np.array_equal(np.vectorize(lambda d: d.id)(want), got.ranks)
        return
    cfg = dict(zip(("data", "fsdp", "tensor"), shape))
    try:
        want = mesh_device_array(JaxMeshConfig(**cfg), devs)
    except ValueError as e:
        assert "slice count" in str(e)
        with pytest.raises(ValueError, match="node count"):
            mesh_rank_array(MeshConfig(**cfg), nodes)
        return
    got = mesh_rank_array(MeshConfig(**cfg), nodes)
    assert np.array_equal(np.vectorize(lambda d: d.id)(want), got)


def test_mesh_axes_rows_and_tensor_axis():
    assert batch_axes({"data": 2, "fsdp": 4}, 8) == ("data", "fsdp")
    assert batch_axes({"data": 2, "fsdp": 4}, 4) == "data"
    assert batch_axes({"data": 1, "fsdp": 2}, 2) == ("data", "fsdp")
    assert batch_axes({"data": 2, "fsdp": 3}, 3) == "fsdp"
    assert batch_axes({"data": 2, "fsdp": 2}, 3) is None
    shape = {"data": 2, "fsdp": 4, "tensor": 1}
    assert shard_batch_spec(Mesh(MeshConfig(**shape), np.arange(8).reshape(2, 4, 1))) == (
        "data", "fsdp")
    assert shard_batch_spec(Mesh(MeshConfig(fsdp=2), np.arange(2).reshape(1, 2, 1))) == "fsdp"
    assert shard_batch_spec(Mesh(MeshConfig(data=2), np.arange(2).reshape(2, 1, 1))) == "data"
    mesh = Mesh(MeshConfig(data=2, fsdp=2), np.arange(4).reshape(2, 2, 1), rank=3)
    assert mesh.coords == (1, 1, 0)
    assert mesh.rows(8) == (slice(6, 8), ("data", "fsdp"))
    assert mesh.rows(6) == (slice(3, 6), "data") and mesh.replicas("data") == 2
    assert mesh.rows(3) == (slice(0, 3), None) and mesh.replicas(None) == 4
    # the tensor axis: the rank grid without a process group (its groups over
    # gloo ranks: tests/test_torch_tensor_parallel.py)
    tmesh = make_mesh(MeshConfig(fsdp=2, tensor=2), nodes=["a"] * 4)
    assert tmesh.ranks.tolist() == [[[0, 1], [2, 3]]] and tmesh.groups == {}
    assert Mesh(MeshConfig(fsdp=2, tensor=2), tmesh.ranks, rank=3).coords == (0, 1, 1)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(MeshConfig(data=2))  # one process


# ---------------------------------------------------------------------------
# (b) the fsdp dimension of every trainable tensor
# ---------------------------------------------------------------------------

def _lora(cfg):
    return cfg.replace(text=cfg.text.replace(lora_rank=8, lora_alpha=16.0))


@pytest.fixture(scope="module")
def models():
    jcfg = JaxUniGRConfig(qwen=_lora(jax_tiny_config(152_000)), sam2=jax_tiny_sam2(64),
                          seg=JaxSegHead(out_dim=32, seg_token_id=SEG_ID))
    jm = JaxUniGR(jcfg)
    params = jax_param_tree(jm, jnp.zeros((T, 64, 64, 3)), jnp.zeros((T, 1, 32)),
                            jnp.zeros((1, 8), jnp.int32), seed=3)
    cfg = UniGRConfig(qwen=_lora(tiny_config(152_000)), sam2=tiny_sam2_config(64),
                      seg=SegHeadConfig(out_dim=32, seg_token_id=SEG_ID))
    return jm, jcfg, params, cfg


@pytest.mark.parametrize("fsdp", [2, 4, 8])
def test_infer_param_sharding_matches_jax(models, fsdp):
    _, _, params, cfg = models
    jmesh = jax_make_mesh(JaxMeshConfig(data=8 // fsdp, fsdp=fsdp))
    specs = jax_infer_param_sharding({"params": params}, jmesh)["params"]
    mask = jopt.trainable_mask({"params": params})["params"]
    model = UniGR(cfg, device="meta")
    mesh = Mesh(MeshConfig(data=8 // fsdp, fsdp=fsdp), np.arange(8).reshape(8 // fsdp, fsdp, 1))
    got = {name: dims[1] for name, dims in infer_param_sharding(model, mesh).items()}

    def marker(spec, p):
        """An array of p's shape counting 1, 2, ... along JAX's fsdp dim (0
        where JAX shards nothing)."""
        dims = [i for i, a in enumerate(spec.spec) if a == "fsdp"]
        if not dims:
            return np.zeros(np.shape(p), np.float32)
        shape = [1] * np.ndim(p)
        shape[dims[0]] = np.shape(p)[dims[0]]
        counts = np.arange(1, shape[dims[0]] + 1, dtype=np.float32).reshape(shape)
        return np.broadcast_to(counts, np.shape(p)).copy()

    markers = convert.torch_state_dict_from_flax(jax.tree.map(marker, specs, params))
    flags = convert.torch_state_dict_from_flax(jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params))
    trainable = [n for n in markers if bool(flags[n].all())]
    sharded = 0
    for name in trainable:
        t = markers[name]
        dim = got[name]
        if not t.any():
            assert dim is None, (name, dim)
            continue
        sharded += 1
        assert dim is not None, name
        # the counts vary along the port's dim only
        other = t.movedim(dim, 0).reshape(t.shape[dim], -1)
        assert (other == other[:, :1]).all() and len(set(other[:, 0].tolist())) == t.shape[dim], (
            name, dim)
    assert sharded > len(trainable) // 2, (sharded, len(trainable))


# ---------------------------------------------------------------------------
# (c)-(f) the train step over ranks
# ---------------------------------------------------------------------------

def _samples(mod, message):
    rng = np.random.default_rng(11)
    out = []
    for i, answer in enumerate(ANSWERS):
        frames = [rng.integers(0, 256, (56, 84, 3), dtype=np.uint8) for _ in range(2)]
        out.append(mod.TrainSample(
            sample_id=str(i),
            messages=[message("user", [{"type": "video"},
                                       {"type": "text", "text": f"segment the thing {i}"}]),
                      message("assistant", [{"type": "text", "text": answer}])],
            video_frames=frames,
            sam_frames=rng.integers(0, 256, (T, 64, 64, 3), dtype=np.uint8),
            gt_masks=(rng.random((T, 48, 56)) > 0.5).astype(np.float32),
            has_masks=HAS_MASKS[i],
        ))
    return out


def _micro(c):
    mb = {k: c[k] for k in ("input_ids", "labels", "position_ids", "images_sam", "gt_masks",
                            "masks_valid", "pixel_patches")}
    mb["segment_ids"] = c["attention_mask"].astype(np.int32)
    mb["vision_layout"] = c["vision_layout"]
    return mb


def _collate(samples, qcfg):
    proc = QwenVLProcessor.from_pretrained("dummy", **KW)
    return _micro(tc.collate(samples, proc, qcfg, vision_budget_tokens=len(samples) * BUDGET))


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    """The reference (one process) and the 2-rank run of every
    configuration, and the JAX package's mesh-sharded steps."""
    jm, jcfg, params, cfg = models
    tmp = tmp_path_factory.mktemp("parallel")
    sd = convert.torch_state_dict_from_flax(params)
    torch.save(sd, tmp / "sd.pt")
    samples = _samples(tc, ChatMessage)
    micro = [samples[:4], samples[4:]]

    def per_rank(groups, rows):  # each rank collates its own rows
        return [[_collate(g[r * rows:(r + 1) * rows], cfg.qwen) for g in groups]
                for r in range(2)]

    configs = {
        "data2-accum1": (dict(data=2), micro[:1], 2),
        "data2-accum2": (dict(data=2), micro, 2),
        "fsdp2-accum1": (dict(fsdp=2), micro[:1], 2),
        "fsdp2-accum2": (dict(fsdp=2), micro, 2),
        # a 1-row micro-batch: the ranks do not divide it and both take it
        "fsdp2-replicated": (dict(fsdp=2), [samples[2:3], samples[4:5]], None),
    }
    runs_, full = [], {}
    for name, (mesh, groups, rows) in configs.items():
        batches = (per_rank(groups, rows) if rows else
                   [[_collate(g, cfg.qwen) for g in groups]] * 2)
        runs_.append({"name": name, "mesh": mesh, "batches": batches,
                      "rows": len(groups[0])})
        full[name] = (tuple(tuple(s.sample_id for s in g) for g in groups), groups)
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump({"sd": str(tmp / "sd.pt"), "cfg": cfg, "train": TRAIN, "runs": runs_,
                     "checkpoint": "fsdp2-accum2"}, f)
    # 4 ranks, data 2 x fsdp 2, on micro-batches of 2 rows: data splits
    # them, each fsdp pair takes the same row (2 replicas)
    groups4 = [samples[2:4], samples[4:6]]
    halves = [[_collate(g[r:r + 1], cfg.qwen) for g in groups4] for r in range(2)]
    (tmp / "four").mkdir()
    with open(tmp / "four" / "job.pkl", "wb") as f:
        pickle.dump({"sd": str(tmp / "sd.pt"), "cfg": cfg, "train": TRAIN, "runs": [
            {"name": "data2-fsdp2", "mesh": dict(data=2, fsdp=2), "rows": 2,
             "batches": [halves[0], halves[0], halves[1], halves[1]]}]}, f)
    full["data2-fsdp2"] = (tuple(tuple(s.sample_id for s in g) for g in groups4), groups4)
    ranks = tds.Ranks(tds.train_ranks, 2, str(tmp / "job.pkl"), str(tmp))
    four = tds.Ranks(tds.train_ranks, 4, str(tmp / "four" / "job.pkl"), str(tmp / "four"))
    try:  # one process on the same global micro-batches, meanwhile
        reference, seen = {}, {}
        for name, (key, groups) in full.items():
            if key not in seen:
                batches = [_collate(g, cfg.qwen) for g in groups]
                seen[key] = tds.train_run(cfg, sd, TRAIN, None, batches, len(groups[0]))[:3]
            reference[name] = seen[key]
    finally:
        ranks = ranks.results()
        four = four.results()
    ported = {name: torch.load(tmp / f"{name}.pt") for name in configs}
    ported["data2-fsdp2"] = torch.load(tmp / "four" / "data2-fsdp2.pt")

    return {"sd": sd, "cfg": cfg, "reference": reference, "ranks": ranks, "four": four,
            "ported": ported,
            "port_batch": _collate(samples[:4], cfg.qwen), "ckpt": tmp / "ckpt"}


def _jax_loss(jm, p, mb):
    return jm.apply(p, *(mb[k] for k in tds.BATCH_KEYS), pixel_patches=mb["pixel_patches"],
                    vision_layout=mb["vision_layout"], compute_dtype=jnp.float32,
                    method=JaxUniGR.train_forward)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_steps(models, mu_dtype):
    """JAX's `build_train_step` under `make_mesh(MeshConfig(data=2,
    fsdp=4))`, 3 steps on the global micro-batch of data2-accum1 (Adam's mu
    in `adam_mu_dtype`): the aux of each step, the parameters and the optax
    state after steps 2 and 3."""
    jm, jcfg, params, _ = models
    jproc = JaxProcessor.from_pretrained("dummy", **KW)
    batch = _micro(jc.collate(_samples(jc, JaxMessage)[:4], jproc, jcfg.qwen,
                              vision_budget_tokens=4 * BUDGET))
    mesh = jax_make_mesh(JaxMeshConfig(data=2, fsdp=4))
    with mesh:
        state, tx = jax_make_train_state(JaxTrainConfig(**TRAIN, adam_mu_dtype=mu_dtype),
                                         {"params": params}, mesh)
        step = jax_build_train_step(lambda p, mb: _jax_loss(jm, p["params"], mb), tx,
                                    grad_accum_steps=1, donate=False)
        stacked = jax.tree.map(lambda x: x[None], batch)
        out = {"mu_dtype": mu_dtype, "aux": [], "states": []}
        for _ in range(3):
            state, aux = step(state, stacked)
            out["aux"].append({k: float(v) for k, v in aux.items()})
            train = state.opt_state.inner_states["train"].inner_state
            adam, sched = train[1][0], train[1][2]
            out["states"].append({
                "params": _numpy(state.params["params"]),
                # the optax trees hold the step's {"params": params} (and
                # jax_param_tree's params have a "params" level of their own)
                "optax": {"train": {"mu": _numpy(adam.mu["params"]),
                                    "nu": _numpy(adam.nu["params"]),
                                    "count": np.asarray(adam.count),
                                    "schedule_count": np.asarray(sched.count)}}})
    return out


@pytest.fixture(scope="module")
def jax_f32(models):
    return _jax_steps(models, "float32")


@pytest.fixture(scope="module")
def jax_bf16(models):
    return _jax_steps(models, "bfloat16")


def test_two_ranks_match_jax_mesh_step(runs, jax_f32):
    """The 2-rank (data 2) port against JAX's mesh-sharded step: the aux
    trace within 1e-5, the trainable tensors within 3 sums of the lrs, the
    frozen ones as they were in both."""
    jax_run = jax_f32
    trace = runs["ranks"][0]["data2-accum1"]["trace"]
    for a, b in zip(trace, jax_run["aux"]):
        for k in LOSS_KEYS:
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (k, a[k], b[k])
    bound = 3 * sum(a["lr"] for a in trace)
    want = convert.torch_state_dict_from_flax(jax_run["states"][-1]["params"])
    got = runs["ported"]["data2-accum1"]
    for name, t in got.items():
        assert (t - want[name]).abs().max().item() <= bound, name
    for name in set(want) - set(got):
        assert torch.equal(want[name], runs["sd"][name]), name


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_optax_state_carries_into_the_port(runs, mu_dtype, request):
    """JAX's state after 2 steps in the port, one more step on the same
    batch: the parameters within 1e-5 of JAX's third step, mu and nu within
    1e-6 (times each tensor's scale where it exceeds 1; a key bias's
    moments are rounding noise of ~1e-14), mu in `adam_mu_dtype` on both
    sides. In f32 the moments agree within ~1e-8. bf16 mu cannot be held
    element by element: where the two packages' f32 values straddle a
    rounding boundary they land one bf16 ulp apart (513 of the embedding's
    9.7M elements in one run, up to 1.2e-4), and from run to run of this CPU
    test a rare element of a LoRA factor lands further (one was 1.07e-6, 10%
    of its value, apart). A carry that misplaced mu (zeroed, transposed,
    another tensor's) would be off by the order of mu itself, so bf16 mu is
    held per tensor: the L2 norm of the difference within 1e-2 of mu's
    (plus 1e-6, for the key biases' rounding noise)."""
    jax_run = request.getfixturevalue({"float32": "jax_f32", "bfloat16": "jax_bf16"}[mu_dtype])
    cfg, batch = runs["cfg"], runs["port_batch"]
    before, after = jax_run["states"][1], jax_run["states"][2]
    sd = convert.torch_state_dict_from_flax(before["params"])
    train = dict(TRAIN, adam_mu_dtype=jax_run["mu_dtype"])
    trace, trainable, kept, state = tds.train_run(cfg, sd, train, None, [batch], 4, steps=1,
                                                  optax_state=before["optax"])
    opt = state.opt
    assert kept and opt.count == 3
    assert opt.mu[next(iter(opt.mu))].dtype == topt.DTYPES[jax_run["mu_dtype"]]
    for k in LOSS_KEYS:
        want = jax_run["aux"][2][k]
        assert abs(trace[0][k] - want) <= 1e-5 * max(1.0, abs(want)), k
    assert trace[0]["lr"] == pytest.approx(jax_run["aux"][2].get("lr", trace[0]["lr"]))
    want = convert.torch_state_dict_from_flax(after["params"])
    for name, t in trainable.items():
        assert (t - want[name]).abs().max().item() <= 1e-5, name
    for kind in ("mu", "nu"):
        ref = convert._moment_tensors(after["optax"]["train"][kind])
        for name, t in getattr(opt, kind).items():
            w = torch.from_numpy(ref[name])
            diff = (t.float() - w).abs()
            tol = 1e-6 * max(w.abs().max().item(), 1.0)
            if t.dtype == torch.bfloat16:
                # see the docstring: held as a whole tensor
                err = (t.float() - w).norm().item()
                assert err <= 1e-2 * w.norm().item() + 1e-6, (kind, name, err, w.norm().item())
                continue
            assert diff.max().item() <= tol, (kind, name, diff.max().item())


def test_load_optax_state_refuses_what_does_not_fit(runs, jax_f32):
    cfg = runs["cfg"]
    state = jax_f32["states"][0]["optax"]
    model = UniGR(cfg, device="cpu")
    opt = topt.build_optimizer(topt.TrainConfig(**TRAIN), model)
    with pytest.raises(KeyError, match="train"):
        convert.load_optax_state(opt, {"freeze": {}})
    with pytest.raises(KeyError, match="nu"):
        convert.load_optax_state(opt, {"train": {k: v for k, v in state["train"].items()
                                                 if k != "nu"}})
    bad = jax.tree.map(lambda x: x, state)
    bad["train"]["mu"]["params"]["text_hidden_fcs"]["fc1"]["kernel"] = np.zeros((3, 3),
                                                                              np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.load_optax_state(opt, bad)
    assert opt.count == 0


# ---------------------------------------------------------------------------
# (g) the kernel wrappers launch on their tensors' device
# ---------------------------------------------------------------------------

class StubLibrary:
    """Records each entry point's arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_words"):
            return lambda *args: 64
        return lambda *args: self.calls.append((name, args)) or 0


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


LAUNCHES = {
    "flash_attention": lambda x: tatt._flash_forward(x, x, x, None, None, False, 0.25, True),
    "flash_attention_bwd": lambda x: tatt._flash_backward(
        x, x, x, x, torch.zeros(1, 2, 64), x, None, None, False, 0.25),
    "window_attention": lambda x: tatt._window_forward(x, x, x, 16, 16, 0.25),
    "gemm": lambda x: fb._gemm(_bf16(64, 16), _bf16(32, 16), _bf16(32), "bias"),
    "layer_norm": lambda x: fb._layer_norm(_bf16(64, 16), _bf16(16), _bf16(16), 1e-6),
    "window_pool2x2": lambda x: fb._window_pool2x2(_bf16(1, 64, 16), 8),
    "int4_matmul": lambda x: tq._int4_launch(_bf16(2, 128), torch.zeros(64, 48, dtype=torch.int8),
                                             torch.zeros(4, 48)),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_kernel_wrappers_launch_on_their_tensors_device(name, monkeypatch):
    lib = StubLibrary()
    streams = []

    class Stream:
        cuda_stream = 12345

    def current_stream(device):
        streams.append(device)
        return Stream()

    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(tq, "_sm_count", lambda index: 132)
    x = _bf16(1, 64, 2, 16)
    try:
        LAUNCHES[name](x)
        (entry, args), = lib.calls
        assert entry.startswith("rga3_")
        # the device of the tensors first, their device's current stream last
        assert args[0] == x.get_device() and args[-1] == 12345
        assert streams == [torch.device("cpu")]
        # tensors on two devices: ValueError before the library is asked
        lib.calls.clear()
        meta = torch.empty(1, device="meta")
        with pytest.raises(ValueError, match="different devices"):
            _kernels.launch_on(name, x, meta)
        with pytest.raises(ValueError, match="different devices"):
            _kernels.launch_on(name, x, None, meta)
        assert lib.calls == []
    finally:
        tatt.reset_launches()


@pytest.mark.parametrize("name", ["data2-accum1", "data2-accum2", "fsdp2-accum1",
                                  "fsdp2-accum2", "fsdp2-replicated", "data2-fsdp2"])
def test_ranks_match_one_process(runs, name):
    trace, trainable, kept = runs["reference"][name]
    sd = runs["sd"]
    records = [rank[name] for rank in runs["four" if name == "data2-fsdp2" else "ranks"]]
    assert kept
    for got in records:
        assert got["frozen_kept"]
        assert len(got["trace"]) == len(trace) == 3
        for step, (a, b) in enumerate(zip(got["trace"], trace)):
            for k in LOSS_KEYS:
                assert abs(a[k] - b[k]) <= 1e-6 * max(abs(b[k]), 1e-12), (name, step, k, a[k], b[k])
            assert a["lr"] == b["lr"]
    # every rank holds the same bits; ZeRO shards the state under fsdp only,
    # and each rank's blocks gathered whole (replicate_to_host) are them
    assert len({got["digest"] for got in records}) == 1
    assert all(got["gathered"] for got in records)
    sharded = records[0]["sharded"]
    assert (len(sharded) > 10) == ("fsdp" in name), sharded
    ported = runs["ported"][name]
    moved = 0
    for n, want in trainable.items():
        start = sd[n]
        err = ((ported[n] - start) - (want - start)).norm().item()
        assert err <= 1e-5 * want.norm().item(), (name, n, err, want.norm().item())
        # a tensor the loss does not reach (the IoU head) stays in both
        assert torch.equal(ported[n], start) == torch.equal(want, start), (name, n)
        moved += int(not torch.equal(want, start))
    assert moved > len(trainable) // 2
    # the first micro-batch's rank 0 held no valid mask: the mask losses are
    # the other rank's rows over the global count
    assert trace[1]["mask_loss"] > 0 and trace[1]["ce_loss"] > 0


def test_sharded_checkpoint_resumes_at_any_world_size(runs):
    """The fsdp-2 state written by rank 0 (whole tensors, one file), read
    back by both ranks into a fresh sharded state bit for bit, and by one
    process into an unsharded one."""
    got = [rank["checkpoint"] for rank in runs["ranks"]]
    assert got[0] == got[1]
    assert got[0]["restored"] == got[0]["saved"] and (got[0]["count"], got[0]["step"]) == (3, 3)
    want = runs["ported"]["fsdp2-accum2"]
    assert got[0]["params"] == tds.digest(want)
    files = sorted(p.relative_to(runs["ckpt"]).as_posix() for p in runs["ckpt"].rglob("*")
                   if p.is_file())
    assert files == ["ckpt_latest/state.safetensors", "meta_log_info.json"], files
    model = UniGR(runs["cfg"], device="cpu")
    model.load_state_dict(runs["sd"], strict=True)
    state, _ = make_train_state(TrainConfig(**TRAIN), model)
    CheckpointManager(str(runs["ckpt"])).restore("latest", state)
    assert tds.digest(checkpoints.state_tensors(state)) == got[0]["saved"]
    assert all(torch.equal(p, want[n]) for n, p in model.named_parameters() if p.requires_grad)


def test_meter_broadcast_and_rows_over_two_ranks(runs):
    for rank, got in enumerate(runs["ranks"]):
        assert got["world"] == 2
        assert got["meter"] == (16.0, 4.0, 4.0)
        assert got["broadcast"] == (3.5, None)
        assert got["rows"][0] == [[0, 1, 2], [3, 4, 5]][rank]
        assert got["rows"][1] == [slice(0, 3), slice(3, 6)][rank]
        assert got["rows"][2] == (slice(0, 3), None)
