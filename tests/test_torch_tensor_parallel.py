"""The mesh's tensor axis and the fsdp-sharded frozen weights in training, on
the CPU over gloo ranks (`tests/torch_dist_support.py`), at the tiny UniGR
of `tests/test_torch_parallel.py` (LoRA r 8, f32, lr 1e-3):

* the sharding rule: `infer_param_sharding`'s (tensor, fsdp) dimensions of
  every leaf of the tiny UniGR, frozen ones included, equal the JAX
  package's `infer_param_sharding` on the 8 virtual CPU devices at (fsdp 2,
  tensor 2), (fsdp 4, tensor 2) and (fsdp 1, tensor 2), checked through the
  weight bridge's layout transform as `test_infer_param_sharding_matches_jax`
  does (an array counting along JAX's dimension, converted); the LM's
  projections, embedding and head are tensor-sharded;
* 2 ranks over (tensor 2) and 4 over (fsdp 2, tensor 2) against one process
  over 3 steps on the same global micro-batches of 4 rows, at
  `test_ranks_match_one_process`'s gates: the aux within 1e-6 relative,
  each trainable tensor's move within 1e-5 of its scale in L2, the frozen
  tensors unchanged (gathered whole), every rank's tensors bit-equal;
  `embed_tokens` / `lm_head` tensor-sharded, the LoRA factors' gradients
  summed over tensor, every frozen leaf of a gathered block fsdp-sharded;
* the 4-rank run against JAX's `build_train_step` under
  `make_mesh(MeshConfig(fsdp=4, tensor=2))` on the same batch, at
  `test_two_ranks_match_jax_mesh_step`'s tolerances (losses 1e-5,
  parameters within 3 sums of the learning rates);
* the (fsdp 2, tensor 2) state saved by rank 0 (whole tensors) and
  restored bit for bit in one process and over (tensor 2);
* `sync_grads` on gradients that differ on every rank: the LoRA factors'
  parts summed over tensor, the tensors every tensor rank holds whole
  averaged over it, the vocabulary blocks left alone;
* `make_mesh(MeshConfig(tensor=2))`'s groups: the tensor group holds both
  ranks, the data / fsdp / replica groups each rank alone;
* the resident frozen bytes a rank at fsdp 2 (`tools/zero_bytes.py`, on the
  meta device) are half of those the gathered blocks hold plus the rest;
* the train CLI's `load_pretrained` fills a model cut to a rank's blocks
  from a Qwen2.5-VL HF directory one tensor at a time (the directory read
  as a generator): each entry the rank's block of the whole tensor.
"""
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
from rga3_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rga3_tpu.parallel.sharding import infer_param_sharding as jax_infer_param_sharding
from rga3_tpu.train.step import build_train_step as jax_build_train_step
from rga3_tpu.train.step import make_train_state as jax_make_train_state
from rga3_tpu_torch import convert
from rga3_tpu_torch.config import MeshConfig, SegHeadConfig
from rga3_tpu_torch.data import collate as tc
from rga3_tpu_torch.data.processor import ChatMessage, QwenVLProcessor
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
from rga3_tpu_torch.parallel import infer_param_sharding
from rga3_tpu_torch.models.qwen25vl.loader import iter_qwen25vl_state, load_qwen25vl_state_dict
from rga3_tpu_torch.parallel.fsdp import shard_model
from rga3_tpu_torch.parallel.mesh import Mesh
from rga3_tpu_torch.tools.zero_bytes import zero_bytes
from rga3_tpu_torch.train import __main__ as cli
from rga3_tpu_torch.train.export import export_hf_safetensors

import torch_dist_support as tds
from torch_port_support import jax_param_tree

SEG_ID = 151665
T = 2
KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28, video_max_pixels=16 * 28 * 28)
BUDGET = 128  # vision patches a sample
TRAIN = dict(lr=1e-3, epochs=1, steps_per_epoch=10, warmup_ratio=0.1, grad_clip=1.0)
LOSS_KEYS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss", "mask_loss")
ANSWERS = ["no object here .", "it is not in this video at all , sorry about that .",
           "[SEG] .", "sure it is [SEG] ."]
HAS_MASKS = [True, False, True, True]
RUNS = {"tensor2": dict(tensor=2), "fsdp2-tensor2": dict(fsdp=2, tensor=2)}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lora(cfg):
    return cfg.replace(text=cfg.text.replace(lora_rank=8, lora_alpha=16.0))


def _jax_model():
    jcfg = JaxUniGRConfig(qwen=_lora(jax_tiny_config(152_000)), sam2=jax_tiny_sam2(64),
                          seg=JaxSegHead(out_dim=32, seg_token_id=SEG_ID))
    return JaxUniGR(jcfg), jcfg


INIT_ARGS = (jnp.zeros((T, 64, 64, 3)), jnp.zeros((T, 1, 32)), jnp.zeros((1, 8), jnp.int32))


@pytest.fixture(scope="module")
def models():
    jm, jcfg = _jax_model()
    params = jax_param_tree(jm, *INIT_ARGS, seed=3)
    cfg = UniGRConfig(qwen=_lora(tiny_config(152_000)), sam2=tiny_sam2_config(64),
                      seg=SegHeadConfig(out_dim=32, seg_token_id=SEG_ID))
    return jm, jcfg, params, cfg


# ---------------------------------------------------------------------------
# (a) the whole sharding rule against the JAX package's
# ---------------------------------------------------------------------------

def _marker(axis):
    def mark(spec, p):
        """p's shape counting 1, 2, ... along JAX's `axis` dim (0: none)."""
        dims = [i for i, a in enumerate(spec.spec) if a == axis]
        if not dims:
            return np.zeros(np.shape(p), np.float32)
        shape = [1] * np.ndim(p)
        shape[dims[0]] = np.shape(p)[dims[0]]
        counts = np.arange(1, shape[dims[0]] + 1, dtype=np.float32).reshape(shape)
        return np.broadcast_to(counts, np.shape(p)).copy()
    return mark


def _varies_along(t: torch.Tensor):
    """The one dim along which the counts 1..n run (constant along the
    others), or None."""
    for d in range(t.dim()):
        other = t.movedim(d, 0).reshape(t.shape[d], -1)
        if (other == other[:, :1]).all() and len(set(other[:, 0].tolist())) == t.shape[d]:
            return d
    return None


@pytest.mark.parametrize("fsdp", [2, 4, 1])
def test_infer_param_sharding_matches_jax_with_tensor(models, fsdp):
    jm, _, params, cfg = models
    jmesh = jax_make_mesh(JaxMeshConfig(data=8 // (2 * fsdp), fsdp=fsdp, tensor=2))
    boxed = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *INIT_ARGS)
    specs = jax_infer_param_sharding(boxed, jmesh)
    model = UniGR(cfg, device="meta")
    mesh = Mesh(MeshConfig(data=8 // (2 * fsdp), fsdp=fsdp, tensor=2),
                np.arange(8).reshape(8 // (2 * fsdp), fsdp, 2))
    got = infer_param_sharding(model, mesh)
    markers = {axis: convert.torch_state_dict_from_flax(jax.tree.map(_marker(axis), specs,
                                                                     params))
               for axis in ("tensor", "fsdp")}
    assert set(markers["tensor"]) == set(got)
    counted = {"tensor": 0, "fsdp": 0}
    for name, dims in got.items():
        for axis, dim in zip(("tensor", "fsdp"), dims):
            t = markers[axis][name]
            if not t.any():
                assert dim is None, (name, axis, dim)
                continue
            want = _varies_along(t)
            if want is None:  # a non-leading part of a merged torch dim
                parent = name.rpartition(".")[0]
                kind = getattr(model.get_submodule(parent), "flax_kind", "")
                assert kind.startswith("heads") and dim is None, (name, axis, dim)
                continue
            assert dim == want, (name, axis, dim, want)
            counted[axis] += 1
    lm = [n for n in got if n.startswith("qwen.lm.")
          and n.endswith(("proj.weight", "embed_tokens.weight", "lm_head.weight"))]
    assert all(got[n][0] is not None for n in lm) and len(lm) == 2 * 7 + 2
    assert counted["tensor"] == len(lm)
    assert (counted["fsdp"] > len(got) // 2) == (fsdp > 1)


# ---------------------------------------------------------------------------
# (d), (e) the train step over the tensor axis; the checkpoint across meshes
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
    _, _, params, cfg = models
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    sd = convert.torch_state_dict_from_flax(params)
    torch.save(sd, tmp / "sd.pt")
    samples = _samples(tc, ChatMessage)
    whole = _collate(samples, cfg.qwen)
    halves = [_collate(samples[:2], cfg.qwen), _collate(samples[2:], cfg.qwen)]
    job = {"sd": str(tmp / "sd.pt"), "cfg": cfg, "train": TRAIN, "checkpoint": "fsdp2-tensor2",
           "runs": [
               # every rank takes every row
               {"name": "tensor2", "mesh": RUNS["tensor2"], "rows": 4,
                "batches": [[whole]] * 2},
               # fsdp splits the rows; both tensor ranks of an fsdp index hold them
               {"name": "fsdp2-tensor2", "mesh": RUNS["fsdp2-tensor2"], "rows": 4,
                "batches": [[halves[0]], [halves[0]], [halves[1]], [halves[1]]]}]}
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    two = tds.Ranks(tds.tensor_train_ranks, 2, str(tmp / "job.pkl"), str(tmp))
    four = tds.Ranks(tds.tensor_train_ranks, 4, str(tmp / "job.pkl"), str(tmp))
    try:  # one process and JAX's mesh step on the same global micro-batch, meanwhile
        reference = tds.train_run(cfg, sd, TRAIN, None, [whole], 4)[:3]
        jax_steps = _jax_mesh_steps(models)
    finally:
        two, four = two.results(), four.results()
    # the (fsdp 2, tensor 2) checkpoint over (tensor 2)
    with open(tmp / "restore.pkl", "wb") as f:
        pickle.dump({**job, "runs": [{"name": "restore-tensor2", "mesh": RUNS["tensor2"],
                                      "restore": str(tmp / "ckpt")}]}, f)
    again = tds.Ranks(tds.tensor_train_ranks, 2, str(tmp / "restore.pkl"), str(tmp))
    try:
        model = UniGR(cfg, device="cpu")
        model.load_state_dict(sd, strict=True)
        from rga3_tpu_torch.config import TrainConfig
        from rga3_tpu_torch.train import checkpoints
        from rga3_tpu_torch.train.step import make_train_state

        state, _ = make_train_state(TrainConfig(**TRAIN), model)
        checkpoints.CheckpointManager(str(tmp / "ckpt")).restore("latest", state)
        one_restored = {"restored": tds.digest(checkpoints.state_tensors(state)),
                        "params": tds.digest({n: p for n, p in model.named_parameters()
                                              if p.requires_grad}),
                        "count": state.opt.count, "step": state.step}
    finally:
        again = again.results()
    ported = {name: torch.load(tmp / f"{name}.pt") for name in RUNS}
    return {"sd": sd, "cfg": cfg, "reference": reference, "ranks": {2: two, 4: four},
            "ported": ported, "again": again, "one_restored": one_restored,
            "jax": jax_steps}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tensor_ranks_match_one_process(runs, name):
    trace, trainable, kept = runs["reference"]
    sd = runs["sd"]
    world = int(np.prod(list(RUNS[name].values())))
    records = [rank[name] for rank in runs["ranks"][world]]
    assert kept
    for got in records:
        assert got["frozen_kept"]
        assert len(got["trace"]) == len(trace) == 3
        for step, (a, b) in enumerate(zip(got["trace"], trace)):
            for k in LOSS_KEYS:
                assert abs(a[k] - b[k]) <= 1e-6 * max(abs(b[k]), 1e-12), (name, step, k, a[k], b[k])
            assert a["lr"] == b["lr"]
        assert got["tensor_sharded"] == ["qwen.lm.embed_tokens.weight", "qwen.lm.lm_head.weight"]
        assert len(got["partial"]) == 4 * 2  # q / v LoRA A and B, 2 layers
        assert (got["frozen_fsdp"] > 100) == ("fsdp" in name), got["frozen_fsdp"]
    assert len({got["digest"] for got in records}) == 1
    ported = runs["ported"][name]
    moved = 0
    for n, want in trainable.items():
        start = sd[n]
        err = ((ported[n] - start) - (want - start)).norm().item()
        assert err <= 1e-5 * want.norm().item(), (name, n, err, want.norm().item())
        assert torch.equal(ported[n], start) == torch.equal(want, start), (name, n)
        moved += int(not torch.equal(want, start))
    assert moved > len(trainable) // 2


def _jax_mesh_steps(models):
    """JAX's `build_train_step` under `make_mesh(MeshConfig(fsdp=4,
    tensor=2))`, 3 steps on the same global micro-batch."""
    jm, jcfg, params, _ = models
    jproc = JaxProcessor.from_pretrained("dummy", **KW)
    batch = _micro(jc.collate(_samples(jc, JaxMessage), jproc, jcfg.qwen,
                              vision_budget_tokens=4 * BUDGET))
    mesh = jax_make_mesh(JaxMeshConfig(data=1, fsdp=4, tensor=2))
    with mesh:
        state, tx = jax_make_train_state(JaxTrainConfig(**TRAIN), {"params": params}, mesh)
        step = jax_build_train_step(
            lambda p, mb: jm.apply(p["params"], *(mb[k] for k in tds.BATCH_KEYS),
                                   pixel_patches=mb["pixel_patches"],
                                   vision_layout=mb["vision_layout"],
                                   compute_dtype=jnp.float32, method=JaxUniGR.train_forward),
            tx, grad_accum_steps=1, donate=False)
        stacked = jax.tree.map(lambda x: x[None], batch)
        aux = []
        for _ in range(3):
            state, a = step(state, stacked)
            aux.append({k: float(v) for k, v in a.items()})
        return aux, jax.tree.map(np.asarray, state.params["params"])


def test_four_ranks_match_jax_tensor_mesh_step(runs):
    aux, params = runs["jax"]
    trace = runs["ranks"][4][0]["fsdp2-tensor2"]["trace"]
    for a, b in zip(trace, aux):
        for k in LOSS_KEYS:
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (k, a[k], b[k])
    bound = 3 * sum(a["lr"] for a in trace)
    want = convert.torch_state_dict_from_flax(params)
    got = runs["ported"]["fsdp2-tensor2"]
    for name, t in got.items():
        assert (t - want[name]).abs().max().item() <= bound, name
    for name in set(want) - set(got):
        assert torch.equal(want[name], runs["sd"][name]), name


def test_tensor_checkpoint_resumes_in_one_process_and_over_tensor2(runs):
    saved = {rank["saved"] for rank in runs["ranks"][4]}
    assert len(saved) == 1
    saved = saved.pop()
    want = runs["ported"]["fsdp2-tensor2"]
    for got in [runs["one_restored"]] + [rank["restore-tensor2"] for rank in runs["again"]]:
        assert got["restored"] == saved and (got["count"], got["step"]) == (3, 3)
        assert got["params"] == tds.digest(want)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sync_grads_sums_parts_and_averages_copies_over_tensor(runs, name):
    """Each rank's gradients rank + 1: a LoRA factor's parts summed over
    tensor, a tensor every tensor rank holds whole averaged over it (its
    copies stay equal where the ranks' kernels round them differently), a
    vocabulary block left alone; then each summed over data x fsdp."""
    world = int(np.prod(list(RUNS[name].values())))
    records = [rank[name] for rank in runs["ranks"][world]]
    fsdp = RUNS[name].get("fsdp", 1)
    for rank, got in enumerate(records):
        ti = rank % 2  # the tensor index: tensor is the last mesh axis
        # the ranks of this tensor index, and of every tensor index
        own = sum(f * 2 + ti + 1 for f in range(fsdp))
        every = sum(range(1, world + 1))
        for n, values in got["synced"].items():
            if n in got["tensor_sharded"]:
                assert values == [own], (name, rank, n, values)
            elif n in got["partial"]:
                assert values == [every], (name, rank, n, values)
            else:
                assert values == [every / 2], (name, rank, n, values)


def test_tensor_mesh_groups(runs):
    for rank, got in enumerate(runs["ranks"][2]):
        g = got["groups"]
        assert g["coords"] == (0, 0, rank)
        assert g["tensor"] == [0, 1]
        assert g["data"] == g["fsdp"] == g["replica"] == [rank]


def test_frozen_bytes_fall_with_fsdp():
    out = zero_bytes("tiny", lora_r=8, fsdp=(1, 2), tensor=(1, 2))
    for t in (1, 2):
        one, two = out["per_rank"][f"fsdp1-tensor{t}"], out["per_rank"][f"fsdp2-tensor{t}"]
        # the gathered blocks' frozen bytes halve; the rest stays
        assert two["frozen_bytes"] == one["frozen_bytes"] - two["frozen_sharded_bytes"] // 2
        assert two["frozen_bytes"] <= 0.5 * one["frozen_bytes"] + two["frozen_whole_bytes"]
        assert two["frozen_sharded_bytes"] > 0.9 * one["frozen_bytes"]
    assert out["per_rank"]["fsdp1-tensor2"]["frozen_bytes"] < \
        out["per_rank"]["fsdp1-tensor1"]["frozen_bytes"]


def test_pretrained_weights_load_a_tensor_at_a_time_into_the_rank_block(models, tmp_path):
    cfg = models[3]
    src = UniGR(cfg, device="cpu")
    src.init_weights(torch.Generator().manual_seed(5))
    export_hf_safetensors(src, str(tmp_path))
    whole = {"qwen." + k: v for k, v in load_qwen25vl_state_dict(str(tmp_path)).items()}
    # rank 1 of (fsdp 2): the cut needs no collective
    model = UniGR(cfg, device="meta")
    plan = shard_model(model, Mesh(MeshConfig(fsdp=2), np.arange(2).reshape(1, 2, 1), rank=1),
                       device="cpu")
    read = []

    def entries():
        for k, v in iter_qwen25vl_state(str(tmp_path)):
            read.append(k)
            yield "qwen." + k, v

    done = cli.load_pretrained(model, entries())
    assert done == set(whole) and len(read) == len(whole)
    sd = model.state_dict()
    cut = 0
    for k, v in whole.items():
        assert torch.equal(sd[k], plan.local(k, v)), k
        cut += sd[k].numel() < v.numel()
    assert cut > len(whole) // 2
