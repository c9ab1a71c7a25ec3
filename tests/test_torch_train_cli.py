"""The port's training entry point (`python -m rga3_tpu_torch.train`) against
`scripts/train.py` and the JAX package, on the CPU, at the tiny config on a
synthetic tree (`tools/synth_trees.write_train_tree`):

* `assemble_params` with `--model_dir dummy` builds exactly the JAX script's
  parameters, leaf by leaf (crc32-of-the-flax-path seeded draws);
* the port's `CheckpointManager` keeps the JAX manager's behaviours (crash
  resume, best tracking, lower-is-better, a latest without meta), and an
  interrupted save leaves the previous checkpoint readable; a restore into a
  state of other names, shapes or dtypes raises;
* two epochs straight and one epoch plus an auto-resumed one give
  bit-identical losses, trainable tensors, masters and Adam moments;
* remat "dots" saves the outputs of each decoder layer's 7 weight products
  and 4 LoRA products, and its f32 loss equals the JAX package's remat
  "dots" loss within 1e-5;
* the CLI's loss trace against JAX's `build_train_step` (the JAX script's
  model, parameters, optimizer and loss) fed the accumulation batches the
  port CLI built, at lr 1e-3. The LM computes in bf16 on both sides (the
  JAX script casts its f32 parameters to bf16 at each use; the port keeps
  a bf16 model with f32 masters); SAM2, text_hidden_fcs and the LM's
  embedding and head compute in f32 on both sides (flax promotes bf16
  activations against f32 parameters; the port holds them in f32, the
  trainable ones their own masters), so both pick the same best-IoU mask. The random-init network's
  loss averages those roundings over every token and logit: the traces
  differ by ~1e-6 relative, and the gate is LOSS_TOL = 1e-5 relative. The
  first step runs at lr 0 (the warmup), so the third loss is the first
  after a real update: that update moves it by ~1.2e-4 relative (against
  the loss the same batch gives without it), so a skipped update fails the
  gate; the second and third losses, of two batches, differ by ~1.4e-2
  absolute. After the three steps the port's f32 masters are held against
  JAX's f32 parameters: each bf16 parameter is its master rounded, each
  element within 3 sums of the learning rates (Adam moves an element whose
  gradient is rounding noise by up to +-lr a step, whichever way the noise
  falls), the same tensors moved, and the LM's updates (master minus its
  start) within LM_UPDATE_TOL relative L2 of JAX's (measured up to 3.3e-3
  over 22 hash seeds), and the decoder's and text_hidden_fcs' updates
  each within F32_UPDATE_TOL (measured 0.64-1.25% and 0.40-1.04% over 9
  hash seeds by `tests/probe_f32_modules.py updates` while the frozen SAM2
  image encoder, which JAX computes in f32 from f32 weights, was bf16 in
  the port; ~0.03% since it is held in f32, `test_torch_f32_encoder.py`). The
  JAX script itself takes ~110 s at this size on this CPU (its train
  step's compile), so the batches are fed in process.
* `--profile_dir` writes a torch.profiler trace of the run, and each step
  reports its model FLOPs.
* val runs only when the ReasonSeg val split is on disk: without it the
  run trains and logs "val skipped"; a failure inside val (a missing label
  file) raises.
"""
import importlib.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from rga3_tpu.config import SegHeadConfig as JaxSegHead, TrainConfig as JaxTrainConfig
from rga3_tpu.data.processor import QwenVLProcessor as JaxProcessor
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.sam2 import tiny_sam2_config as jax_tiny_sam2
from rga3_tpu.models.unigr import UniGR as JaxUniGR, UniGRConfig as JaxUniGRConfig
from rga3_tpu.train.step import build_train_step as jax_build_train_step
from rga3_tpu.train.step import make_train_state as jax_make_train_state
from rga3_tpu_torch.config import SegHeadConfig, TrainConfig
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.data.datasets import ImgVidHybridDataset
from rga3_tpu_torch.data.processor import QwenVLProcessor
from rga3_tpu_torch.models.qwen25vl import language
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
from rga3_tpu_torch.tools.synth_trees import write_train_tree
from rga3_tpu_torch.train import __main__ as cli
from rga3_tpu_torch.train import checkpoints
from rga3_tpu_torch.train.optimizer import lr_schedule
from rga3_tpu_torch.train.step import make_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_ID = 151665  # the dummy tokenizer's [SEG]
LORA = dict(lora_rank=8, lora_alpha=16.0)
LOSS_TOL = 1e-5
LM_UPDATE_TOL = 2e-2
F32_UPDATE_TOL = 5e-2
F32_GROUPS = ("grounding_encoder.sam_mask_decoder.", "text_hidden_fcs.")
# trainable tensors the CLI holds in f32 under f32 parameters (`cli.hold_f32`)
F32_HELD = F32_GROUPS + ("qwen.lm.embed_tokens.", "qwen.lm.lm_head.")
LR = 1e-3
TRAIN_KEYS = ("input_ids", "labels", "position_ids", "segment_ids", "images_sam", "gt_masks",
              "masks_valid")
VL_KEYS = ["hpos", "wpos", "window_seg", "grid_seg", "win_pad", "win_unpad", "token_perm",
           "merged_reverse"]


def jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_script",
                                                  os.path.join(ROOT, "scripts", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_model(remat="dots"):
    """The JAX script's tiny UniGR (its config for `--model_size tiny`)."""
    q = jax_tiny_config()
    q = q.replace(text=q.text.replace(scan_layers=False, **LORA))
    s = jax_tiny_sam2()
    cfg = JaxUniGRConfig(qwen=q, sam2=s, seg=JaxSegHead(out_dim=s.d_model, seg_token_id=SEG_ID))
    return JaxUniGR(cfg, remat=remat), cfg


def port_model(dtype=torch.float32, remat="dots"):
    q = tiny_config()
    q = q.replace(text=q.text.replace(**LORA))
    s = tiny_sam2_config()
    cfg = UniGRConfig(qwen=q, sam2=s, seg=SegHeadConfig(out_dim=s.d_model, seg_token_id=SEG_ID))
    return UniGR(cfg, device="cpu", dtype=dtype, remat=remat)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_train_tree(str(tmp_path_factory.mktemp("train_tree")),
                            datasets=("mevis", "reason_seg"), seed=1)


@pytest.fixture(scope="module")
def jax_params():
    model, cfg = jax_model()
    assert JaxProcessor.from_pretrained("dummy").seg_token_id == SEG_ID
    return jax_script().assemble_params(model, cfg, {}, "float32")


def dataset(tree):
    """The CLI's mixture at `cli_args`' flags."""
    return ImgVidHybridDataset(tree, ["mevis", "reason_seg"], [1.0, 1.0], 8, num_frames_mllm=2,
                               num_frames_sam=2, mask_res=256, sam_size=128)


def cli_args(tree, ckpt, *extra):
    return ["--model_dir", "dummy", "--model_size", "tiny", "--dataset_dir", tree,
            "--dataset", "mevis,reason_seg", "--sample_rates", "1,1", "--num_frames_mllm", "2",
            "--num_frames_sam", "2", "--lora_r", "8", "--lora_alpha", "16",
            "--data_workers", "0", "--device", "cpu", "--ckpt_dir", str(ckpt), *extra]


def test_assemble_params_matches_the_jax_script(jax_params):
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jax_params))
    model = port_model()
    kept = cli.assemble_params(model, keep=lambda key: "lora_a" in key)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, t in got.items():
        assert torch.equal(t, want[key]), key
    assert kept and all(torch.equal(kept[k], want[k]) for k in kept)
    # pretrained tensors are taken where the shapes agree
    model2 = port_model()
    lm_head = torch.full_like(got["qwen.lm.lm_head.weight"], 0.5)
    cli.assemble_params(model2, {"qwen.lm.lm_head.weight": lm_head})
    assert torch.equal(model2.state_dict()["qwen.lm.lm_head.weight"], lm_head)


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.lora_a = nn.Parameter(torch.zeros(4, 3, dtype=torch.bfloat16))
        self.lm_head = nn.Linear(3, 2, dtype=torch.bfloat16)
        self.frozen = nn.Linear(3, 3)


def make_state(step, master=True):
    model = Tiny()
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.fill_(float(step) + i)
    state, opt = make_train_state(TrainConfig(epochs=1, steps_per_epoch=4), model,
                                  master_dtype=torch.float32 if master else None)
    state.step = step
    opt.count = step
    for n in opt.params:
        opt.mu[n].fill_(step / 10)
        opt.nu[n].fill_(step / 100)
    return state


def test_checkpoint_crash_resume_restores_latest_and_epoch(tmp_path):
    ck = checkpoints.CheckpointManager(str(tmp_path / "ckpt"))
    assert ck.resume_epoch() == 0
    ck.save_epoch(make_state(100), epoch=0, metric=0.3)
    ck.save_epoch(make_state(200), epoch=1, metric=0.5)
    ck2 = checkpoints.CheckpointManager(str(tmp_path / "ckpt"))
    assert ck2.resume_epoch() == 2
    restored = ck2.restore("latest", make_state(0))
    assert restored.step == 200 and restored.opt.count == 200
    want = make_state(200)
    for (n, t), (_, w) in zip(checkpoints.state_tensors(restored).items(),
                              checkpoints.state_tensors(want).items()):
        assert torch.equal(t, w), n
    assert torch.equal(restored.model.lora_a, want.model.lora_a)
    assert "master.lora_a" in checkpoints.state_tensors(restored)


def test_checkpoint_best_tracking_and_regression(tmp_path):
    ck = checkpoints.CheckpointManager(str(tmp_path / "ckpt"))
    assert ck.save_epoch(make_state(1), epoch=0, metric=0.4) is True
    assert ck.save_epoch(make_state(2), epoch=1, metric=0.2) is False
    assert ck.save_epoch(make_state(3), epoch=2, metric=0.7) is True
    meta = ck.read_meta()
    assert meta["best_epoch"] == 2 and meta["best_metric"] == 0.7
    assert [h["epoch"] for h in meta["history"]] == [0, 1, 2]
    assert ck.restore("best", make_state(0)).step == 3
    ck.save_epoch(make_state(4), epoch=3, metric=0.1)
    assert ck.restore("latest", make_state(0)).step == 4
    assert ck.restore("best", make_state(0)).step == 3


def test_checkpoint_lower_is_better_mode(tmp_path):
    ck = checkpoints.CheckpointManager(str(tmp_path / "ckpt"))
    assert ck.save_epoch(make_state(1), epoch=0, metric=1.0, higher_is_better=False)
    assert not ck.save_epoch(make_state(2), epoch=1, metric=2.0, higher_is_better=False)
    assert ck.save_epoch(make_state(3), epoch=2, metric=0.5, higher_is_better=False)


def test_checkpoint_interrupted_meta_is_survivable(tmp_path):
    ck = checkpoints.CheckpointManager(str(tmp_path / "ckpt"))
    ck.save("latest", make_state(7))
    assert ck.resume_epoch() == 0
    assert ck.restore("latest", make_state(0)).step == 7


def test_checkpoint_interrupted_save_and_mismatch(tmp_path, monkeypatch):
    ck = checkpoints.CheckpointManager(str(tmp_path / "ckpt"))
    ck.save_epoch(make_state(5), epoch=0)
    real = checkpoints.safetensors_io._raw
    calls = []

    def dying(x):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt("killed mid-write")
        return real(x)

    monkeypatch.setattr(checkpoints.safetensors_io, "_raw", dying)
    with pytest.raises(KeyboardInterrupt):
        ck.save_epoch(make_state(6), epoch=1)
    monkeypatch.setattr(checkpoints.safetensors_io, "_raw", real)
    assert ck.resume_epoch() == 1
    assert ck.restore("latest", make_state(0)).step == 5
    # a state without masters has other names; a wider one other shapes
    with pytest.raises(ValueError, match="does not match"):
        ck.restore("latest", make_state(0, master=False))
    state = make_state(0)
    state.opt.mu["lm_head.weight"] = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="does not match"):
        ck.restore("latest", state)


def test_resumed_run_is_bit_identical(tree, tmp_path):
    extra = ["--steps_per_epoch", "1", "--micro_batch_size", "1", "--grad_accum_steps", "2",
             "--val_samples", "1"]
    straight = cli.main(cli_args(tree, tmp_path / "a", "--epochs", "2", "--loss_log",
                                 str(tmp_path / "a.json"), *extra))
    first = cli.main(cli_args(tree, tmp_path / "b", "--epochs", "1", *extra))
    seen = {}

    def on_restore(state):
        seen["count"], seen["step"] = state.opt.count, state.step
        seen["tensors"] = {n: t.clone() for n, t in checkpoints.state_tensors(state).items()}

    resumed = cli.main(cli_args(tree, tmp_path / "b", "--epochs", "2", "--loss_log",
                                str(tmp_path / "b.json"), *extra), on_restore=on_restore)
    assert first["start_epoch"] == 0 and resumed["start_epoch"] == 1
    # what was restored is what was saved, and the run continues its count
    saved = checkpoints.state_tensors(first["state"])
    assert set(seen["tensors"]) == set(saved)
    assert all(torch.equal(seen["tensors"][n], t) for n, t in saved.items())
    assert seen["count"] == 1 and seen["step"] == 1
    step = resumed["steps"][0]
    tcfg = TrainConfig(epochs=2, steps_per_epoch=1)
    assert step["batch_idx"] == 1 and step["aux"]["lr"] == lr_schedule(tcfg)(1)
    assert [s["batch_idx"] for s in straight["steps"]] == [0, 1]
    # the losses and the final trainable state, bit for bit
    with open(tmp_path / "a.json") as f:
        losses_a = json.load(f)["loss"]
    with open(tmp_path / "b.json") as f:
        losses_b = json.load(f)["loss"]
    assert losses_a[1:] == losses_b and first["steps"][0]["aux"]["loss"] == losses_a[0]
    got, want = (checkpoints.state_tensors(r["state"]) for r in (resumed, straight))
    assert set(got) == set(want) and any(n.startswith("master.") for n in got)
    assert all(torch.equal(got[n], want[n]) for n in want)
    assert resumed["state"].opt.count == straight["state"].opt.count == 2
    meta = checkpoints.CheckpointManager(str(tmp_path / "b")).read_meta()
    assert meta["last_epoch"] == 1 and [h["epoch"] for h in meta["history"]] == [0, 1]
    assert len(resumed["val"]) == 1 and 0.0 <= resumed["val"][0][1]["gIoU"] <= 1.0


def test_cli_guards(tree, tmp_path):
    prof = tmp_path / "prof"
    run = cli.main(cli_args(tree, tmp_path / "ck", "--epochs", "1", "--steps_per_epoch", "1",
                            "--micro_batch_size", "1", "--grad_accum_steps", "1", "--no_eval",
                            "--profile_dir", str(prof)))
    traces = list(prof.glob("train.*.pt.trace.json"))
    assert len(traces) == 1 and "step 0" in traces[0].read_text()
    assert run["steps"][0]["flops"] > 0 and run["steps"][0]["mfu"] is None
    if not torch.cuda.is_available():
        args = cli_args(tree, tmp_path)
        i = args.index("--device")
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args[:i] + args[i + 2:])
    # the default TrainConfig's remat ("dots") builds
    assert port_model(remat=TrainConfig().remat).qwen.lm.model.remat == "dots"
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"_comment": "x", "epochs": 7, "lr": 1e-3, "lora_r": 4}))
    args = cli.parse_args(["--model_dir", "dummy", "--config", str(cfg_file), "--lr", "2e-3"])
    assert (args.epochs, args.lr, args.lora_r) == (7, 2e-3, 4)


def test_remat_dots_saves_the_weight_products_and_matches_jax(jax_params, tree, tmp_path):
    """One CLI micro-batch through the f32 tiny model: the policy's saved
    ops per decoder layer, and the loss against the JAX package's."""
    batch = cli.AccumBatches(
        dataset(tree), QwenVLProcessor.from_pretrained("dummy"), port_model().cfg,
        cli.parse_args(cli_args(tree, tmp_path, "--micro_batch_size", "2",
                                "--grad_accum_steps", "1")), 0)(0)
    mb = cli.stage(batch, torch.device("cpu"))[0]
    model = port_model()
    model.load_state_dict(torch_state_dict_from_flax(jax.tree.map(np.asarray, jax_params)))
    saved = []
    real = language.dots_policy

    def recording(ctx, op, *a, **k):
        out = real(ctx, op, *a, **k)
        saved.append(out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE)
        return out

    language.dots_policy = recording
    try:
        loss = model.train_forward(**mb)["loss"]
    finally:
        language.dots_policy = real
    layers = model.cfg.qwen.text.num_hidden_layers
    assert sum(saved) == layers * (7 + 4)
    jm, _ = jax_model("dots")
    jb = {k: v[0] for k, v in batch.items()}
    want = jax.jit(lambda p, b: jm.apply(
        p, *(b[k] for k in TRAIN_KEYS), pixel_patches=b["pixel_patches"],
        vision_layout={k: b[f"vl_{k}"] for k in VL_KEYS}, compute_dtype=jnp.float32,
        method=JaxUniGR.train_forward)["loss"])(jax_params, jb)
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))


def test_cli_loss_trace_matches_jax_train_step(jax_params, tree, tmp_path, monkeypatch):
    batches = []

    class Recording(cli.PrefetchLoader):
        def __next__(self):
            batches.append(super().__next__())
            return batches[-1]

    monkeypatch.setattr(cli, "PrefetchLoader", Recording)
    log = tmp_path / "loss.json"
    # 3 steps: the first update's learning rate is 0 (the warmup), so the
    # third loss is the first after a real update
    run = cli.main(cli_args(tree, tmp_path / "ck", "--epochs", "1", "--steps_per_epoch", "3",
                            "--micro_batch_size", "2", "--grad_accum_steps", "2", "--no_eval",
                            "--lr", str(LR), "--loss_log", str(log)))
    with open(log) as f:
        port_losses = json.load(f)["loss"]
    assert len(batches) == 3 and batches[0]["input_ids"].shape[0] == 2

    jm, _ = jax_model("dots")
    tcfg = JaxTrainConfig(lr=LR, epochs=1, steps_per_epoch=3, micro_batch_size=2,
                          grad_accum_steps=2, lora_r=8, lora_alpha=16.0, remat="dots")
    state, tx = jax_make_train_state(tcfg, jax_params)

    def loss_fn(p, b):
        return jm.apply(p, *(b[k] for k in TRAIN_KEYS), pixel_patches=b["pixel_patches"],
                        vision_layout={k: b[f"vl_{k}"] for k in VL_KEYS},
                        compute_dtype=jnp.bfloat16, method=JaxUniGR.train_forward)

    step = jax_build_train_step(loss_fn, tx, grad_accum_steps=2, donate=False)
    jax_losses = []
    for b in batches:
        state, aux = step(state, b)
        jax_losses.append(float(aux["loss"]))
    for got, want in zip(port_losses, jax_losses):
        assert np.isfinite(got) and abs(got - want) <= LOSS_TOL * abs(want), (port_losses,
                                                                               jax_losses)

    # the f32 masters against JAX's f32 parameters
    lrs = [s["aux"]["lr"] for s in run["steps"]]
    assert lrs[0] == 0.0 and lrs[1] > 0
    opt = run["state"].opt
    start = torch_state_dict_from_flax(jax.tree.map(np.asarray, jax_params))
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, state.params))
    assert set(opt.master) == set(opt.params) and len(opt.master) > 100
    moved = 0
    for name, master in opt.master.items():
        # SAM2, text_hidden_fcs and the LM's embedding and head are held in
        # f32: their own masters
        f32 = name.startswith(F32_HELD)
        assert master.dtype == torch.float32
        assert opt.params[name].dtype == (torch.float32 if f32 else torch.bfloat16), name
        assert f32 == (master.data_ptr() == opt.params[name].data_ptr()), name
        assert torch.equal(opt.params[name], master.to(opt.params[name].dtype)), name
        assert (master - want[name]).abs().max().item() <= 3 * sum(lrs), name
        # a tensor the loss does not reach stays in both (one whose gradient
        # is rounding noise, as a key bias under softmax, moves by ~1e-12)
        went, jax_went = ((t - start[name]).abs().max().item() > 1e-2 * lrs[1]
                          for t in (master, want[name]))
        assert went == jax_went, name
        moved += went
    assert moved > len(opt.master) // 2
    lm = [n for n in opt.master if n.startswith("qwen.")]
    got = torch.cat([(opt.master[n] - start[n]).flatten() for n in lm])
    ref = torch.cat([(want[n] - start[n]).flatten() for n in lm])
    assert (got - ref).norm() <= LM_UPDATE_TOL * ref.norm()
    for group in F32_GROUPS:
        names = [n for n in opt.master if n.startswith(group)]
        got = torch.cat([(opt.master[n] - start[n]).flatten() for n in names])
        ref = torch.cat([(want[n] - start[n]).flatten() for n in names])
        assert (got - ref).norm() <= F32_UPDATE_TOL * ref.norm(), group


@pytest.mark.parametrize("case", ["no_split", "missing_label"])
def test_val_skips_only_a_missing_split(tree, tmp_path, capsys, case):
    data = tmp_path / "data"
    shutil.copytree(tree, data)
    val = data / "reason_seg" / "ReasonSeg" / "val"
    labels = sorted(val.glob("*.json"))
    assert labels
    args = cli_args(str(data), tmp_path / "ck", "--epochs", "1", "--steps_per_epoch", "1",
                    "--micro_batch_size", "1", "--grad_accum_steps", "1", "--val_at_start",
                    "--val_samples", "1")
    if case == "no_split":
        shutil.rmtree(val)
        run = cli.main(args)
        assert run["val"] == [] and len(run["steps"]) == 1
        assert capsys.readouterr().out.count("val skipped: no ReasonSeg val split") == 2
    else:
        labels[0].unlink()
        with pytest.raises(FileNotFoundError):
            cli.main(args)
