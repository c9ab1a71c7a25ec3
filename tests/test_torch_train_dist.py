"""The train CLI across ranks (`python -m rga3_tpu_torch.train` with the JAX
script's multi-process flags), on the CPU over gloo, at the tiny config on a
synthetic tree (`tools/synth_trees.write_train_tree`). Every run is a process
of its own (`tests/torch_dist_support.py`'s runner) with one
PYTHONHASHSEED, since the dummy tokenizer hashes words with Python's str
hash. One step an epoch, accum 1, val on one image each epoch:

* 2 processes (`--coordinator_address/--num_processes/--process_id`,
  `--mesh_data 2`, a micro-batch of 1 row each: a global micro-batch of 2
  rows) give the loss trace of 1 process at `--micro_batch_size 2` on the
  same global batches. The model computes in bf16 (the CLI's model is bf16
  at every size), so the gate is the JAX multi-process test's 5e-4
  relative;
* each rank collates its own rows; the checkpoint is written once (by
  rank 0), and the val metric every rank saw is rank 0's;
* the 2-rank checkpoint resumes at 1 rank and continues within the same
  tolerance of the 2-rank run that goes on; a resume at 2 ranks gives
  bit-equal losses and trainable state to the straight 2-rank run;
* `--mesh_tensor 2` over 2 processes (both take both rows; the LM
  tensor-parallel, every rank running the val loop with the sharded model)
  trains the same 2 steps as the one process: every rank's aux and
  train state (gathered whole) the same, the losses within RTOL of the one process's
  (1.4e-7 and 0 apart on the CPU), one checkpoint written, by rank 0.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

from rga3_tpu_torch.tools.synth_trees import write_train_tree

import torch_dist_support as tds

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RTOL = 5e-4  # bf16 compute (tests/test_multihost_train.py's gate)


def cli_args(tree, ckpt, *extra):
    return ["--model_dir", "dummy", "--model_size", "tiny", "--dataset_dir", tree,
            "--dataset", "mevis,reason_seg", "--sample_rates", "1,1", "--num_frames_mllm", "2",
            "--num_frames_sam", "2", "--lora_r", "8", "--lora_alpha", "16",
            "--data_workers", "0", "--device", "cpu", "--ckpt_dir", str(ckpt),
            "--steps_per_epoch", "1", "--grad_accum_steps", "1", "--val_samples", "1", *extra]


def launch(out, argv, nproc):
    """Start `nproc` runner processes of the CLI on `argv` (one coordinator
    port); returns them."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONHASHSEED="0", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([ROOT, env.get("PYTHONPATH", "")]))
    cmd = [sys.executable, os.path.join(HERE, "torch_dist_support.py"), str(out), "--", *argv]
    if nproc > 1:
        port = tds.free_port()
        return [subprocess.Popen(cmd + ["--coordinator_address", f"127.0.0.1:{port}",
                                        "--num_processes", str(nproc), "--process_id", str(i)],
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for i in range(nproc)]
    return [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)]


def finish(procs, out):
    """Wait for the processes (killing every one if any fails or hangs) and
    return each rank's record."""
    try:
        for p in procs:
            log = p.communicate(timeout=600)[0]
            assert p.returncode == 0, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    records = []
    for rank in range(len(procs)):
        with open(f"{out}.{rank}.json") as f:
            records.append(json.load(f))
    return records


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_dist")
    tree = write_train_tree(str(tmp / "tree"), datasets=("mevis", "reason_seg"), seed=1)
    two = ["--mesh_data", "2", "--micro_batch_size", "1"]
    one = ["--micro_batch_size", "2"]
    # one process and two, straight for 2 epochs; two for 1 epoch
    first = {
        "one": (cli_args(tree, tmp / "one", "--epochs", "2", *one), 1),
        "two": (cli_args(tree, tmp / "two", "--epochs", "2", *two), 2),
        "two_e1": (cli_args(tree, tmp / "two_e1", "--epochs", "1", *two), 2),
        "tensor2": (cli_args(tree, tmp / "tensor2", "--epochs", "2", "--mesh_tensor", "2",
                             *one), 2),
    }
    started = {k: launch(tmp / k, argv, n) for k, (argv, n) in first.items()}
    out = {k: finish(procs, tmp / k) for k, procs in started.items()}
    # the 1-epoch 2-rank checkpoint resumed at 2 ranks and at 1 rank
    shutil.copytree(tmp / "two_e1", tmp / "one_resumed")
    second = {
        "two_resumed": (cli_args(tree, tmp / "two_e1", "--epochs", "2", *two), 2),
        "one_resumed": (cli_args(tree, tmp / "one_resumed", "--epochs", "2", *one), 1),
    }
    started = {k: launch(tmp / k, argv, n) for k, (argv, n) in second.items()}
    out.update({k: finish(procs, tmp / k) for k, procs in started.items()})
    out["ckpt"] = tmp / "two_e1"
    return out


def losses(record):
    return [st["loss"] for st in record["steps"]]


def test_two_processes_give_the_loss_trace_of_one(runs):
    one, two = runs["one"][0], runs["two"]
    assert one["mesh"] == {"data": 1, "fsdp": 1, "tensor": 1}
    assert [r["mesh"] for r in two] == [{"data": 2, "fsdp": 1, "tensor": 1}] * 2
    # each rank collated its own row of the global micro-batch of 2
    assert [r["rows"] for r in two] == [[0], [1]] and one["rows"] == [0, 1]
    assert len(losses(one)) == 2
    for rank in two:
        assert losses(rank) == losses(two[0])  # the aux is the global loss on every rank
        for a, b in zip(losses(rank), losses(one)):
            assert abs(a - b) <= RTOL * abs(b), (losses(rank), losses(one))
    assert losses(two[0])[1] != losses(two[0])[0]


def test_checkpoint_written_once_and_val_is_rank0s(runs):
    for name in ("two", "two_e1", "two_resumed"):
        ranks = runs[name]
        epochs = 2 - ranks[0]["start_epoch"] if name != "two_e1" else 1
        assert [r["writes"] for r in ranks] == [epochs, 0], name
        assert len(ranks[0]["val"]) == epochs and not ranks[1]["val"]
        for r in ranks:
            assert [m for _, m in r["val_metric"]] == [v["gIoU"] for v in ranks[0]["val"]]
        assert ranks[0]["digest"] == ranks[1]["digest"]
    files = sorted(os.path.relpath(os.path.join(d, f), runs["ckpt"])
                   for d, _, fs in os.walk(runs["ckpt"]) for f in fs if "tb" not in d)
    assert files == ["ckpt_best/state.safetensors", "ckpt_latest/state.safetensors",
                     "meta_log_info.json"], files


def test_resume_across_world_sizes(runs):
    straight, resumed = runs["two"], runs["two_resumed"]
    assert [r["start_epoch"] for r in resumed] == [1, 1]
    # at the same world size: bit-equal losses and state
    for a, b in zip(resumed, straight):
        assert losses(a) == losses(b)[1:]
        assert a["digest"] == b["digest"]
    # at 1 rank: within the tolerance of the 2-rank run that goes on
    one = runs["one_resumed"][0]
    assert one["start_epoch"] == 1 and len(losses(one)) == 1
    want = losses(straight[0])[1]
    assert abs(losses(one)[0] - want) <= RTOL * abs(want)


def test_tensor_axis_trains_through_the_cli(runs):
    one, tensor = runs["one"][0], runs["tensor2"]
    assert [r["mesh"] for r in tensor] == [{"data": 1, "fsdp": 1, "tensor": 2}] * 2
    assert [r["rows"] for r in tensor] == [[0, 1], [0, 1]]
    assert losses(tensor[0]) == losses(tensor[1]) and len(losses(tensor[0])) == 2
    for a, b in zip(losses(tensor[0]), losses(one)):
        assert abs(a - b) <= RTOL * abs(b), (losses(tensor[0]), losses(one))
    assert [r["writes"] for r in tensor] == [2, 0]
    assert tensor[0]["digest"] == tensor[1]["digest"]
    for r in tensor:
        assert [m for _, m in r["val_metric"]] == [v["gIoU"] for v in tensor[0]["val"]]


def test_tensor_axis_logs_a_ranks_share_of_the_flops(runs):
    """Each tensor rank counts its share of the LM (half at tensor 2) and
    the vision tower and SAM2 whole (they run whole on every rank), on the
    same batches as one process: between half and all of one process's
    FLOPs (`test_torch_flops` holds the formula)."""
    one, tensor = runs["one"][0], runs["tensor2"]
    assert tensor[0]["flops"] == tensor[1]["flops"]
    for whole, share in zip(one["flops"], tensor[0]["flops"]):
        assert whole / 2 < share < whole, (whole, share)

