"""The train CLI across ranks against one process on the same global batches:

    python -m rga3_tpu_torch.tools.train_ranks --nproc 4 --mesh_data 2 \\
        [--mesh_tensor 1] --micro_batch_size 1 --out runs/train_ranks -- <train CLI flags>

runs `python -m rga3_tpu_torch.train` twice with the given flags and
PYTHONHASHSEED=0 (the dummy tokenizer hashes words with Python's str hash):
once in one process at `--micro_batch_size` x `--mesh_data` rows a
micro-batch, then in `--nproc` processes (`torch.distributed.run`: NCCL on
one card a rank, or gloo under `--device cpu`) over a mesh of `--mesh_data`
x the rest as fsdp x `--mesh_tensor`, at `--micro_batch_size` rows a data
rank, so that both runs take the same global micro-batches. Each rank
writes its record (the steps' aux and seconds, peak memory, the bytes of
the optimizer state and of the frozen weights it holds, the warm step)
under `--out`; the tool prints one JSON object: both runs' losses, their
largest relative difference, step seconds and the ranks' records.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence


def _worker(out: str, argv: List[str]) -> None:
    """One rank of a run: the CLI's `main(argv)`, then its record."""
    import torch
    import torch.distributed as dist

    from ..parallel.fsdp import frozen_bytes
    from ..train import __main__ as cli

    summary = cli.main(argv)
    opt = summary["state"].opt
    held = sum(t.numel() * t.element_size() for name in opt.params
               for t in (opt.value(name), opt.mu[name], opt.nu[name]))
    frozen = frozen_bytes(summary["state"].model)
    rank = dist.get_rank() if dist.is_initialized() else 0
    record = {
        "rank": rank, "mesh": summary["mesh"].shape, "rows": summary["rows"],
        "steps": [{"aux": st["aux"], "seconds": st["seconds"], "phases": st["phases"],
                   "loader_wait": st["loader_wait"]} for st in summary["steps"]],
        "peak_bytes": summary["peak_bytes"], "optimizer_bytes": held,
        "trainable_param_bytes": sum(p.numel() * p.element_size()
                                     for p in opt.params.values()),
        "frozen_bytes": frozen["held"], "frozen_whole_over_fsdp_bytes": frozen["whole_over_fsdp"],
        "sharded": sum(d is not None for d in opt.dims.values()), "trainable": len(opt.params),
        "device": (torch.cuda.get_device_name(torch.cuda.current_device())
                   if torch.cuda.is_available() and summary["peak_bytes"] is not None
                   else "cpu"),
    }
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def _run(out: str, argv: List[str], nproc: int) -> List[Dict]:
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONHASHSEED="0")
    worker = [sys.executable, "-m", "rga3_tpu_torch.tools.train_ranks", "--worker", out, "--"]
    if nproc > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}", "-m", "rga3_tpu_torch.tools.train_ranks",
               "--worker", out, "--", *argv]
    else:
        cmd = worker + argv
    subprocess.run(cmd, env=env, check=True)
    records = []
    for rank in range(nproc):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            records.append(json.load(f))
    return records


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index("--") if "--" in argv else len(argv)
    own, cli_argv = argv[:split], argv[split + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_tensor", type=int, default=1)
    p.add_argument("--micro_batch_size", type=int, default=1, help="rows a rank")
    p.add_argument("--out", default="runs/train_ranks")
    args = p.parse_args(own)
    if args.worker:
        _worker(args.worker, cli_argv)
        return {}
    one = _run(os.path.join(args.out, "one"), cli_argv + [
        "--ckpt_dir", os.path.join(args.out, "one", "ckpt"), "--micro_batch_size",
        str(args.micro_batch_size * args.mesh_data)], 1)
    many = _run(os.path.join(args.out, "many"), cli_argv + [
        "--ckpt_dir", os.path.join(args.out, "many", "ckpt"), "--micro_batch_size",
        str(args.micro_batch_size), "--mesh_data", str(args.mesh_data), "--mesh_tensor",
        str(args.mesh_tensor)], args.nproc)
    losses = {name: [st["aux"]["loss"] for st in run[0]["steps"]]
              for name, run in (("one", one), ("many", many))}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["many"], losses["one"]))
    report = {"nproc": args.nproc, "losses": losses, "max_rel_diff": rel,
              "same_on_every_rank": all(
                  [st["aux"]["loss"] for st in r["steps"]] == losses["many"] for r in many),
              "one": one, "many": many}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
