"""The spread of `chip_smoke.py` phase 4e's f32 check (STOM's tracker: the
layered train step on the card against the CPU) over many batches.

    PYTHONPATH=. python3 rga3_tpu_torch/tools/probe_stom_step.py \
        [--batches 20] [--seed 2026] [--threads 2] [--f64 2]

Needs an NVIDIA GPU (`--small` runs a 64x64 dry run on the CPU). Trains the
phase's layered run (`chip_smoke.STOM_TRAIN_ARGV`, `STOM_TRAIN_STEPS` steps
from a pool of `STOM_POOL` clips), then takes the run's last batch and
`--batches` - 1 fresh ones (`STOM_CHECK_BATCH` clips each from `--seed`).
For each it runs the phase's check: two f32 steps at one refinement
iteration from the trained weights, on the card and on the CPU, compared by
`chip_smoke.compare_steps` (the gate's numbers), and prints besides the
largest tensor mean of the moves apart over every element, and the card
against a second card run. For the first `--threads` batches it holds the
CPU at one thread against the CPU at its default; for the first `--f64`
batches each device's f32 gradients against the CPU's in f64 (a tensor's L2
distance over the reference's L2 norm). The last line is a JSON object of
the maxima and medians.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", type=int, default=20)
    p.add_argument("--seed", type=int, default=2026)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--f64", type=int, default=2)
    p.add_argument("--small", action="store_true", help="64x64, batch 2, 3 steps, on the CPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from rga3_tpu_torch.tools import train_cotracker as tc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cpu" if args.small else "cuda"
    if dev == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(torch.__version__, torch.version.cuda, smi.stdout.strip(), flush=True)
    train_argv = list(cs.STOM_TRAIN_ARGV)
    steps = cs.STOM_TRAIN_STEPS
    if args.small:
        train_argv[train_argv.index("--size") + 1] = "64"
        train_argv[train_argv.index("--width") + 1] = "64"
        train_argv[train_argv.index("--batch") + 1] = "2"
        steps = 3
    work = os.path.join(os.getcwd(), "build", "probe_stom_step")
    os.makedirs(work, exist_ok=True)
    run1 = tc.main([*train_argv, "--pool-size", str(cs.STOM_POOL), "--save-every", "0",
                    "--device", dev, "--steps", str(steps), "--out",
                    os.path.join(work, "trained.npz")])
    sd = {k: v.detach().cpu().clone() for k, v in run1["model"].state_dict().items()}
    check = tc.parse_args([*[a for a in train_argv if a != "--bf16"], "--train-iters", "1",
                           "--steps", "10", "--batch", str(cs.STOM_CHECK_BATCH)])
    h, w = tc.layered_config(check).model_resolution
    conf_thr = max(12.0 * h / 384.0, 3.0)

    def two_steps(d, batch, threads=None):
        """(before, after) state dicts on the host, the gradient of each
        step, the second step's lr: the phase's check on one device."""
        saved = torch.get_num_threads()
        if threads:
            torch.set_num_threads(threads)
        model, _, opt, step = tc.build_layered(check, d)
        model.load_state_dict(sd)
        before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        grads, opt_step = [], opt.step

        def keep_grads_and_step():
            grads.append({n: g.detach().cpu().clone() for n, g in opt.grads().items()
                          if g is not None})
            return opt_step()

        opt.step = keep_grads_and_step
        for _ in range(2):
            step(*tc.to_device(d, *batch))
        torch.set_num_threads(saved)
        return (before, {k: v.detach().cpu() for k, v in model.state_dict().items()}, grads,
                opt.schedule(1))

    def f64_grads(batch):
        model, _, _, _ = tc.build_layered(check, "cpu")
        model.load_state_dict(sd)
        model.double()
        f, q, g, v = tc.to_device("cpu", *batch)
        loss, _ = tc.occl_loss(model, f, q.double(), g.double(), v, conf_thr=conf_thr)
        loss.backward()
        return {n: p.grad.detach() for n, p in model.named_parameters() if p.grad is not None}

    def grad_distance(got, ref):
        """(largest tensor L2 distance / the reference's L2 norm, its tensor)."""
        worst = (0.0, "")
        for name, r in ref.items():
            zero = cs.zero_gradient_mask(name, tuple(r.shape))
            if not zero.all():
                g, r = got[name].double().numpy()[~zero], r.double().numpy()[~zero]
                worst = max(worst, (float(np.linalg.norm(g - r) / np.linalg.norm(r)), name))
        return worst

    def mean_over_all(card, cpu, lr):
        worst = 0.0
        for name, b in cpu[0].items():
            got, want = (card[1][name] - card[0][name]).numpy(), (cpu[1][name] - b).numpy()
            zero = cs.zero_gradient_mask(name, want.shape)
            if not zero.all():
                worst = max(worst, float((np.abs(got[~zero] - want[~zero]) / lr).mean()))
        return worst

    rng = np.random.default_rng(args.seed)
    rows = []
    for k in range(args.batches):
        if k == 0:
            batch = tuple(x[:cs.STOM_CHECK_BATCH] for x in run1["batch"])
        else:
            clips = [tc.make_clip(check, rng, h, w) for _ in range(cs.STOM_CHECK_BATCH)]
            batch = tuple(np.stack(x) for x in zip(*clips))
        t1 = time.perf_counter()
        card, card2, cpu = two_steps(dev, batch), two_steps(dev, batch), two_steps("cpu", batch)
        lr = cpu[3]
        c = cs.compare_steps(card[:2], cpu[:2], lr, card[2], cpu[2])
        again = cs.compare_steps(card[:2], card2[:2], lr, card[2], card2[2])
        row = {"grad": c["grad"], "one_sign_mean": c["mean"], "share": c["share"],
               "zero_move": c["zero_move"], "mean_all": mean_over_all(card, cpu, lr),
               "card_again_grad": again["grad"],
               "card_again_mean_all": mean_over_all(card, card2, lr)}
        print(f"batch {k}: gradient {c['grad']:.3e} ({c['grad_name']}), one-sign mean "
              f"{c['mean']:.3e}, share {c['share']:.3e}, zero-gradient moves "
              f"{c['zero_move']:.3f}, worst {c['worst']:.3f} ({c['worst_name']}); mean over every "
              f"element {row['mean_all']:.3e}; card against card: gradient "
              f"{again['grad']:.3e}, mean over every element {row['card_again_mean_all']:.3e} "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
        if k < args.threads:
            one = two_steps("cpu", batch, threads=1)
            row["cpu_threads_grad"] = grad_distance(one[2][1], cpu[2][1])[0]
            print(f"    CPU at 1 thread against {torch.get_num_threads()}: gradient "
                  f"{row['cpu_threads_grad']:.3e}", flush=True)
        if k < args.f64:
            ref = f64_grads(batch)
            row["card_f64_grad"], name = grad_distance(card[2][0], ref)
            row["cpu_f64_grad"], name2 = grad_distance(cpu[2][0], ref)
            print(f"    against the CPU's f64 gradient: card f32 {row['card_f64_grad']:.3e} "
                  f"({name}), CPU f32 {row['cpu_f64_grad']:.3e} ({name2})", flush=True)
        rows.append(row)
    keys = sorted({k for r in rows for k in r})
    summary = {k: {"max": max(r[k] for r in rows if k in r),
                   "median": float(np.median([r[k] for r in rows if k in r])),
                   "n": sum(k in r for r in rows)} for k in keys}
    summary["tolerances"] = {"grad": cs.STOM_GRAD_RTOL, "one_sign_mean": cs.STOM_UPDATE_MEAN,
                             "share": cs.STOM_UPDATE_SHARE, "mean_all": cs.STOM_UPDATE_MEAN}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
