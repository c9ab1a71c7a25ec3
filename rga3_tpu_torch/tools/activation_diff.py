"""Per-block activation diff: the port's Qwen2.5-VL decoder against HF
transformers', layer by layer, at a chosen compute dtype. Counterpart of
`scripts/activation_diff.py`.

    python -m rga3_tpu_torch.tools.activation_diff --tiny --dtype fp32 --device cpu
    python -m rga3_tpu_torch.tools.activation_diff --hf_dir Qwen2.5-VL-7B-Instruct \
        --dtype bf16 --len 128 --device cpu

Checkpoints were trained with CUDA flash-attn in bf16; this tool shows
where numeric divergence enters, block by block. `--tiny` draws a random
4-layer HF model from `--seed` and saves it as an HF directory; either way
the port reads the directory through its own loader (`tools/hf_oracle.py`).
HF runs in f32 on the CPU (under CPU bf16 autocast with `--dtype bf16`);
the port runs in the dtype on `--device` (default the card, as every
entry point). Each decoder layer's output is compared with HF's
`hidden_states`, the last one after the final norm (HF's last entry is
post-norm); then the logits, and the share of positions whose greedy next
token agrees. The table goes to stdout; `main` returns its numbers.

Needs the `transformers` package: without it `main` raises ImportError
naming it (the card's environment has none: run it on the CPU).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import hf_oracle


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hf_dir", default=None)
    p.add_argument("--tiny", action="store_true", help="random tiny HF model instead of --hf_dir")
    p.add_argument("--dtype", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--len", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def tiny_hf_model(seed: int):
    """The random tiny HF model of `--tiny` (vocab 5000, 4 layers)."""
    return hf_oracle.random_hf_model(hf_oracle.tiny_hf_config(5000, num_hidden_layers=4), seed)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    hf_oracle.require_transformers()
    if not args.tiny and not args.hf_dir:
        raise SystemExit("activation_diff: give --hf_dir or --tiny")
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    with tempfile.TemporaryDirectory() as tmp:
        if args.tiny:
            hf, model, cfg = hf_oracle.hf_and_port(tmp, None, hf_model=tiny_hf_model(args.seed),
                                                   device=device, dtype=dtype)
        else:
            hf = hf_oracle.load_hf_model(args.hf_dir)
            cfg = hf_oracle.port_config(hf.config)
            model = hf_oracle.port_model_from_dir(args.hf_dir, cfg, device=device, dtype=dtype)
    tc = cfg.text
    rng = np.random.default_rng(args.seed)
    ids = torch.from_numpy(rng.integers(10, min(tc.vocab_size, 30_000), (1, args.len)))

    hf_hidden, hf_logits = hf_oracle.hf_hidden_states(hf, ids, autocast_bf16=args.dtype == "bf16")
    layers, final, logits = hf_oracle.port_hidden_states(model, ids)

    print(f"dtype={args.dtype} len={args.len} layers={tc.num_hidden_layers}")
    print(f"{'block':<12}{'max_abs':>12}{'rel':>12}")
    blocks = []
    for i in range(tc.num_hidden_layers):
        # HF's final hidden_states entry is post-final-norm: compare it
        # with the port's normed hidden states
        ours = final if i == tc.num_hidden_layers - 1 else layers[i]
        ref = hf_hidden[i + 1]
        d = (ours - ref).abs().max().item()
        rel = d / (ref.abs().max().item() + 1e-9)
        blocks.append({"block": f"layers_{i}", "max_abs": d, "rel": rel})
        print(f"layers_{i:<5}{d:>12.5f}{rel:>12.2e}")
    d = (logits - hf_logits).abs().max().item()
    logits_rel = d / (hf_logits.abs().max().item() + 1e-9)
    print(f"{'logits':<12}{d:>12.5f}{logits_rel:>12.2e}")
    agree = (logits.argmax(-1) == hf_logits.argmax(-1)).float().mean().item()
    print(f"greedy next-token agreement: {agree:.3f}")
    return {"dtype": args.dtype, "len": args.len, "blocks": blocks,
            "logits": {"max_abs": d, "rel": logits_rel}, "agreement": agree}


if __name__ == "__main__":
    main(sys.argv[1:])
