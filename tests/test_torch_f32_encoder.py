"""The train step under f32 parameters (the train entry point's
`--param_dtype float32`, its release default) against the JAX package's,
on the CPU at tiny:

* module by module, the dtype of every port module's outputs in
  `train_forward` equals the dtype JAX's module of the same path gives
  (`tests/probe_f32_modules.py dtypes`): the whole of SAM2 (the Hiera trunk,
  the neck, the mask decoder), `text_hidden_fcs` and the LM's embedding
  and `lm_head` in f32, the decoder layers and the vision tower in bf16;
  the logits are f32;
* after three steps of the CLI (the batches of
  `test_torch_train_cli.py::test_cli_loss_trace_matches_jax_train_step`,
  lr 1e-3, PYTHONHASHSEED 0 in a subprocess: the dummy tokenizer's ids
  follow Python's salted str hash), the port's update (master minus start)
  against JAX's, in relative L2: the SAM2 mask decoder's and
  `text_hidden_fcs`' each within F32_UPDATE_TOL = 1e-3, the LM's and
  `lm_head`'s each within LM_UPDATE_TOL = 3e-3. Measured by
  `tests/probe_f32_modules.py updates` at hash seed 0: with SAM2's encoder
  and the head computed in bf16 (before they were held in f32) decoder
  9.67e-3, text_hidden_fcs 4.62e-3, lm_head 1.83e-3, LM 1.86e-3; held in
  f32, decoder 2.67e-4, text_hidden_fcs 2.20e-4, lm_head 1.39e-3, LM
  1.40e-3 (the LM's own bf16 rounding is the rest).
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import probe_f32_modules as probe
import test_torch_train_cli as T
from rga3_tpu_torch.data.processor import QwenVLProcessor
from rga3_tpu_torch.train import __main__ as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_UPDATE_TOL = 1e-3
LM_UPDATE_TOL = 3e-3
# modules the f32 parameters make f32 in JAX, which the port must cover
F32_MODULES = ("grounding_encoder/image_encoder", "grounding_encoder/image_encoder/trunk",
               "grounding_encoder/image_encoder/neck", "grounding_encoder/sam_mask_decoder",
               "text_hidden_fcs", "qwen/lm/lm_head", "qwen/lm/embed_tokens")


def _dtypes(out):
    """Sorted dtype names of the float tensors in a module's output."""
    found = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                found.add(str(x.dtype).replace("torch.", ""))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(out)
    return sorted(found)


def test_module_dtypes_match_jax(tmp_path):
    import jax.numpy as jnp

    tree = T.write_train_tree(str(tmp_path / "tree"), ("mevis", "reason_seg"), seed=1)
    args = cli.parse_args(T.cli_args(tree, str(tmp_path / "ck"), "--micro_batch_size", "2",
                                     "--grad_accum_steps", "1"))
    model, proc, _ = cli.build(args, torch.device("cpu"))
    batch = cli.AccumBatches(T.dataset(tree), QwenVLProcessor.from_pretrained("dummy"),
                             model.cfg, args, 0)(0)

    got = {}

    def record(name):
        def hook(mod, inp, out):
            got.setdefault(name.replace(".", "/"), _dtypes(out))
        return hook

    hooks = [m.register_forward_hook(record(name)) for name, m in model.named_modules() if name]
    try:
        with torch.no_grad():
            out = model.train_forward(**cli.stage(batch, torch.device("cpu"))[0])
    finally:
        for h in hooks:
            h.remove()
    assert torch.isfinite(out["loss"])

    jm, cfg = T.jax_model()
    params = T.jax_script().assemble_params(jm, cfg, {}, "float32")

    def train(p, b):
        return jm.apply(p, *(b[k] for k in T.TRAIN_KEYS), pixel_patches=b["pixel_patches"],
                        vision_layout={k: b[f"vl_{k}"] for k in T.VL_KEYS},
                        compute_dtype=jnp.bfloat16, method=T.JaxUniGR.train_forward,
                        capture_intermediates=True, mutable=["intermediates"])

    want = probe.output_dtypes(train, params, {k: v[0] for k, v in batch.items()})
    both = sorted(set(got) & set(want))
    assert set(F32_MODULES) <= set(both), set(F32_MODULES) - set(both)
    assert any(p.startswith("grounding_encoder/image_encoder/trunk/blocks_") for p in both)
    assert any(p.startswith("qwen/lm/model/layers_") for p in both)
    differ = {p: (got[p], want[p]) for p in both if got[p] != want[p]}
    assert not differ, differ
    assert got["qwen/lm/lm_head"] == ["float32"]


_UPDATES = """
import json, sys
sys.path[:0] = [{tests!r}, {root!r}]
import probe_f32_modules as probe
import jax
jax.config.update("jax_platforms", "cpu")
probe.updates(False)
"""


def test_updates_match_jax_within_tolerance():
    """The probe's `updates` run in a subprocess at PYTHONHASHSEED 0."""
    env = {**os.environ, "PYTHONHASHSEED": "0", "JAX_PLATFORMS": "cpu"}
    code = _UPDATES.format(tests=os.path.join(ROOT, "tests"), root=ROOT)
    with tempfile.TemporaryDirectory() as cwd:
        run = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("{")][-1]
    rel = json.loads(line)
    assert rel["decoder"] <= F32_UPDATE_TOL and rel["text_hidden_fcs"] <= F32_UPDATE_TOL, rel
    assert rel["lm"] <= LM_UPDATE_TOL and rel["lm_head"] <= LM_UPDATE_TOL, rel
    assert np.isfinite(list(v for k, v in rel.items() if k not in ("hash_seed", "f32_sam"))).all()
