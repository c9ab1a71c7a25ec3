"""The hand-off of a trained run, on the CPU at the tiny config, against the
JAX package: the port's export (`rga3_tpu_torch.train.export`) and its
quantize CLI (`python -m rga3_tpu_torch.tools.quantize_checkpoint`).

The trained model is a two-step run of the port's train CLI (f32 masters;
the SAM2 mask decoder and text_hidden_fcs held in f32), whose LoRA B
masters are then set to seeded nonzero values, so that the merge moves
q_proj / v_proj. The JAX side is the same model as a flax tree
(`convert.flax_tree_from_torch` of an f32 copy carrying the masters).

* The port's export equals JAX's `export_hf_safetensors(merge_lora(tree))`
  byte for byte on every Qwen and text_hidden_fcs tensor (same names);
  SAM2 is written under the reference's names, where JAX writes flax
  paths that no loader reads.
* JAX's `load_unigr_params` of the port's directory is JAX's merged tree,
  leaf for leaf, SAM2 included; the port's `load_unigr_state_dict` reads
  back the merged f32 state bit for bit and loads strictly.
* The merged model's logits are the LoRA model's within JAX's own 2e-4
  (`tests/test_export_roundtrip.py`).
* The quantize CLI against `scripts/quantize_checkpoint.py` on the port's
  export, at int4 and int8, for unigr and qwen: `load_quantized` trees
  and metas equal, and the same last printed line.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from rga3_tpu.models.qwen25vl.loader import load_qwen25vl_params, load_unigr_params
from rga3_tpu.ops import quant as jq
from rga3_tpu.train.export import export_hf_safetensors as jax_export
from rga3_tpu.train.export import merge_lora as jax_merge_lora
from rga3_tpu_torch.convert import _flatten, flax_tree_from_torch
from rga3_tpu_torch.models.qwen25vl.loader import load_unigr_state_dict
from rga3_tpu_torch.models.sam2.loader import reference_state_dict
from rga3_tpu_torch.models.unigr import UniGR
from rga3_tpu_torch.tools import quantize_checkpoint as qc
from rga3_tpu_torch.tools.synth_trees import write_train_tree
from rga3_tpu_torch.train import __main__ as cli
from rga3_tpu_torch.train import export
from rga3_tpu_torch.utils import safetensors_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LORA_R, LORA_ALPHA = 8, 16.0
SAM2 = "grounding_encoder."


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(the train state, the port's export directory, tensors written)."""
    root = tmp_path_factory.mktemp("export")
    tree = write_train_tree(str(root / "tree"), datasets=("mevis", "reason_seg"), seed=2)
    run = cli.main([
        "--model_dir", "dummy", "--model_size", "tiny", "--dataset_dir", tree,
        "--dataset", "mevis,reason_seg", "--sample_rates", "1,1", "--num_frames_mllm", "2",
        "--num_frames_sam", "2", "--lora_r", str(LORA_R), "--lora_alpha", str(LORA_ALPHA),
        "--data_workers", "0", "--device", "cpu", "--ckpt_dir", str(root / "ck"),
        "--epochs", "1", "--steps_per_epoch", "2", "--micro_batch_size", "1",
        "--grad_accum_steps", "1", "--no_eval", "--lr", "1e-3"])
    state = run["state"]
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, master in state.opt.master.items():
            if name.endswith("_lora_b"):
                master.copy_(torch.from_numpy(rng.normal(0, 0.5, master.shape)
                                              .astype(np.float32)))
                state.opt.params[name].copy_(master)
    out = str(root / "port")
    n = export.export_hf_safetensors(state, out)
    return state, out, n


def f32_model(state) -> UniGR:
    """An f32 copy of the trained model carrying its masters."""
    model = UniGR(state.model.cfg, device="cpu")
    sd = dict(state.model.state_dict())
    sd.update((n, state.opt.value(n)) for n in state.opt.master)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def jax_merged(state):
    tree = {"params": flax_tree_from_torch(f32_model(state))}
    return jax_merge_lora(tree, lora_alpha=LORA_ALPHA, lora_rank=LORA_R)


def test_export_matches_jax_bytes(trained, tmp_path):
    state, out, n = trained
    jax_export(jax_merged(state), str(tmp_path))
    ours = safetensors_io.load_file(os.path.join(out, "model.safetensors"), framework="np")
    theirs = safetensors_io.load_file(str(tmp_path / "model.safetensors"), framework="np")
    with open(os.path.join(out, "rga3_export_manifest.json")) as f:
        assert json.load(f) == {"num_tensors": n} and n == len(ours)
    head = sorted(k for k in theirs if not k.startswith(SAM2))
    assert head == sorted(k for k in ours if not k.startswith(SAM2))
    assert any(".q_proj." in k for k in head) and any(k.startswith("text_hidden_fcs") for k in head)
    for k in head:
        assert ours[k].dtype == theirs[k].dtype == np.float32 and ours[k].shape == theirs[k].shape
        assert ours[k].tobytes() == theirs[k].tobytes(), k
    # SAM2: the reference's names, where JAX writes flax paths
    sam = {k[len(SAM2):]: v for k, v in state.model.state_dict().items() if k.startswith(SAM2)}
    want = {export.SAM2_PREFIX + k for k in reference_state_dict(sam)}
    assert {k for k in ours if k.startswith(SAM2)} == want
    assert any(".blocks.0.attn.qkv." in k for k in want)
    assert any("blocks_0.attn_qkv" in k for k in theirs)
    assert all(v.dtype == np.float32 for v in ours.values())


def test_jax_loader_reads_the_export(trained):
    state, out, _ = trained
    got = _flatten(load_unigr_params(out)["params"])
    want = _flatten(jax_merged(state)["params"])
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    assert any(p[0] == "grounding_encoder" for p in want)
    for path, arr in want.items():
        assert np.asarray(got[path]).dtype == np.float32, path
        np.testing.assert_array_equal(np.asarray(got[path]), arr, err_msg="/".join(path))


def test_port_loader_reloads_the_merged_state(trained):
    state, out, _ = trained
    got = load_unigr_state_dict(out)
    want = export.merged_state_dict(state)
    assert set(got) == set(want) and not any("_lora_" in k for k in got)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v.float()), k
    cfg = state.model.cfg
    plain = cfg.replace(qwen=cfg.qwen.replace(text=cfg.qwen.text.replace(lora_rank=0)))
    UniGR(plain, device="cpu").load_state_dict(got, strict=True)


def test_merged_logits_match_the_lora_model(trained):
    state, out, _ = trained
    lora = f32_model(state)
    cfg = state.model.cfg
    merged = UniGR(cfg.replace(qwen=cfg.qwen.replace(text=cfg.qwen.text.replace(lora_rank=0))),
                   device="cpu")
    merged.load_state_dict(load_unigr_state_dict(out), strict=True)
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 2000, (2, 9)))
    with torch.no_grad():
        a = lora.qwen(ids)["logits"]
        b = merged.eval().qwen(ids)["logits"]
    base = f32_model(state)
    with torch.no_grad():
        for name, p in base.named_parameters():
            if name.endswith("_lora_b"):
                p.zero_()
        c = base.qwen(ids)["logits"]
    # the adapters move the logits by far more than the tolerance
    assert (a - c).abs().max() > 5 * 2e-4
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


def jax_quantize_script():
    spec = importlib.util.spec_from_file_location(
        "jax_quantize_script", os.path.join(ROOT, "scripts", "quantize_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["unigr", "qwen"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_cli_matches_the_jax_script(trained, tmp_path, monkeypatch, capsys, arch,
                                             bits):
    _, src, _ = trained
    flags = ["--model_dir", src, "--bits", str(bits), "--arch", arch]
    ours = qc.main(flags + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["quantize_checkpoint.py", *flags,
                                      "--out", str(tmp_path / "jax")])
    jax_quantize_script().main()
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(port_line) == ours == {**json.loads(jax_line), "out": str(tmp_path / "port")}
    got, got_meta = jq.load_quantized(str(tmp_path / "port"))
    script, script_meta = jq.load_quantized(str(tmp_path / "jax"))
    assert got_meta == script_meta == {"bits": bits, "mode": f"int{bits}", "arch": arch,
                                       "source": os.path.abspath(src)}
    # the tree the JAX script holds before it writes (its loader and quantizer)
    if arch == "unigr":
        tree = load_unigr_params(src)["params"]
        tree["qwen"] = jq.quantize_for_serving(tree["qwen"], f"int{bits}")
    else:
        tree = jq.quantize_for_serving(load_qwen25vl_params(src)["params"], f"int{bits}")
    want = _flatten(tree)
    got, script = _flatten(got["params"]), _flatten(script["params"])
    assert set(got) == set(script) == set(want), sorted(set(got) ^ set(want))[:5]
    assert any(p[-1] == ("kernel_q4" if bits == 4 else "kernel_q") for p in want)
    views = 0
    for path, arr in want.items():
        assert got[path].dtype == arr.dtype and np.array_equal(got[path], arr), path
        # reference edge: safetensors' numpy writer stores an array's memory
        # as it lies, so the script writes each leaf its loader left as a
        # transposed view (SAM2's kernels, the merger, the patch embedding,
        # text_hidden_fcs) in memory order; the port writes the values
        if not arr.flags.c_contiguous:
            arr = arr.ravel(order="K").reshape(arr.shape)
            views += 1
        assert np.array_equal(script[path], arr), path
    assert views > 0


def test_quantize_cli_needs_cuda_unless_cpu_is_asked(trained, tmp_path, monkeypatch):
    _, src, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qc.main(["--model_dir", src, "--out", str(tmp_path / "q"), "--bits", "8"])
    assert not (tmp_path / "q").exists()
    with pytest.raises(ValueError, match="match no"):
        qc.model_for({"lm.embed_tokens.weight": torch.zeros(3, 4)}, "qwen", "cpu")
