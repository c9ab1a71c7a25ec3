"""The port's checkpoint verification on the CPU (tiny): `tools/
activation_diff.py` against HF transformers, `tools/verify_checkpoints.py`
against `scripts/verify_checkpoints.py` (its stage names) and against the
JAX package's score of the learned tiny checkpoint, its `--sam2_ckpt` /
`--cotracker_ckpt` loads, and `tools/synth_trees.build_learn_root` against
`tests/synth_data.build_learn_root` byte for byte.

* activation_diff --tiny --dtype fp32: every decoder block's and the
  logits' max |port - HF| / max |HF| <= 1e-4 (f32 both sides: ~1e-7 to
  ~4e-7), greedy next-token agreement 1.000;
* verify_checkpoints --tiny --device cpu: exit code 0, `all_ok`, the JAX
  script's stage names in its order, and config 9's gIoU / cIoU within
  1e-3 of `scripts/export_learned_tiny.eval_giou` (the JAX package's
  segmentor in bf16 compute) on the same fixture (build_learn_root, seed
  11, six val images); the port computes config 9 in f32 on the CPU.
"""
import filecmp
import importlib.util
import json
import os
import re

import pytest
import torch

from rga3_tpu_torch.tools import synth_trees, verify_checkpoints as vc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACT_TOL = 1e-4
LEARNED_TOL = 1e-3


def _jax_stage_names():
    """The stage names `scripts/verify_checkpoints.py` reports, in order."""
    with open(os.path.join(ROOT, "scripts", "verify_checkpoints.py")) as f:
        src = f.read()
    return re.findall(r'stage\(\s*report(?:\["configs"\])?,\s*"(\w+)"', src)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                      name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_activation_diff_tiny_fp32():
    pytest.importorskip("transformers")
    from rga3_tpu_torch.tools import activation_diff

    out = activation_diff.main(["--tiny", "--dtype", "fp32", "--device", "cpu"])
    assert len(out["blocks"]) == 4
    for b in out["blocks"]:
        assert b["rel"] <= ACT_TOL, b
    assert out["logits"]["rel"] <= ACT_TOL, out["logits"]
    assert out["agreement"] == 1.0


@pytest.fixture(scope="module")
def tiny_report(tmp_path_factory):
    pytest.importorskip("transformers")  # the act_diff stage
    out = str(tmp_path_factory.mktemp("verify") / "verify.json")
    rc = vc.main(["--tiny", "--device", "cpu", "--out", out])
    with open(out) as f:
        return rc, json.load(f)


def test_verify_tiny_passes_every_stage(tiny_report):
    rc, report = tiny_report
    assert rc == 0 and report["all_ok"] is True, report
    names = ["load", "act_diff"] + list(report["configs"])
    assert names == _jax_stage_names()
    assert report["act_diff"]["ok"], report["act_diff"]
    assert all(v["ok"] for v in report["configs"].values())
    assert report["configs"]["config6_spec"]["token_exact"] is True
    assert report["configs"]["config5_int4"]["int4_kernels"] > 0


def test_verify_learned_matches_jax(tiny_report, tmp_path):
    """Config 9's scores against the JAX package's driver on the same tree."""
    from synth_data import build_learn_root

    _, report = tiny_report
    got = report["configs"]["config9_learned"]
    assert got["n"] == 6 and got["gIoU"] > 0.5
    elt = _load_script("export_learned_tiny")
    jmodel, _, jproc = elt.build_train_tiny_model()
    build_learn_root(str(tmp_path), seed=11)
    want = elt.eval_giou(jmodel, elt.load_params_npz(vc.LEARNED_NPZ), jproc, str(tmp_path), n=6)
    assert want["n"] == 6
    for key in ("gIoU", "cIoU"):
        assert abs(got[key] - want[key]) <= LEARNED_TOL, (key, got, want)


def test_verify_reads_sam2_and_cotracker_checkpoints(tmp_path):
    """`--sam2_ckpt` (a `torch.save`d reference-named SAM2 state dict under
    "model", as `sam2_hiera_large.pt`) and `--cotracker_ckpt` (the official
    `scaled_offline.pth` layout: "model." names under "model"), tiny."""
    from rga3_tpu_torch.models.sam2 import loader as sam_loader
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
    from rga3_tpu_torch.models.sam2.model import Sam2Model
    from rga3_tpu_torch.models.stom import convert as tcv
    from rga3_tpu_torch.models.stom.cotracker3 import CoTracker3Offline, tiny_cotracker3_config

    sam_sd = Sam2Model(tiny_sam2_config(64), device="cpu").state_dict()
    sam_path = str(tmp_path / "sam2.pt")
    torch.save({"model": sam_loader.reference_state_dict(sam_sd)}, sam_path)
    ct = CoTracker3Offline(tiny_cotracker3_config())
    ct.init_weights(torch.Generator().manual_seed(3))
    ct_sd = tcv.export_torch_state_dict(ct)
    ct_path = str(tmp_path / "scaled_offline.pth")
    torch.save({"model": {f"model.{k}": v for k, v in ct_sd.items()}}, ct_path)

    out = str(tmp_path / "verify.json")
    rc = vc.main(["--tiny", "--device", "cpu", "--skip_act_diff", "--samples", "1",
                  "--sam2_ckpt", sam_path, "--cotracker_ckpt", ct_path, "--out", out])
    with open(out) as f:
        report = json.load(f)
    assert rc == 0 and report["all_ok"], report
    load = report["load"]
    assert load["sam2_leaves"] == len(sam_sd)
    assert load["cotracker_leaves"] == len(ct.state_dict())
    assert load["cotracker_input_dim"] == ct.cfg.input_dim
    assert load["cotracker_flow"] == [ct.cfg.flow_emb_dim, ct.cfg.flow_cat_coords]
    assert report["configs"]["config7_stom"]["backend"] == "official_ckpt"
    assert "act_diff" not in report


def test_build_learn_root_matches_synth_data(tmp_path):
    from synth_data import build_learn_root

    for seed in (0, 11):
        a = build_learn_root(str(tmp_path / f"jax{seed}"), seed=seed)
        b = synth_trees.build_learn_root(str(tmp_path / f"port{seed}"), seed=seed)
        files = []
        for dirpath, _, names in os.walk(a):
            rel = os.path.relpath(dirpath, a)
            files += [os.path.join(rel, n) for n in names]
        assert len(files) == 2 * (24 + 8)
        for rel in files:
            assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel
        got = sorted(os.path.relpath(os.path.join(d, n), b) for d, _, ns in os.walk(b) for n in ns)
        assert got == sorted(files)
