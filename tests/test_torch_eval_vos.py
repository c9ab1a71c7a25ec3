"""The port's referring-VOS drivers against the JAX package's.

* Questions: `eval_seg_question` of every benchmark branch, equal strings.
* Layouts and drivers (exact): synthetic trees in the MeViS, ReVOS (root),
  ReasonVOS (list) and Ref-YTVOS (nested) layouts; one fake segmentor (a
  mask computed from the frame pixels) through both packages'
  `run_inference` gives byte-identical PNG trees, the same questions, shards
  whose union is the whole tree, and a resume that writes nothing;
  `run_eval` / `run_eval_revos` give equal dicts.
* Tiny UniGR: one seeded parameter tree in both packages, JAX's
  `run_inference` with its `UniGRSegmentor` and the port's with its own on
  a 1-video MeViS tree (T = 3, 2 expressions): masks agree on >= 99.9% of
  pixels (the SAM frames are resized by PIL in the JAX package and by
  torch in the port) and J&F within 0.01.
* The CLI, `python -m rga3_tpu_torch.evaluation.eval_vos`, infer and eval at
  tiny size on the CPU, in a fresh process.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from rga3_tpu.evaluation import segmentor as jseg_mod
from rga3_tpu.evaluation import video_seg_eval as jvse
from rga3_tpu.data.video import load_frames_from_dir as jax_load_frames
from rga3_tpu_torch.data.video import load_frames_from_dir
from rga3_tpu_torch.evaluation import segmentor as tseg_mod
from rga3_tpu_torch.evaluation import video_seg_eval as tvse
from rga3_tpu_torch.tools.synth_trees import LAYOUTS, write_vos_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QUESTION_CASES = [
    ("The Red Car", "mevis", False), ("dog", "ytvos", False), ("A Dog.", "davis", False),
    ("which one jumps?", "revos", False), ("a cat.", "revos", False),
    ("A cat.", "revos", False), ("", "revos", False), ("the cat", "revos", False),
    ("it is fast", "reasonvos", True), ("fast car", "reasonvos", False),
    ("  what moves?  ", None, False), ("The Red Car.", None, False), ("dog", None, False),
]


@pytest.mark.parametrize("expr,bench,is_sent", QUESTION_CASES)
def test_eval_seg_question_matches_jax(expr, bench, is_sent):
    assert (tseg_mod.eval_seg_question(expr, bench, is_sent=is_sent)
            == jseg_mod.eval_seg_question(expr, bench, is_sent=is_sent))
    messages = tseg_mod.build_seg_messages(expr)
    assert messages[0].content[1]["text"] == jseg_mod.build_seg_messages(expr)[0].content[1]["text"]


class FakeSegmentor:
    """Masks from the frames' pixels (a channel above a threshold, both
    picked by the expression's text), the questions recorded."""

    def __init__(self):
        self.questions = []

    def segment_video_multi(self, frames, expressions, questions=None):
        self.questions += list(questions)
        x = np.stack(frames).astype(np.int64)
        keys = [sum(map(ord, e)) for e in expressions]
        return np.stack([x[..., k % 3] > 60 + k % 80 for k in keys])

    def segment_video(self, frames, expression, question=None):
        return self.segment_video_multi(frames, [expression], [question])[0]


def _tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _tree_bytes_of_shard(root, split, bench, out, i, n):
    tvse.run_inference(FakeSegmentor(), root, split, str(out), subset_idx=i, subset_num=n,
                       benchmark=bench)
    return _tree_bytes(out)


@pytest.fixture(params=LAYOUTS)
def tree(request, tmp_path):
    layout = request.param
    t = write_vos_tree(str(tmp_path / layout), layout, split="valid", seed=len(layout),
                       n_videos=2, n_frames=3, size=(24, 40), n_expressions=5)
    return layout, t


def test_layout_and_jobs_match_jax(tree):
    bench, t = tree  # each layout is its benchmark's
    ann, frames = tvse.resolve_layout(t["data_root"], "valid", bench)
    assert (ann, frames) == jvse.resolve_layout(t["data_root"], "valid", bench)
    assert os.path.exists(ann) and frames == t["frames_root"]
    assert tvse.load_meta_expressions(ann) == jvse.load_meta_expressions(ann)
    d = os.path.join(frames, sorted(os.listdir(frames))[0])
    for a, b in zip(load_frames_from_dir(d), jax_load_frames(d)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(load_frames_from_dir(d, [2, 0]), jax_load_frames(d, [2, 0])):
        np.testing.assert_array_equal(a, b)


def test_run_inference_and_eval_match_jax(tree, tmp_path):
    layout, t = tree
    bench = layout
    root, split = t["data_root"], "valid"
    tfake, jfake = FakeSegmentor(), FakeSegmentor()
    seconds = {}
    n = tvse.run_inference(tfake, root, split, str(tmp_path / "port"), benchmark=bench,
                           seconds=seconds)
    assert n == jvse.run_inference(jfake, root, split, str(tmp_path / "jax"), benchmark=bench)
    assert n == 10 and tfake.questions == jfake.questions
    assert set(seconds) == {"load_frames", "segment", "write_png"}
    whole = _tree_bytes(tmp_path / "port")
    assert whole == _tree_bytes(tmp_path / "jax") and len(whole) == 30
    # shards: disjoint, and together the whole tree
    shards = [_tree_bytes_of_shard(root, split, bench, tmp_path / f"shard{i}", i, 3)
              for i in range(3)]
    assert sum(len(x) for x in shards) == len(whole)
    assert {k: v for x in shards for k, v in x.items()} == whole
    # resume: a finished tree is left as it is
    again = FakeSegmentor()
    mtimes = {p: os.stat(os.path.join(tmp_path, "port", p)).st_mtime_ns for p in whole}
    assert tvse.run_inference(again, root, split, str(tmp_path / "port"), benchmark=bench) == 0
    assert again.questions == []
    assert mtimes == {p: os.stat(os.path.join(tmp_path, "port", p)).st_mtime_ns for p in whole}
    if layout == "ytvos":
        return  # scored by its server
    if layout == "revos":
        mine = tvse.run_eval_revos(root, split, str(tmp_path / "port"), num_workers=1)
        ref = jvse.run_eval_revos(root, split, str(tmp_path / "jax"), num_workers=1)
    else:
        mine = tvse.run_eval(root, split, str(tmp_path / "port"), num_workers=1)
        ref = jvse.run_eval(root, split, str(tmp_path / "jax"), num_workers=1)
    assert mine == ref and mine["n"] == 10


def test_eval_missing_predictions_match_jax(tmp_path):
    """Expressions with no PNGs score as empty predictions in both."""
    t = write_vos_tree(str(tmp_path / "m"), "mevis", split="valid", seed=3, n_frames=4,
                       size=(30, 44), n_expressions=4)
    tvse.run_inference(FakeSegmentor(), t["data_root"], "valid", str(tmp_path / "out"),
                       max_jobs=2)
    assert (tvse.run_eval(t["data_root"], "valid", str(tmp_path / "out"), num_workers=1)
            == jvse.run_eval(t["data_root"], "valid", str(tmp_path / "out"), num_workers=1))


# ---- tiny UniGR through both packages' run_inference

SEG_ID = 151665
KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28, video_max_pixels=16 * 28 * 28)


def test_tiny_unigr_run_inference_matches_jax(tmp_path):
    from rga3_tpu.config import SegHeadConfig as JaxSegHead
    from rga3_tpu.data.processor import QwenVLProcessor as JaxProcessor
    from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
    from rga3_tpu.models.sam2 import tiny_sam2_config as jax_tiny_sam2
    from rga3_tpu.models.unigr import UniGR as JaxUniGR, UniGRConfig as JaxUniGRConfig
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.convert import torch_state_dict_from_flax
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig

    from torch_port_support import jax_param_tree

    jcfg = JaxUniGRConfig(qwen=jax_tiny_config(152_000), sam2=jax_tiny_sam2(64),
                          seg=JaxSegHead(out_dim=32, seg_token_id=SEG_ID))
    jm = JaxUniGR(jcfg)
    params = jax_param_tree(jm, jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 1, 32)),
                            jnp.zeros((1, 8), jnp.int32), seed=7)
    jseg = jseg_mod.UniGRSegmentor(jm, params, JaxProcessor.from_pretrained("dummy", **KW),
                                   num_frames_mllm=2, sam_chunk=2,
                                   compute_dtype=jnp.float32)
    cfg = UniGRConfig(qwen=tiny_config(152_000), sam2=tiny_sam2_config(64),
                      seg=SegHeadConfig(out_dim=32, seg_token_id=SEG_ID))
    tm = UniGR(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    tseg = tseg_mod.UniGRSegmentor(tm, QwenVLProcessor.from_pretrained("dummy", **KW),
                                   num_frames_mllm=2, sam_chunk=2)

    # 56 x 84 frames: a size the Qwen processor does not resize
    t = write_vos_tree(str(tmp_path / "mevis"), "mevis", split="valid_u", seed=4, n_frames=3,
                       size=(56, 84), n_objects=2, n_expressions=2)
    root = t["data_root"]
    assert tvse.run_inference(tseg, root, "valid_u", str(tmp_path / "port")) == 2
    assert jvse.run_inference(jseg, root, "valid_u", str(tmp_path / "jax")) == 2
    from PIL import Image

    agree = []
    for rel in _tree_bytes(tmp_path / "jax"):
        a = np.asarray(Image.open(tmp_path / "port" / rel))
        b = np.asarray(Image.open(tmp_path / "jax" / rel))
        assert a.shape == b.shape == (56, 84) and set(np.unique(a)) <= {0, 255}
        agree.append((a == b).mean())
    assert len(agree) == 6 and np.mean(agree) >= 0.999
    mine = tvse.run_eval(root, "valid_u", str(tmp_path / "port"), num_workers=1)
    ref = jvse.run_eval(root, "valid_u", str(tmp_path / "jax"), num_workers=1)
    assert mine["n"] == ref["n"] == 2
    for key in ("J", "F", "J&F"):
        assert abs(mine[key] - ref[key]) <= 0.01, (key, mine, ref)


def _cli(*args, timeout=300):
    env = {**os.environ, "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, "-m", "rga3_tpu_torch.evaluation.eval_vos", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_eval_vos_cli_runs_on_the_cpu(tmp_path):
    t = write_vos_tree(str(tmp_path / "mevis"), "mevis", seed=5, n_frames=3, size=(56, 84),
                       n_expressions=3)
    out = str(tmp_path / "out")
    common = ["--data_root", t["data_root"], "--split", "valid_u", "--out_dir", out]
    infer = _cli("--stage", "infer", *common, "--model_dir", "dummy", "--model_size", "tiny",
                 "--device", "cpu", "--num_frames_mllm", "2")
    assert infer.returncode == 0, infer.stderr
    assert "inferred 3 expressions" in infer.stdout
    assert len(_tree_bytes(out)) == 9
    ev = _cli("--stage", "eval", *common, "--num_workers", "2")
    assert ev.returncode == 0, ev.stderr
    with open(os.path.join(out, "jf_scores.json")) as f:
        scores = json.load(f)
    assert scores == jvse.run_eval(t["data_root"], "valid_u", out, num_workers=1)
    assert scores["n"] == 3 and 0.0 <= scores["J&F"] <= 1.0
    ytvos = _cli("--stage", "eval", *common, "--benchmark", "ytvos")
    assert ytvos.returncode != 0 and "no local eval stage" in ytvos.stderr
