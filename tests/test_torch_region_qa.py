"""The port's region-QA drivers (`evaluation/region_qa_eval.py`,
`evaluation/eval_region_qa.py`) against the JAX package's, on the CPU.

  * VideoRefer-Bench-Q on a synthetic tree in the released layout
    (`tools/synth_trees.write_videorefer_tree`: 1- and 2-object items of
    every type) with a recording chat: both packages build the same prompts
    from byte-identical frames and write byte-identical records, with STOM
    over a stub tracker, over LK and over the repo's trained CoTracker3 at
    f32 and one refinement iteration (frames at its model resolution), and
    without STOM; `eval_videorefer` gives equal accuracies;
    `run_videorefer_inference` likewise;
  * ViP-Bench: `load_vipbench_items` equal to the JAX script's (sharding,
    answered rows skipped), `suppress_token_ids` equal, and
    `run_vipbench_inference` at batch sizes 1 and 2 with the same questions,
    images and banned ids and byte-identical `v1_` answers files;
    `eval_vipbench_with_judge` with a fake judge equal;
  * a tiny UniGR from one seeded parameter tree: a 1-item VideoRefer tree
    through each package's `run_videorefer_bench_q` and `UniGRChat` gives the
    same generated tokens.
"""
import dataclasses
import json
import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from rga3_tpu.evaluation import region_qa_eval as jrq
from rga3_tpu.models.stom import cotracker3 as jct
from rga3_tpu.models.stom import stom as jstom
from rga3_tpu_torch.evaluation import eval_region_qa as tcli
from rga3_tpu_torch.evaluation import region_qa_eval as trq
from rga3_tpu_torch.models.stom import cotracker3 as tct
from rga3_tpu_torch.models.stom import stom as tstom
from rga3_tpu_torch.tools.synth_trees import write_videorefer_tree, write_vipbench_tree

from test_torch_stom import StubTracker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts import eval_region_qa as jcli  # noqa: E402


class RecordingChat:
    """Answers by a fixed rule and records every call's question, frames or
    images and banned ids."""

    def __init__(self):
        self.calls = []

    def answer(self, question, video_frames=None, images=None, suppress_ids=()):
        self.calls.append((question, [np.asarray(f).copy() for f in video_frames or []],
                           [np.asarray(f).copy() for f in images or []], list(suppress_ids)))
        return ["(B) it moves", "A", "", "C) the left one", "b"][len(self.calls) % 5]

    def answer_batch(self, questions, images_list=None, suppress_ids=()):
        return [self.answer(q, images=im, suppress_ids=suppress_ids)
                for q, im in zip(questions, images_list)]


def _same_calls(a, b):
    assert len(a) == len(b) > 0
    for (qa, fa, ia, sa), (qb, fb, ib, sb) in zip(a, b):
        assert qa == qb and sa == sb and len(fa) == len(fb) and len(ia) == len(ib)
        assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(fa + ia, fb + ib))


@pytest.fixture(scope="module")
def videorefer(tmp_path_factory):
    return write_videorefer_tree(str(tmp_path_factory.mktemp("vr") / "videorefer"), seed=11,
                                 n_items=5, n_frames=12, size=(160, 224))


@pytest.fixture(scope="module")
def shipped_f32():
    """The repo's trained CoTracker3 at f32 and one iteration in both packages."""
    params, cfg = jct.load_cotracker3(jct._SHIPPED_WEIGHTS)
    cfg1 = dataclasses.replace(cfg, compute_dtype="float32", iters=1)
    model, _ = tct.load_cotracker3(jct._SHIPPED_WEIGHTS, device="cpu")
    port = tct.CoTracker3Offline(tct.config_from_dict(dataclasses.asdict(cfg1)))
    port.load_state_dict(model.state_dict(), strict=True)
    return (jct.CoTracker3Predictor(params, jct.CoTracker3Offline(cfg1)),
            tct.CoTracker3Predictor(port.eval(), device="cpu"))


@pytest.mark.parametrize("tracker", ["stub", "lk", "cotracker3", "none"])
def test_videorefer_bench_q_matches_jax(tmp_path, monkeypatch, videorefer, tracker, request):
    if tracker == "stub":
        monkeypatch.setattr(jstom, "default_tracker", lambda: StubTracker(4))
        monkeypatch.setattr(tstom, "default_tracker", lambda device=None: StubTracker(4))
    elif tracker == "cotracker3":
        jpred, tpred = request.getfixturevalue("shipped_f32")
        monkeypatch.setattr(jstom, "default_tracker", lambda: jpred)
        monkeypatch.setattr(tstom, "default_tracker", lambda device=None: tpred)
    else:
        monkeypatch.setenv("RGA3_STOM_TRACKER", "lk")
    runs = {}
    for name, mod in (("jax", jrq), ("port", trq)):
        chat, out = RecordingChat(), str(tmp_path / f"{name}.jsonl")
        kw = {} if name == "jax" else {"device": "cpu"}
        random.seed(5)  # the overlay's line width is drawn from Python's random
        n = mod.run_videorefer_bench_q(chat, videorefer["question_file"],
                                       videorefer["video_folder"], out, num_frames=6,
                                       use_stom=tracker != "none", **kw)
        again = mod.run_videorefer_bench_q(RecordingChat(), videorefer["question_file"],
                                           videorefer["video_folder"], out, num_frames=6,
                                           use_stom=tracker != "none", **kw)
        with open(out, "rb") as f:
            runs[name] = (n, again, chat.calls, f.read(), mod.eval_videorefer(out))
    (nj, aj, cj, fj, ej), (nt, at, ct, ft, et) = runs["jax"], runs["port"]
    assert nj == nt == 5 and aj == at == 0
    _same_calls(cj, ct)
    assert fj == ft and ej == et
    assert {json.loads(x)["type"] for x in ft.decode().splitlines()} == set(et) - {"overall"}
    q0 = ct[1][0]
    assert "<object" not in q0 and "the object within" in q0 and "ellipse" in q0
    assert q0.endswith("Answer with the option's letter from the given choices directly.")
    # item 0's overlay: on its key frame(s) alone without STOM, propagated with it
    from PIL import Image

    with open(videorefer["question_file"]) as f:
        key = json.load(f)[0]["frame_idx"]
    selected = sorted(np.linspace(0, 11, 5, dtype=int).tolist() + [key])
    vdir = os.path.join(videorefer["video_folder"], "vr0000")
    raw = [np.asarray(Image.open(os.path.join(vdir, f"{i:05d}.jpg")).convert("RGB"))
           for i in selected]
    changed = sum(not np.array_equal(a, b) for a, b in zip(ct[0][1], raw))
    keys = selected.count(key)
    assert changed == keys if tracker == "none" else keys < changed <= len(selected), changed


def test_videorefer_inference_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jstom, "default_tracker", lambda: StubTracker(6))
    monkeypatch.setattr(tstom, "default_tracker", lambda device=None: StubTracker(6))
    rng = np.random.default_rng(7)
    items = []
    for i in range(3):
        mask = np.zeros((96, 128), np.uint8)
        mask[20 + 5 * i:60, 30:90 - 7 * i] = 1
        items.append({"id": f"q{i}", "question": f"What is in the region {i}?", "answer": "A",
                      "type": ["basic", "reason"][i % 2], "mask": mask, "key_idx": i % 2,
                      "frames": [rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
                                 for _ in range(1 + i)]})
    for use_stom in (True, False):
        runs = {}
        for name, mod in (("jax", jrq), ("port", trq)):
            chat, out = RecordingChat(), str(tmp_path / f"{name}_{use_stom}.jsonl")
            kw = {} if name == "jax" else {"device": "cpu"}
            random.seed(3)  # the ellipse's line width is drawn from Python's random
            n = mod.run_videorefer_inference(chat, items, out, use_stom=use_stom, **kw)
            assert mod.run_videorefer_inference(RecordingChat(), items, out,
                                                use_stom=use_stom, **kw) == 0
            with open(out, "rb") as f:
                runs[name] = (n, chat.calls, f.read(), mod.eval_videorefer(out))
        assert runs["jax"][0] == runs["port"][0] == 3
        _same_calls(runs["jax"][1], runs["port"][1])
        assert runs["jax"][2:] == runs["port"][2:]


# ---- ViP-Bench


class RaisingTokenizer:
    def __call__(self, w, add_special_tokens=False):
        if w == "segmentation":
            raise ValueError("no such word")
        return {"input_ids": [len(w), 7, 151665]}


def test_vipbench_matches_jax(tmp_path):
    from rga3_tpu_torch.data.processor import QwenVLProcessor

    tok = QwenVLProcessor.from_pretrained("dummy").tokenizer
    for t in (tok, RaisingTokenizer()):
        assert trq.suppress_token_ids(t) == jrq.suppress_token_ids(t)
    sup = trq.suppress_token_ids(tok)
    assert 151665 in sup

    vip = write_vipbench_tree(str(tmp_path / "vip"), seed=12, n_images=5, size=(48, 64))
    for batch_size in (1, 2):
        runs = {}
        for name, mod, cli in (("jax", jrq, jcli), ("port", trq, tcli)):
            out = str(tmp_path / f"{name}_{batch_size}.json")
            with open(out, "w") as f:  # one row answered already
                json.dump({"v1_3": "earlier"}, f)
            items = list(cli.load_vipbench_items(vip["question_file"], vip["image_folder"], out,
                                                 subset_idx=1, subset_num=2))
            chat = RecordingChat()
            n = mod.run_vipbench_inference(chat, iter(items), out, tokenizer=tok,
                                           batch_size=batch_size)
            with open(out, "rb") as f:
                runs[name] = ([(it["id"], it["question"]) for it in items], n, chat.calls,
                              f.read())
        (ij, nj, cj, fj), (it_, nt, ct, ft) = runs["jax"], runs["port"]
        assert ij == it_ == [(1, "What is the color of the object within the lime rectangle?")]
        assert nj == nt == 1 and fj == ft
        _same_calls(cj, ct)
        assert ct[0][3] == sup and ct[0][2][0].shape == (48, 64, 3)
        all_items = list(tcli.load_vipbench_items(vip["question_file"], vip["image_folder"],
                                                  str(tmp_path / "none.json")))
        assert [it["id"] for it in all_items] == list(range(5))
    with open(vip["meta_file"]) as f:
        meta = json.load(f)
    judge = lambda q, gt, pred: float(len(pred) % 7) + (gt in pred)  # noqa: E731
    path = str(tmp_path / "port_2.json")
    gts = {k[3:] if i % 2 else k: v for i, (k, v) in enumerate(meta.items())}
    assert (trq.eval_vipbench_with_judge(path, gts, judge, runs=3)
            == jrq.eval_vipbench_with_judge(path, gts, judge, runs=3))


# ---- a tiny UniGR through both packages

KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28, video_max_pixels=16 * 28 * 28)


class AnswerRecorder:
    def __init__(self, chat):
        self.chat, self.answers = chat, []

    def answer(self, question, video_frames=None, images=None, suppress_ids=()):
        out = self.chat.answer(question, video_frames=video_frames, images=images,
                               suppress_ids=suppress_ids)
        self.answers.append((question, out))
        return out


def test_tiny_unigr_videorefer_tokens_match_jax(tmp_path, monkeypatch):
    from rga3_tpu.data.processor import QwenVLProcessor as JaxProcessor
    from rga3_tpu.evaluation.segmentor import UniGRChat as JaxChat
    from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
    from rga3_tpu.models.qwen25vl.model import Qwen25VL as JaxQwen
    from rga3_tpu.models.qwen25vl.vision import (
        compute_vision_layout as jax_layout, layout_device_args as jax_layout_args,
    )
    from rga3_tpu_torch.convert import torch_state_dict_from_flax
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRChat
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL

    from test_torch_chat import DecodingTokenizer
    from torch_port_support import jax_param_tree

    monkeypatch.setenv("RGA3_STOM_TRACKER", "lk")
    jcfg = jax_tiny_config(vocab_size=152_000)
    la = jax_layout_args(jax_layout([(1, 4, 4)], jcfg.vision), jcfg.vision)
    params = jax_param_tree(JaxQwen(jcfg), jnp.zeros((1, 12), jnp.int32),
                            pixel_patches=jnp.zeros((16, 3 * 2 * 14 * 14)),
                            vision_layout=la, seed=13)
    tm = Qwen25VL(tiny_config(vocab_size=152_000), device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    tok = DecodingTokenizer()
    jchat = AnswerRecorder(JaxChat(JaxQwen(jcfg), params, JaxProcessor(tok, **KW),
                                   max_new_tokens=5, compute_dtype=jnp.float32))
    tchat = AnswerRecorder(UniGRChat(tm, QwenVLProcessor(tok, **KW), max_new_tokens=5))
    # 56 x 56 frames: a size neither processor resizes
    vr = write_videorefer_tree(str(tmp_path / "vr"), seed=14, n_items=2, n_frames=8,
                               size=(56, 56))
    recs = {}
    for name, mod, chat in (("jax", jrq, jchat), ("port", trq, tchat)):
        out = str(tmp_path / f"{name}.jsonl")
        kw = {} if name == "jax" else {"device": "cpu"}
        random.seed(6)
        assert mod.run_videorefer_bench_q(chat, vr["question_file"], vr["video_folder"], out,
                                          num_frames=4, **kw) == 2
        with open(out, "rb") as f:
            recs[name] = f.read()
    assert tchat.answers == jchat.answers
    assert all(len(a.split()) == 5 and a.startswith("tok") for _, a in tchat.answers)
    assert recs["jax"] == recs["port"]
