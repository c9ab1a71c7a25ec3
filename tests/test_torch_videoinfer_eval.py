"""The port's VideoInfer drivers against the JAX package's, on the CPU.

  * `eval_videoinfer.load_items` on a synthetic tree in the published layout
    (`tools/synth_trees.write_videoinfer_tree`) equals `scripts/
    eval_videoinfer.py`'s: ids, frame and overlay bytes, key_idx, shape,
    colour;
  * `merge_shards`, `build_eval_result`, `run_eval` (with a sentence
    similarity and a GPT judge function) and the GPT judge's batch requests
    give equal outputs and files;
  * the GPT judge (`gpt_judge.py`) and the baselines
    (`videoinfer_baselines.py`) through the fakes of `test_gpt_judge.py` and
    `test_videoinfer_baselines.py` in both packages: equal messages, scores
    and files;
  * the three CLIs in a fresh process at `--model_size tiny --model_dir dummy
    --device cpu`: VideoInfer infer (2 shards), merge and eval,
    VideoRefer-Bench-Q infer and eval, ViP-Bench infer, and the baselines'
    CLI with a fake transport.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rga3_tpu.evaluation import gpt_judge as jgj
from rga3_tpu.evaluation import videoinfer_baselines as jvb
from rga3_tpu.evaluation import videoinfer_eval as jvi
from rga3_tpu_torch.evaluation import eval_videoinfer as tcli
from rga3_tpu_torch.evaluation import gpt_judge as tgj
from rga3_tpu_torch.evaluation import videoinfer as tvi
from rga3_tpu_torch.evaluation import videoinfer_baselines as tvb
from rga3_tpu_torch.tools.synth_trees import (
    write_videoinfer_tree, write_videorefer_tree, write_vipbench_tree,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts import eval_videoinfer as jcli  # noqa: E402


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_videoinfer_tree(str(tmp_path_factory.mktemp("vi") / "videoinfer"), seed=3,
                                 n_videos=2, n_frames=10, size=(56, 84))


def test_load_items_equal_jax(tree):
    root = tree["data_root"]
    assert tcli.load_qa_data(root) == jcli.load_qa_data(root)
    for nf in (4, 8):
        ours = list(tcli.load_items(root, num_frames=nf))
        ref = list(jcli.load_items(root, num_frames=nf))
        assert [it["id"] for it in ours] == [it["id"] for it in ref] == tree["ids"]
        for a, b in zip(ours, ref):
            assert a.keys() == b.keys()
            for k in a:
                if k == "frames":
                    assert len(a[k]) == len(b[k]) == nf
                    assert all(x.dtype == y.dtype and np.array_equal(x, y)
                               for x, y in zip(a[k], b[k]))
                elif k == "vip_overlay":
                    assert a[k].dtype == b[k].dtype == np.uint8 and np.array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k], k
    shapes = {it["shape"] for it in ours}
    assert shapes == {"rectangle", "mask"}
    answers = tcli.load_answers(root)
    assert set(answers) == set(tree["ids"])


def _preds(path, ids, rng, drop=()):
    words = ["It", "is", "a", "red", "green", "ellipse", "moves", "to", "the", "left", "right"]
    with open(path, "w") as f:
        for i in ids:
            if i not in drop:
                f.write(json.dumps({"id": i, "pred": " ".join(rng.choice(words, 6))}) + "\n")
        f.write("not json\n")


def test_merge_eval_and_batch_requests_equal_jax(tree, tmp_path):
    root, ids = tree["data_root"], tree["ids"]
    rng = np.random.default_rng(4)
    shards = [str(tmp_path / f"pred_{k}.jsonl") for k in range(3)]
    _preds(shards[0], ids[0::2], rng)
    _preds(shards[1], ids[1::2], rng, drop=ids[3:4])
    _preds(shards[2], ids[:2], rng)  # overlaps shard 0: the later shard wins
    paths = {}
    for name, mod in (("jax", jvi), ("port", tvi)):
        paths[name] = str(tmp_path / f"{name}_merged.jsonl")
        n = mod.merge_shards(shards + [str(tmp_path / "missing.jsonl")], paths[name])
        assert n == len(ids) - 1
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    qa = tcli.load_qa_data(root)
    res = tvi.build_eval_result(paths["port"], qa)
    assert res == jvi.build_eval_result(paths["jax"], qa)
    answers = tcli.load_answers(root)
    sim = lambda h, r: float(len(set(h.split()) & set(r.split())) > 2)  # noqa: E731
    judge = lambda h, r: {"acc": float("left" in h), "score": len(h) % 5}  # noqa: E731
    for kw in ({}, {"sentence_similarity_fn": sim, "gpt_judge_fn": judge}):
        ours = tvi.run_eval(paths["port"], answers, **kw)
        assert ours == jvi.run_eval(paths["jax"], answers, **kw)
        assert ours["n"] == len(ids) - 1
    reqs = tgj.build_videoinfer_batch_requests(res)
    assert reqs == jgj.build_videoinfer_batch_requests(res)
    tgj.write_batch_requests(str(tmp_path / "port_req.jsonl"), reqs)
    jgj.write_batch_requests(str(tmp_path / "jax_req.jsonl"), reqs)
    assert (tmp_path / "port_req.jsonl").read_bytes() == (tmp_path / "jax_req.jsonl").read_bytes()


# ---- the GPT judge and the baselines, with the JAX tests' fakes

DATA = {
    "v1_1": {"question": "What is in the red box?", "answer": "a dog", "capability": ["rec"]},
    "v1_2": {"question": "Solve x within the circle", "answer": "-1 <AND> -5",
             "capability": ["math", "ocr"]},
    "v1_3": {"question": "Read the sign", "answer": "stop <OR> halt", "capability": ["ocr"]},
}
RESULTS = {"v1_1": "a dog", "v1_2": "x = -1", "v1_3": "it says stop"}


def _judge_transport():
    calls = {"n": 0}

    def transport(messages, max_tokens=3, temperature=0.0):
        calls["n"] += 1
        if calls["n"] in (1, 5, 6):  # unparseable: the retry with more temperature
            return "unsure", "fake-gpt"
        if "dog" in messages[0]["content"]:
            return "1.0", "fake-gpt"
        return ("0.5 partly", "fake-gpt") if temperature < 1 else ("0.3", "fake-gpt")

    return transport


def test_vipbench_grading_equal_jax(tmp_path):
    for q, a, p in [("q", "-1 <AND> -5", "x"), ("Q?", "a <OR> b", "b")]:
        assert tgj.build_vipbench_messages(q, a, p) == jgj.build_vipbench_messages(q, a, p)
    for c in ("0.5", "1.0 because", "great", "7.0", "", " 0.2", "0.30"):
        assert tgj.parse_vipbench_score(c) == jgj.parse_vipbench_score(c)
    outs = {}
    for name, mod in (("jax", jgj), ("port", tgj)):
        grade = str(tmp_path / f"{name}_grades.json")
        out = mod.grade_vipbench(DATA, RESULTS, _judge_transport(), grade, num_run=3)
        # partial resume: one run dropped, only it is asked again
        partial = json.loads(open(grade).read())
        for k in ("score", "model", "content"):
            partial["v1_2"][k] = partial["v1_2"][k][:2]
        with open(grade, "w") as f:
            json.dump(partial, f)
        out2 = mod.grade_vipbench(DATA, RESULTS, _judge_transport(), grade, num_run=3)
        outs[name] = (out, out2, open(grade, "rb").read(),
                      mod.aggregate_vipbench(out2, DATA, num_run=3))
    assert outs["jax"] == outs["port"]
    assert outs["port"][3]["total"] > 0


def test_videoinfer_batch_outputs_equal_jax():
    def response(cid, content):
        return json.dumps({"custom_id": cid, "response": {"body": {"choices": [
            {"message": {"content": content}}]}}})

    lines = [response("a", "{'pred': 'yes', 'score': 5}"),
             response("b", "{'pred': 'no', 'score': 9}"),
             response("c", "not a dict"), json.dumps({"custom_id": "d", "response": None}),
             "", response("e", "{'pred': 'Yes.', 'score': -2}"),
             json.dumps({"custom_id": "f", "response": {"body": {"choices": [{"message": {}}]}}})]
    assert tgj.parse_videoinfer_batch_outputs(lines) == jgj.parse_videoinfer_batch_outputs(lines)


def _baseline_items(n=3):
    rng = np.random.default_rng(0)
    overlay = np.zeros((24, 24, 4), np.uint8)
    overlay[4:12, 4:12] = (255, 0, 0, 200)
    return [{"vid_id": "vidA", "exp_id": str(i % 2), "qa_id": str(i),
             "frames": [rng.integers(0, 255, (24, 24, 3), dtype=np.uint8) for _ in range(4)],
             "question": f"What is the marked object doing ({i})?",
             "vip_overlay": overlay if i != 1 else None, "key_idx": 1} for i in range(n)]


def test_baselines_equal_jax(tmp_path):
    items = _baseline_items(4)
    for it in items:
        a = tvb.blend_key_frame(it["frames"], it["vip_overlay"], it["key_idx"])
        b = jvb.blend_key_frame(it["frames"], it["vip_overlay"], it["key_idx"])
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))
        assert tvb.build_gpt4o_messages(a, it["question"]) == jvb.build_gpt4o_messages(
            b, it["question"])
    for c in ("{'answer': 'a cat'}", '{"answer": "a dog"}', "nonsense", "{'other': 1}",
              "{'answer': 3}", "[1, 2]"):
        assert tvb.parse_json_answer(c) == jvb.parse_json_answer(c)

    def make_transport(calls):
        def transport(messages, max_tokens, temperature):
            calls.append(temperature)
            q = messages[1]["content"][-1]["text"]
            if "(0)" in q:
                return "{'answer': 'first try'}"
            if "(1)" in q:
                return "garbage" if temperature == 0.0 else "{'answer': 'second try'}"
            if "(2)" in q:
                raise RuntimeError("bad request")
            return "never valid"
        return transport

    outs = {}
    for name, mod in (("jax", jvb), ("port", tvb)):
        calls = []
        path = str(tmp_path / f"{name}_merged.json")
        first = mod.run_gpt4o_baseline(items[:2], make_transport(calls), path, save_every=1)
        res = mod.run_gpt4o_baseline(items, make_transport(calls), path)
        local_path = str(tmp_path / f"{name}_local.json")
        local = mod.run_local_baseline(items, lambda fr, q: f"{len(fr)}:{q[-3]}", local_path)
        outs[name] = (first, res, calls, open(path, "rb").read(), local,
                      open(local_path, "rb").read())
    assert outs["jax"] == outs["port"]
    assert outs["port"][1]["vidA"]["0"]["2"] == "None"


# ---- the CLIs in a fresh process


def _run(module, *args, timeout=600):
    env = {**os.environ, "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, "-m", f"rga3_tpu_torch.evaluation.{module}", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


MODEL = ["--model_dir", "dummy", "--model_size", "tiny", "--device", "cpu"]


def test_videoinfer_cli_runs_on_the_cpu(tree, tmp_path):
    root = tree["data_root"]
    for k in range(2):
        r = _run("eval_videoinfer", "--stage", "infer", "--data_root", root, "--out",
                 str(tmp_path / f"pred_{k}.jsonl"), "--subset_idx", str(k), "--subset_num", "2",
                 "--use_stom", "--batch_size", "2", "--max_new_tokens", "3", *MODEL)
        assert r.returncode == 0, r.stderr
        assert "inferred 4 items" in r.stdout
    again = _run("eval_videoinfer", "--stage", "infer", "--data_root", root, "--out",
                 str(tmp_path / "pred_0.jsonl"), "--subset_idx", "0", "--subset_num", "2",
                 "--use_stom", "--max_new_tokens", "3", *MODEL)
    assert again.returncode == 0 and "inferred 0 items" in again.stdout, again.stderr
    merged = str(tmp_path / "pred.jsonl")
    m = _run("eval_videoinfer", "--stage", "merge", "--out", merged, "--shards",
             str(tmp_path / "pred_*.jsonl"))
    assert m.returncode == 0 and "merged 8 predictions from 2 shards" in m.stdout, m.stderr
    with open(merged) as f:
        assert sorted(json.loads(line)["id"] for line in f) == sorted(tree["ids"])
    ev = _run("eval_videoinfer", "--stage", "eval", "--data_root", root, "--out", merged)
    assert ev.returncode == 0, ev.stderr
    scores = json.loads(ev.stdout[ev.stdout.index("{\n"):])
    assert scores == jvi.run_eval(merged, tcli.load_answers(root)) and scores["n"] == 8
    assert "METEOR stages:" in ev.stdout


def test_region_qa_and_baseline_clis_run_on_the_cpu(tmp_path):
    vr = write_videorefer_tree(str(tmp_path / "vr"), seed=5, n_items=2, n_frames=8, size=(56, 56))
    out = str(tmp_path / "vr_preds.jsonl")
    r = _run("eval_region_qa", "--bench", "videorefer", "--question_file", vr["question_file"],
             "--video_folder", vr["video_folder"], "--out", out, "--num_frames", "4",
             "--max_new_tokens", "3", *MODEL)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["new"] == 2
    ev = _run("eval_region_qa", "--bench", "videorefer", "--stage", "eval", "--out", out)
    assert ev.returncode == 0, ev.stderr
    from rga3_tpu.evaluation.region_qa_eval import eval_videorefer

    assert json.loads(ev.stdout) == eval_videorefer(out)

    vip = write_vipbench_tree(str(tmp_path / "vip"), seed=6, n_images=3, size=(56, 56))
    answers = str(tmp_path / "answers.json")
    r = _run("eval_region_qa", "--bench", "vipbench", "--question_file", vip["question_file"],
             "--image_folder", vip["image_folder"], "--out", answers, "--batch_size", "2",
             "--max_new_tokens", "3", *MODEL)
    assert r.returncode == 0, r.stderr
    with open(answers) as f:
        assert set(json.load(f)) == {"v1_0", "v1_1", "v1_2"}
    graded = _run("eval_region_qa", "--bench", "vipbench", "--stage", "eval", "--out", answers)
    assert graded.returncode == 2 and "GPT judge" in graded.stderr

    vi = write_videoinfer_tree(str(tmp_path / "vi"), seed=7, n_videos=1, n_frames=6,
                               size=(32, 48))
    base = str(tmp_path / "gpt4o" / "merged_result.json")
    code = ("import sys; from rga3_tpu_torch.evaluation import eval_videoinfer_baselines as m; "
            "m.main(sys.argv[1:], transport=lambda msgs, max_tokens, temperature: "
            "\"{'answer': '%d frames'}\" % (len(msgs[1]['content']) - 1))")
    r = subprocess.run([sys.executable, "-c", code, "--data_root", vi["data_root"], "--out", base,
                        "--num_frames", "4", "--subset_idx", "1", "--subset_num", "2"],
                       cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    with open(base) as f:
        res = json.load(f)
    assert res == {"video0000": {"0": {"q1": "4 frames"}, "1": {"q1": "4 frames"}}}
