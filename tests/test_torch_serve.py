"""The port's demo server (`rga3_tpu_torch.serve`) against the JAX package's,
on the CPU.

* The cases of tests/test_serve.py with the same stub models, against the
  port's server on a free port: health, index, QA (with a drawn overlay
  routed by `overlay_frac`, through an mp4 written with OpenCV), segment;
  the batcher's coalescing and its error propagation.
* The RLE codec against `rga3_tpu.utils.rle` on random masks: equal
  strings and decodes, native and numpy.
* `load_frames_from_video` against the JAX one on one mp4.
* `build_service` at `--model_size tiny --model_dir dummy` (int4, a dummy
  draft), and its pre-quantized round trip.
* One seeded tiny UniGR served by both packages: /api/qa answers equal
  strings, /api/segment RLEs equal. The frames are 448 x 448, a size
  neither the Qwen processor (a multiple of 28 within its pixel budget)
  nor SAM (its image size) resizes: the JAX package resizes with PIL and
  the port with torch, which part by one 8-bit level on some pixels.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rga3_tpu.utils import rle as jrle
from rga3_tpu_torch.serve.app import QABatcher, UniGRService, serve
from rga3_tpu_torch.utils import rle

from test_serve import StubChat, StubSegmentor, _make_video, _post_multipart


def _serve(service):
    httpd = serve(service, port=0, background=True, host="127.0.0.1")
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    httpd, url = _serve(UniGRService(chat=StubChat(), segmentor=StubSegmentor()))
    yield url
    httpd.shutdown()
    httpd.server_close()


def _video_bytes(tmp_path, **kw):
    vp = str(tmp_path / "v.mp4")
    _make_video(vp, **kw)
    with open(vp, "rb") as f:
        return vp, f.read()


def test_health_and_index(server):
    with urllib.request.urlopen(server + "/health", timeout=10) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(server + "/", timeout=10) as r:
        assert b"UniGR" in r.read()


def test_qa_endpoint(server, tmp_path):
    _, data = _video_bytes(tmp_path)
    status, out = _post_multipart(server + "/api/qa", {"question": "what moves?"},
                                  {"video": ("v.mp4", data)})
    assert status == 200
    assert "what moves?" in out["answer"]


def test_qa_endpoint_with_drawn_overlay(server, tmp_path):
    import cv2

    _, data = _video_bytes(tmp_path)
    ok, png = cv2.imencode(".png", np.full((48, 48, 3), 200, np.uint8))
    assert ok
    status, out = _post_multipart(
        server + "/api/qa", {"question": "circled object?", "overlay_frac": "1.0"},
        {"video": ("v.mp4", data), "overlay": ("overlay.png", png.tobytes())})
    assert status == 200
    n = int(out["answer"].split("(")[1].split(" ")[0])
    assert f"solid=[{n - 1}]" in out["answer"]  # the last sampled frame is the drawn one


def test_segment_endpoint(server, tmp_path):
    _, data = _video_bytes(tmp_path)
    status, out = _post_multipart(server + "/api/segment", {"expression": "the square"},
                                  {"video": ("v.mp4", data)})
    assert status == 200
    assert out["num_frames"] >= 1
    m = rle.decode(out["masks"][0])
    assert m.sum() > 0 and np.array_equal(m, jrle.decode(out["masks"][0]))


def test_qa_batcher_coalesces_concurrent_requests():
    class BatchChat:
        def __init__(self):
            self.batch_calls = []
            self.single_calls = 0

        def answer(self, q, video_frames=None, **kw):
            self.single_calls += 1
            return f"single:{q}"

        def answer_batch(self, questions, video_frames_list=None, **kw):
            self.batch_calls.append(len(questions))
            time.sleep(0.01)
            return [f"batched:{q}" for q in questions]

    chat = BatchChat()
    b = QABatcher(chat, max_batch=4, window_ms=80)
    results = {}

    def ask(i):
        results[i] = b.answer(f"q{i}", [np.zeros((4, 4, 3), np.uint8)])

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert results == {i: f"batched:q{i}" for i in range(3)}
    assert chat.batch_calls == [3] and b.batch_sizes == [3]
    assert b.answer("solo", []) == "single:solo"  # a lone request takes `answer`
    assert chat.single_calls == 1 and b.batch_sizes == [3, 1]
    b.close()  # the worker ends and lets go of the chat
    b.worker.join(timeout=10)
    assert not b.worker.is_alive()


def test_qa_batcher_propagates_errors():
    class Boom:
        def answer(self, *a, **k):
            raise RuntimeError("model exploded")

        def answer_batch(self, *a, **k):
            raise RuntimeError("model exploded")

    b = QABatcher(Boom(), max_batch=2, window_ms=10)
    with pytest.raises(RuntimeError, match="model exploded"):
        b.answer("q", [])


@pytest.mark.parametrize("route", ["native", "plain"])
def test_rle_codec_matches_jax(route):
    enc, dec = (rle.encode, rle.decode) if route == "native" else (rle.encode_plain,
                                                                   rle.decode_plain)
    rng = np.random.default_rng(0 if route == "native" else 1)
    for i in range(40):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        m = (rng.random((h, w)) < rng.random()).astype(np.uint8)
        if i % 5 == 0:  # blobs: long runs, counts past one 5-bit group
            m = np.zeros((h, w), np.uint8)
            m[h // 4:h // 2 + 1, w // 5:] = 1
        ours, ref = enc(m), jrle.encode(m)
        assert ours == ref
        assert np.array_equal(dec(ours), m) and np.array_equal(dec(ours), jrle.decode(ref))
        assert rle.area(ours) == jrle.area(ref) == int(m.sum())
        assert np.array_equal(rle.to_bbox(ours), jrle.to_bbox(ref))
    masks = [(rng.random((20, 30)) < 0.2).astype(np.uint8) for _ in range(3)]
    assert rle.merge([rle.encode(m) for m in masks]) == jrle.merge(
        [jrle.encode(m) for m in masks])
    counts = [0, 5, 70000, 3, 1 << 33]
    assert rle.counts_to_string(counts) == rle.counts_to_string_plain(counts)
    s = rle.counts_to_string(counts)
    assert rle.counts_from_string(s) == rle.counts_from_string_plain(s) == counts


@pytest.mark.parametrize("kw", [{}, {"num_frames": 3}, {"num_frames": 9}, {"sample_fps": 2.0}],
                         ids=["all", "three", "repeat", "fps"])
def test_load_frames_from_video_matches_jax(tmp_path, kw):
    from rga3_tpu.data.video import load_frames_from_video as jload
    from rga3_tpu_torch.data.video import load_frames_from_video

    vp, _ = _video_bytes(tmp_path, t=7)
    ours, jours = load_frames_from_video(vp, **kw), jload(vp, **kw)
    assert ours[1:] == jours[1:]
    assert len(ours[0]) == len(jours[0]) > 0
    for a, b in zip(ours[0], jours[0]):
        assert a.dtype == np.uint8 and np.array_equal(a, b)


def _tiny_args(*extra):
    from rga3_tpu_torch.serve.__main__ import parse_args

    return parse_args(["--model_dir", "dummy", "--model_size", "tiny", "--device", "cpu",
                       "--max_new_tokens", "3", *extra])


def test_build_service_tiny_dummy(tmp_path):
    """The int4 tiny UniGR with a dummy draft served over HTTP; then written
    by save_quantized and built again from the directory, bit for bit."""
    from rga3_tpu_torch.ops.quant import save_quantized
    from rga3_tpu_torch.serve.__main__ import build_model, build_service, parse_args

    service = build_service(_tiny_args("--int4", "--draft_dir", "dummy", "--spec_k", "2"))
    model = service.segmentor.model
    assert service.chat.draft_model is not None and service.chat.spec_k == 2
    assert model.qwen.lm.model.layers_0.mlp.up_proj.kernel_q4.dtype == torch.int8
    assert model.grounding_encoder.sam_mask_decoder.conv_s0.weight.dtype == torch.float32
    vp, data = _video_bytes(tmp_path, size=56)
    httpd, url = _serve(service)
    try:
        _, qa = _post_multipart(url + "/api/qa", {"question": "what moves?"},
                                {"video": ("v.mp4", data)})
        _, seg = _post_multipart(url + "/api/segment", {"expression": "the square"},
                                 {"video": ("v.mp4", data)})
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert len(qa["answer"].split()) <= 3 and service.chat.last_stats["steps"] >= 1
    assert seg["num_frames"] == 4 and rle.decode(seg["masks"][0]).shape == (56, 56)

    qdir = str(tmp_path / "quant")
    save_quantized(model, qdir, {"bits": 4, "mode": "int4", "arch": "unigr", "source": "dummy"})
    again, _ = build_model(parse_args(["--model_dir", qdir, "--model_size", "tiny",
                                       "--device", "cpu"]))
    sd, sd2 = model.state_dict(), again.state_dict()
    assert set(sd) == set(sd2)
    for key in sd:
        assert sd[key].dtype == sd2[key].dtype and torch.equal(sd[key], sd2[key]), key


def test_service_matches_jax(tmp_path):
    from rga3_tpu.config import SegHeadConfig as JaxSegHead
    from rga3_tpu.data.processor import QwenVLProcessor as JaxProcessor
    from rga3_tpu.evaluation.segmentor import UniGRChat as JaxChat
    from rga3_tpu.evaluation.segmentor import UniGRSegmentor as JaxSegmentor
    from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
    from rga3_tpu.models.qwen25vl.model import Qwen25VL as JaxQwen
    from rga3_tpu.models.sam2 import tiny_sam2_config as jax_tiny_sam2
    from rga3_tpu.models.unigr import UniGR as JaxUniGR, UniGRConfig as JaxUniGRConfig
    from rga3_tpu.serve.app import UniGRService as JaxService, serve as jax_serve
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.convert import torch_state_dict_from_flax
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRChat, UniGRSegmentor
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig

    from torch_port_support import jax_param_tree

    size = 448
    kw = dict(min_pixels=4 * 28 * 28, max_pixels=256 * 28 * 28,
              video_max_pixels=256 * 28 * 28)
    jcfg = JaxUniGRConfig(qwen=jax_tiny_config(152_000), sam2=jax_tiny_sam2(size),
                          seg=JaxSegHead(out_dim=32, seg_token_id=151665))
    jm = JaxUniGR(jcfg)
    params = jax_param_tree(jm, jnp.zeros((2, size, size, 3)), jnp.zeros((2, 1, 32)),
                            jnp.zeros((1, 8), jnp.int32), seed=5)
    jproc = JaxProcessor.from_pretrained("dummy", **kw)
    jservice = JaxService(
        chat=JaxChat(JaxQwen(jcfg.qwen), {"params": params["params"]["qwen"]}, jproc,
                     max_new_tokens=4, compute_dtype=jnp.float32),
        segmentor=JaxSegmentor(jm, params, jproc, num_frames_mllm=2, sam_chunk=2,
                               compute_dtype=jnp.float32),
        max_qa_frames=4)
    tm = UniGR(UniGRConfig(qwen=tiny_config(152_000), sam2=tiny_sam2_config(size),
                           seg=SegHeadConfig(out_dim=32, seg_token_id=151665)), device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    proc = QwenVLProcessor.from_pretrained("dummy", **kw)
    service = UniGRService(chat=UniGRChat(tm, proc, max_new_tokens=4),
                           segmentor=UniGRSegmentor(tm, proc, num_frames_mllm=2, sam_chunk=2),
                           max_qa_frames=4)
    _, data = _video_bytes(tmp_path, t=3, size=size)
    upload = {"video": ("v.mp4", data)}
    jhttpd = jax_serve(jservice, port=0, background=True)
    jurl = f"http://127.0.0.1:{jhttpd.server_address[1]}"
    httpd, url = _serve(service)
    try:
        replies = [(_post_multipart(u + "/api/qa", {"question": "What is shown?"}, upload)[1],
                    _post_multipart(u + "/api/segment", {"expression": "the moving thing"},
                                    upload)[1]) for u in (jurl, url)]
    finally:
        for h in (jhttpd, httpd):
            h.shutdown()
            h.server_close()
    (jqa, jseg), (qa, seg) = replies
    assert qa["answer"] == jqa["answer"] and len(qa["answer"].split()) == 4
    assert seg == jseg and seg["num_frames"] == 3
    assert 0 < sum(rle.area(m) for m in seg["masks"]) < 3 * size * size
