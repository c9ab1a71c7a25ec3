"""Probe of `test_torch_serve.py::test_service_matches_jax`'s /api/segment
comparison: the same tiny f32 UniGR (seeded tree, 448 x 448 frames of the
test's video) through the JAX package's segmentor and the port's, the mask
logits at the original frame size, the pixels whose threshold decision
differs, and how far the logits sit from the threshold there and overall.
The port runs at each of `--threads` torch intra-op thread counts (a loaded
6-worker pytest run contends for the cores, not for a thread count; this
is the port's own reduction-order spread).

    python tests/probe_serve_masks.py [--threads 1 2 4 8]

Prints one JSON line a thread count. Runs on the CPU (it imports JAX).
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from rga3_tpu.config import SegHeadConfig as JaxSegHead
    from rga3_tpu.data.processor import QwenVLProcessor as JaxProcessor
    from rga3_tpu.evaluation.segmentor import UniGRSegmentor as JaxSegmentor
    from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
    from rga3_tpu.models.sam2 import tiny_sam2_config as jax_tiny_sam2
    from rga3_tpu.models.unigr import UniGR as JaxUniGR, UniGRConfig as JaxUniGRConfig
    from rga3_tpu.ops.resize import resize_bilinear as jax_resize
    from rga3_tpu.data.datasets.base import sam_preprocess_frame
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.convert import torch_state_dict_from_flax
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.data.video import load_frames_from_video
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
    from rga3_tpu_torch.ops.resize import resize_bilinear

    from test_serve import _make_video
    from torch_port_support import jax_param_tree

    jax.config.update("jax_platforms", "cpu")
    size, expression = 448, "the moving thing"
    kw = dict(min_pixels=4 * 28 * 28, max_pixels=256 * 28 * 28, video_max_pixels=256 * 28 * 28)
    jcfg = JaxUniGRConfig(qwen=jax_tiny_config(152_000), sam2=jax_tiny_sam2(size),
                          seg=JaxSegHead(out_dim=32, seg_token_id=151665))
    jm = JaxUniGR(jcfg)
    params = jax_param_tree(jm, jnp.zeros((2, size, size, 3)), jnp.zeros((2, 1, 32)),
                            jnp.zeros((1, 8), jnp.int32), seed=5)
    jseg = JaxSegmentor(jm, params, JaxProcessor.from_pretrained("dummy", **kw),
                        num_frames_mllm=2, sam_chunk=2, compute_dtype=jnp.float32)
    tm = UniGR(UniGRConfig(qwen=tiny_config(152_000), sam2=tiny_sam2_config(size),
                           seg=SegHeadConfig(out_dim=32, seg_token_id=151665)), device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    seg = UniGRSegmentor(tm, QwenVLProcessor.from_pretrained("dummy", **kw), num_frames_mllm=2,
                         sam_chunk=2)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v.mp4")
        _make_video(path, t=3, size=size)
        frames = load_frames_from_video(path)[0]
    h, w = frames[0].shape[:2]

    # JAX: the logits segment_video_multi thresholds, chunk by chunk
    emb, has = jseg._seg_embedding(frames, expression)
    ref = []
    for start in range(0, len(frames), 2):
        sub = frames[start:start + 2]
        x = np.stack([sam_preprocess_frame(f, size, normalize=False) for f in sub])
        x = np.pad(x, ((0, 2 - len(sub)), (0, 0), (0, 0), (0, 0)))
        feats = jseg._sam_encode_resized_u8(jseg.params, jnp.asarray(x))
        lang = jnp.broadcast_to(jnp.asarray(emb)[None, None], (2, 1, 32))
        m = jseg._sam_decode_feats(jseg.params, feats, lang)
        ref.append(np.asarray(jax_resize(m[:, 0], (h, w)))[:len(sub)])
    ref = np.concatenate(ref)

    for n in args.threads:
        torch.set_num_threads(n)
        with torch.no_grad():
            pemb, phas = seg._seg_embedding(frames, expression)
            got = []
            for start in range(0, len(frames), 2):
                sub = frames[start:start + 2]
                logits = resize_bilinear(seg.decode_logits(seg.encode_frames(sub), pemb), (h, w))
                got.append(logits.numpy()[:len(sub)])
        got = np.concatenate(got)
        # the decision both packages make: sigmoid(logit) > 0.5
        flip = (1 / (1 + np.exp(-got)) > 0.5) != (1 / (1 + np.exp(-ref)) > 0.5)
        near = np.abs(ref)
        print(json.dumps({
            "torch_threads": n, "has_seg": [bool(has), bool(phas)],
            "pixels": int(ref.size), "differing": int(flip.sum()),
            "max_abs_logit_diff": float(np.abs(got - ref).max()),
            "max_abs_logit": float(np.abs(ref).max()),
            "differing_jax_logits": ref[flip][:8].tolist(),
            "differing_port_logits": got[flip][:8].tolist(),
            "pixels_within_max_diff_of_threshold": int(
                (near <= np.abs(got - ref).max()).sum()),
            "min_abs_logit": float(near.min()),
        }), flush=True)


if __name__ == "__main__":
    main()
