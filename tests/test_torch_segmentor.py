"""The port's UniGRSegmentor end to end against the JAX package's.

* Tiny random model, one seeded parameter tree in both packages, f32, with
  the default (fused) Hiera routes and with the unfused path: the [SEG]
  embeddings agree to 1e-4 (frames whose size needs no Qwen resize, so both
  LLMs see the same pixels) and the thresholded masks on >= 99.9% of pixels
  (the SAM frames are resized by PIL in the JAX package and by torch's
  antialiased bicubic in the port, within one 8-bit level).
* The learned tiny checkpoint (runs/learning_proof_tiny/params_f16.npz)
  through the weight bridge, on the ReasonSeg-layout fixture with seed 11,
  following scripts/verify_checkpoints.py (config 9), both packages on the
  default (fused) tiny config: the port's gIoU and cIoU within 0.01 of the
  JAX package's, and above 0.5.
"""
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rga3_tpu.config import SegHeadConfig as JaxSegHead
from rga3_tpu.data.processor import QwenVLProcessor as JaxProcessor
from rga3_tpu.evaluation.segmentor import UniGRSegmentor as JaxSegmentor
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.sam2 import tiny_sam2_config as jax_tiny_sam2
from rga3_tpu.models.unigr import UniGR as JaxUniGR, UniGRConfig as JaxUniGRConfig
from rga3_tpu_torch.config import SegHeadConfig
from rga3_tpu_torch.convert import load_params_npz, torch_state_dict_from_flax
from rga3_tpu_torch.data.processor import QwenVLProcessor
from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config, unfused
from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig

from torch_port_support import jax_param_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_ID = 151665
KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28,
          video_max_pixels=16 * 28 * 28)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_segment_video_multi_matches_jax(fused):
    jsam = jax_tiny_sam2(64)
    if not fused:
        jsam = jsam.replace(hiera=jsam.hiera.replace(
            use_fused_block=False, use_fused_transition=False))
    sam = tiny_sam2_config(64) if fused else unfused(tiny_sam2_config(64))
    jcfg = JaxUniGRConfig(qwen=jax_tiny_config(152_000), sam2=jsam,
                          seg=JaxSegHead(out_dim=32, seg_token_id=SEG_ID))
    jm = JaxUniGR(jcfg)
    params = jax_param_tree(jm, jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 1, 32)),
                            jnp.zeros((1, 8), jnp.int32), seed=5)
    jseg = JaxSegmentor(jm, params, JaxProcessor.from_pretrained("dummy", **KW),
                        num_frames_mllm=2, sam_chunk=2, compute_dtype=jnp.float32)
    cfg = UniGRConfig(qwen=tiny_config(152_000), sam2=sam,
                      seg=SegHeadConfig(out_dim=32, seg_token_id=SEG_ID))
    tm = UniGR(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    tseg = UniGRSegmentor(tm, QwenVLProcessor.from_pretrained("dummy", **KW),
                          num_frames_mllm=2, sam_chunk=2)

    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (56, 84, 3), dtype=np.uint8) for _ in range(3)]
    je, jh = jseg._seg_embedding(frames, "the moving thing")
    te, th = tseg._seg_embedding(frames, "the moving thing")
    assert jh and th
    np.testing.assert_allclose(te.numpy(), je, atol=1e-4, rtol=0)
    exprs = ["the moving thing", "a dog"]
    jmask = jseg.segment_video_multi(frames, exprs)
    tmask = tseg.segment_video_multi(frames, exprs)
    assert tmask.shape == jmask.shape == (2, 3, 56, 84) and tmask.dtype == bool
    assert (tmask == jmask).mean() >= 0.999


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_learned_checkpoint_giou_matches_jax(tmp_path):
    from rga3_tpu.evaluation.image_seg_eval import run_reason_seg_val
    from synth_data import build_learn_root

    npz = os.path.join(ROOT, "runs", "learning_proof_tiny", "params_f16.npz")
    elt = _load_script("export_learned_tiny")
    jmodel, jcfg, jproc = elt.build_train_tiny_model()
    jparams = elt.load_params_npz(npz)
    build_learn_root(str(tmp_path), seed=11)  # positions unseen in training
    jscores = elt.eval_giou(jmodel, jparams, jproc, str(tmp_path), n=6)

    proc = QwenVLProcessor.from_pretrained("dummy")
    q = tiny_config()
    q = q.replace(text=q.text.replace(lora_rank=128, lora_alpha=256.0))
    sam = tiny_sam2_config()
    cfg = UniGRConfig(qwen=q, sam2=sam,
                      seg=SegHeadConfig(out_dim=sam.d_model, seg_token_id=proc.seg_token_id))
    tm = UniGR(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(load_params_npz(npz)), strict=True)
    tseg = UniGRSegmentor(tm, proc, num_frames_mllm=2)
    tscores = run_reason_seg_val(tseg, str(tmp_path), split="val", max_samples=6)
    assert tscores["n"] == jscores["n"] == 6
    for key in ("gIoU", "cIoU"):
        assert tscores[key] > 0.5
        assert abs(tscores[key] - jscores[key]) <= 0.01, (key, tscores, jscores)
