"""The port's Qwen2.5-VL against HF transformers' (tiny config, fp32, on
the CPU), counterpart of `tests/test_hf_parity.py`.

A small `transformers.Qwen2_5_VLForConditionalGeneration` with random
weights is saved as an HF directory and read back through the port's
loader (`models/qwen25vl/loader.py`), then held to transformers: text-only
logits (2e-3), vision logits (3e-3), the video M-RoPE index (equal), greedy
decode token-exact against `hf.generate`, the decode step's logits at
HF's positions (2e-3, and a +1-shifted position must miss), and greedy
decode with a vision span token-exact. This is the checkpoint-compatibility
guarantee (BASELINE.md: "UniGR-7B HF checkpoints load unchanged"). The card
has no transformers: this file runs on the CPU only.
"""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from rga3_tpu_torch.models.qwen25vl.generate import greedy_generate  # noqa: E402
from rga3_tpu_torch.models.qwen25vl.language import make_kv_cache  # noqa: E402
from rga3_tpu_torch.models.qwen25vl.positions import get_rope_index  # noqa: E402
from rga3_tpu_torch.models.qwen25vl.vision import (  # noqa: E402
    compute_vision_layout, layout_device_args,
)
from rga3_tpu_torch.tools import hf_oracle  # noqa: E402

VOCAB = 151936 + 80  # covers special tokens within tiny embedding


@pytest.fixture(scope="module")
def hf_and_ours(tmp_path_factory):
    hf_cfg = hf_oracle.tiny_hf_config(VOCAB)
    hf, model, cfg = hf_oracle.hf_and_port(str(tmp_path_factory.mktemp("hf_tiny")), hf_cfg,
                                           seed=0, device="cpu")
    return hf, hf.config, model, cfg


def _logits(model, ids, pos, **kw):
    with torch.no_grad():
        out = model(torch.as_tensor(ids), position_ids=torch.as_tensor(pos), **kw)
    return out["logits"].numpy()


def _vision_prompt(rng, hf_cfg, n_new_extra=8, grid=(1, 4, 6)):
    n_vis = grid[0] * grid[1] * grid[2] // 4
    patches = rng.normal(size=(grid[0] * grid[1] * grid[2], 3 * 2 * 14 * 14)).astype(np.float32)
    ids = rng.integers(0, 1000, size=(1, n_new_extra + n_vis)).astype(np.int64)
    ids[0, 2] = hf_cfg.vision_start_token_id
    ids[0, 3:3 + n_vis] = hf_cfg.image_token_id
    ids[0, 3 + n_vis] = hf_cfg.vision_end_token_id
    return ids, patches


def test_text_only_logits_match(hf_and_ours):
    hf, hf_cfg, model, cfg = hf_and_ours
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1000, size=(2, 9)).astype(np.int64)
    with torch.no_grad():
        out_hf = hf(input_ids=torch.tensor(ids),
                    attention_mask=torch.ones(2, 9, dtype=torch.long)).logits.numpy()
    pos, _ = get_rope_index(cfg, ids)
    np.testing.assert_allclose(_logits(model, ids, pos), out_hf, rtol=2e-3, atol=2e-3)


@pytest.mark.slow
@pytest.mark.midlane
def test_vision_logits_match(hf_and_ours):
    hf, hf_cfg, model, cfg = hf_and_ours
    rng = np.random.default_rng(1)
    grid = (1, 4, 6)  # 24 patches -> 6 merged tokens
    ids, patches = _vision_prompt(rng, hf_cfg, grid=grid)
    ids[0, 0] = 11
    with torch.no_grad():
        out_hf = hf(input_ids=torch.tensor(ids), attention_mask=torch.ones_like(torch.tensor(ids)),
                    pixel_values=torch.tensor(patches),
                    image_grid_thw=torch.tensor([list(grid)])).logits.numpy()
    la = layout_device_args(compute_vision_layout([grid], cfg.vision), cfg.vision)
    pos, _ = get_rope_index(cfg, ids, image_grid_thw=[grid])
    out = _logits(model, ids, pos, pixel_patches=torch.from_numpy(patches), vision_layout=la)
    np.testing.assert_allclose(out, out_hf, rtol=3e-3, atol=3e-3)


def test_video_rope_index_matches_hf(hf_and_ours):
    hf, hf_cfg, model, cfg = hf_and_ours
    rng = np.random.default_rng(3)
    grid = (2, 4, 4)  # video: 2 temporal groups
    n_vis = 2 * 16 // 4
    ids = rng.integers(0, 1000, size=(1, 10 + n_vis)).astype(np.int64)
    ids[0, 2] = hf_cfg.vision_start_token_id
    ids[0, 3:3 + n_vis] = hf_cfg.video_token_id
    ids[0, 3 + n_vis] = hf_cfg.vision_end_token_id
    spg = [1.5]
    pos_hf, delta_hf = hf.model.get_rope_index(
        torch.tensor(ids), video_grid_thw=torch.tensor([list(grid)]),
        second_per_grid_ts=torch.tensor(spg), attention_mask=torch.ones_like(torch.tensor(ids)))
    pos, delta = get_rope_index(cfg, ids, video_grid_thw=[grid], second_per_grid_ts=spg)
    np.testing.assert_array_equal(pos_hf.numpy(), pos)
    np.testing.assert_array_equal(delta_hf.numpy().reshape(-1), delta)


def _generate(model, cfg, ids, n_new, **kw):
    pos, deltas = get_rope_index(cfg, ids, image_grid_thw=kw.pop("grids", None))
    return greedy_generate(model, torch.as_tensor(ids), torch.ones(ids.shape, dtype=torch.long),
                           torch.as_tensor(pos), torch.as_tensor(deltas), max_new_tokens=n_new,
                           eos_token_id=VOCAB - 1, pad_token_id=0, **kw).numpy()


def test_greedy_generate_matches_hf(hf_and_ours):
    """Token-exact greedy decode vs HF .generate: locks the decode step's
    M-RoPE positions (the first generated token sits at the last prompt
    position + 1)."""
    hf, hf_cfg, model, cfg = hf_and_ours
    rng = np.random.default_rng(7)
    n_new = 6
    ids = rng.integers(0, 1000, size=(1, 9)).astype(np.int64)
    with torch.no_grad():
        hf_out = hf.generate(input_ids=torch.tensor(ids),
                             attention_mask=torch.ones(1, 9, dtype=torch.long),
                             max_new_tokens=n_new, do_sample=False, eos_token_id=VOCAB - 1,
                             pad_token_id=0).numpy()[:, ids.shape[1]:]
    np.testing.assert_array_equal(_generate(model, cfg, ids, n_new), hf_out)


def test_decode_step_logits_match_hf_positions(hf_and_ours):
    """Decode-step logits at an explicitly known position: prefill L-1
    tokens into the cache, feed token L-1 at M-RoPE position next_pos + 0,
    and match HF's full-sequence logits at row L-1; a +1-shifted position
    must not pass the same tolerance (the test is position-sensitive)."""
    hf, hf_cfg, model, cfg = hf_and_ours
    rng = np.random.default_rng(9)
    L = 10
    ids = rng.integers(0, 1000, size=(1, L)).astype(np.int64)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids),
                 attention_mask=torch.ones(1, L, dtype=torch.long)).logits.numpy()[:, -1]
    pos, deltas = get_rope_index(cfg, ids[:, :L - 1])
    next_pos = (L - 1) + int(np.asarray(deltas)[0])

    def step(shift):
        cache = make_kv_cache(cfg.text, 1, L + 4, dtype=torch.float32, device=torch.device("cpu"))
        with torch.no_grad():
            model(torch.as_tensor(ids[:, :L - 1]), position_ids=torch.as_tensor(pos),
                  segment_ids=torch.ones(1, L - 1, dtype=torch.int32), cache=cache)
            out = model(torch.as_tensor(ids[:, L - 1:]),
                        position_ids=torch.full((3, 1, 1), next_pos + shift, dtype=torch.long),
                        cache=cache)
        return out["logits"][:, -1].numpy()

    np.testing.assert_allclose(step(0), ref, rtol=2e-3, atol=2e-3)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(step(1), ref, rtol=2e-3, atol=2e-3)


def test_greedy_generate_vision_matches_hf(hf_and_ours):
    """Greedy decode with a vision span: a nonzero rope delta, so the decode
    positions exercise next_pos = len + delta."""
    hf, hf_cfg, model, cfg = hf_and_ours
    rng = np.random.default_rng(8)
    n_new = 5
    grid = (1, 4, 6)
    ids, patches = _vision_prompt(rng, hf_cfg, grid=grid)
    with torch.no_grad():
        hf_out = hf.generate(input_ids=torch.tensor(ids),
                             attention_mask=torch.ones_like(torch.tensor(ids)),
                             pixel_values=torch.tensor(patches),
                             image_grid_thw=torch.tensor([list(grid)]), max_new_tokens=n_new,
                             do_sample=False, eos_token_id=VOCAB - 1,
                             pad_token_id=0).numpy()[:, ids.shape[1]:]
    la = layout_device_args(compute_vision_layout([grid], cfg.vision), cfg.vision)
    toks = _generate(model, cfg, ids, n_new, grids=[grid], pixel_patches=torch.from_numpy(patches),
                     vision_layout=la)
    np.testing.assert_array_equal(toks, hf_out)
