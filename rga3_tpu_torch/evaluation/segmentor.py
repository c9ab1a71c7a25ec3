"""Referring video segmentation with UniGR, counterpart of
`UniGRSegmentor` in `rga3_tpu/evaluation/segmentor.py` (its
`device_preprocess=False` route).

`segment_video_multi`: sparse frames to the MLLM with the teacher-forced
"... Sure, [SEG]." conversation, the [SEG] hidden state projected to the
SAM2 prompt, every frame encoded once by SAM2 in chunks, every expression
decoded against the shared features, bilinear resize to the frame size and
sigmoid > 0.5.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.processor import ChatMessage, QwenVLProcessor
from ..data.templates import get_sparse_indices
from ..models.qwen25vl.positions import get_rope_index
from ..models.qwen25vl.vision import compute_vision_layout, layout_device_args
from ..models.unigr.model import UniGR
from ..ops.resize import resize_bilinear, resize_u8_bicubic_aa


def default_seg_question(expression: str) -> str:
    """The question the JAX package's `eval_seg_question` builds without a
    benchmark: question-form expressions keep their phrasing."""
    expr = expression.strip()
    if expr.endswith("?"):
        return f"{expr} Please output segmentation mask."
    return f"Can you segment the {expr.rstrip('.').lower()} in this video?"


def build_seg_messages(expression: str, question: Optional[str] = None) -> List[ChatMessage]:
    """Teacher-forced [SEG] conversation."""
    q = question if question is not None else default_seg_question(expression)
    return [
        ChatMessage("user", [{"type": "video"}, {"type": "text", "text": q}]),
        ChatMessage("assistant", [{"type": "text", "text": "Sure, [SEG]."}]),
    ]


class UniGRSegmentor:
    """Runs on the model's device. `phase_seconds` accumulates the host time
    of the LLM, SAM encode and SAM decode phases (each ends in a device
    synchronize), and of the host processing inside the LLM phase
    (`llm_processor`: chat rendering, resize, patchify, rope index and
    vision layout)."""

    def __init__(self, model: UniGR, processor: QwenVLProcessor,
                 num_frames_mllm: int = 8, sam_chunk: int = 8):
        self.model = model
        self.processor = processor
        self.num_frames_mllm = num_frames_mllm
        self.sam_chunk = sam_chunk
        self.phase_seconds: Dict[str, float] = {
            "llm": 0.0, "llm_processor": 0.0, "sam_encode": 0.0, "sam_decode": 0.0,
        }

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    @torch.no_grad()
    def _seg_embedding(self, frames, expression: str,
                       question: Optional[str] = None) -> Tuple[torch.Tensor, bool]:
        """Teacher-forced LLM pass -> ([SEG] embedding (C,), has_seg)."""
        t0 = time.perf_counter()
        model, dev = self.model, self.model.device
        idx = get_sparse_indices(len(frames), self.num_frames_mllm)
        enc = self.processor(
            build_seg_messages(expression, question=question),
            videos=[[frames[i] for i in idx]], add_generation_prompt=False,
        )
        grids = enc.get("video_grid_thw", [])
        pos, _ = get_rope_index(
            model.cfg.qwen, enc["input_ids"], video_grid_thw=grids,
            second_per_grid_ts=enc.get("second_per_grid_ts"),
        )
        layout = layout_device_args(
            compute_vision_layout(grids, model.cfg.qwen.vision), model.cfg.qwen.vision
        )
        self.phase_seconds["llm_processor"] += time.perf_counter() - t0
        input_ids = torch.as_tensor(enc["input_ids"], dtype=torch.long, device=dev)
        out = model.qwen(
            input_ids=input_ids,
            position_ids=torch.as_tensor(pos, device=dev),
            pixel_patches=torch.as_tensor(enc["pixel_values_videos"], device=dev),
            vision_layout=layout, logits=False,
        )
        emb, has_seg = model.seg_embeddings(out["hidden_states"], input_ids)
        has = bool(has_seg[0])  # synchronizes
        self.phase_seconds["llm"] += time.perf_counter() - t0
        return emb[0], has

    @torch.no_grad()
    def encode_frames(self, frames: Sequence[np.ndarray]) -> Tuple[torch.Tensor, ...]:
        """SAM2 features (s0, s1, s2) of up to `sam_chunk` frames, zero
        frames padding the chunk; resized on the device."""
        t0 = time.perf_counter()
        size = self.model.cfg.sam2.image_size
        u8 = torch.as_tensor(np.stack(frames), device=self.model.device)
        x = resize_u8_bicubic_aa(u8, (size, size))
        if len(frames) < self.sam_chunk:
            x = torch.cat([x, x.new_zeros(self.sam_chunk - len(frames), *x.shape[1:])])
        feats = tuple(self.model.grounding_encoder.forward_image(x)["backbone_fpn"])
        self._sync()
        self.phase_seconds["sam_encode"] += time.perf_counter() - t0
        return feats

    @torch.no_grad()
    def decode_logits(self, feats, emb: torch.Tensor) -> torch.Tensor:
        """(chunk, S, S) mask logits at SAM resolution for one [SEG]."""
        lang = emb[None, None, :].expand(self.sam_chunk, 1, emb.shape[-1])
        out = self.model.grounding_encoder.decode_features_with_language(*feats, lang)
        return out["high_res_masks"][:, 0]

    def segment_video(self, frames, expression: str,
                      question: Optional[str] = None) -> np.ndarray:
        """(T, H, W) bool masks at the original frame size."""
        return self.segment_video_multi(
            frames, [expression], questions=None if question is None else [question]
        )[0]

    @torch.no_grad()
    def segment_video_multi(self, frames: Sequence[np.ndarray],
                            expressions: Sequence[str],
                            questions: Optional[Sequence[Optional[str]]] = None
                            ) -> np.ndarray:
        """All expressions of one video in one pass: each frame chunk is
        encoded once and every expression decodes against it. Returns
        (E, T, H, W) bool."""
        h, w = frames[0].shape[:2]
        t_all = len(frames)
        out_masks = np.zeros((len(expressions), t_all, h, w), bool)
        seg_embs, active = [], []
        for ei, expr in enumerate(expressions):
            q = questions[ei] if questions is not None else None
            emb, has_seg = self._seg_embedding(frames, expr, question=q)
            if has_seg:
                seg_embs.append(emb)
                active.append(ei)
        if not active:
            return out_masks
        for start in range(0, t_all, self.sam_chunk):
            sub = frames[start:start + self.sam_chunk]
            feats = self.encode_frames(sub)
            t0 = time.perf_counter()
            for ei, emb in zip(active, seg_embs):
                logits = resize_bilinear(self.decode_logits(feats, emb), (h, w))
                masks = (torch.sigmoid(logits) > 0.5).cpu().numpy()
                out_masks[ei, start:start + len(sub)] = masks[: len(sub)]
            self.phase_seconds["sam_decode"] += time.perf_counter() - t0
        return out_masks
