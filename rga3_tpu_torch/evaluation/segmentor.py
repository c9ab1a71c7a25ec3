"""Referring video segmentation and free-form QA with UniGR, counterparts
of `UniGRSegmentor` and `UniGRChat` in `rga3_tpu/evaluation/segmentor.py`.

`segment_video_multi`: sparse frames to the MLLM with the teacher-forced
"... Sure, [SEG]." conversation, the [SEG] hidden state projected to the
SAM prompt, every frame encoded once by SAM in chunks, every expression
decoded against the shared features, bilinear resize to the frame size and
sigmoid > 0.5. The frames reach SAM resized on the device: by default as
the host path's uint8 frames (PIL's bicubic in two 8-bit passes), with
`device_preprocess=True` as JAX's device route does it (a float cubic
resize with antialiasing from the native uint8 frames, then the ImageNet
statistics: no 8-bit pass, no clamp). A legacy UniGR (`UniGRLegacy`,
SAM-v1) decodes one low-resolution mask a frame, which is resized to the
frame size directly.

`UniGRChat.answer` / `answer_batch`: KV-cached greedy decoding of an
answer to a question about a video, images or text alone; with a draft
model, `answer` decodes speculatively (the same tokens).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.processor import ChatMessage, QwenVLProcessor
from ..data.templates import get_sparse_indices
from ..models.qwen25vl.generate import greedy_generate, speculative_greedy_generate
from ..models.qwen25vl.positions import get_rope_index
from ..models.qwen25vl.vision import compute_vision_layout, layout_device_args
from ..models.unigr.model import UniGR
from ..ops.resize import resize_bilinear, resize_u8_bicubic_aa, sam_preprocess_frames_device


def eval_seg_question(expression: str, benchmark: Optional[str] = None,
                      is_sent: bool = False) -> str:
    """The question of a benchmark's reference driver for an expression.

    - mevis / ytvos / davis: "Please segment the {exp lowercased} in this
      image.";
    - revos: a question ending in "?" keeps its phrasing and gets " Please
      output the segmentation mask."; otherwise a trailing "." is dropped
      when the expression starts in lower case, then the segment template;
    - reasonvos: with the metadata's `is_sent`, "{exp}. Please output the
      segmentation mask.", else the segment template;
    - None (the demo's heuristic): a question keeps its phrasing with
      " Please output segmentation mask."; otherwise "Can you segment the
      ... in this video?".
    """
    expr = expression
    if benchmark == "revos":
        if expr and expr[-1] == "?":
            return f"{expr} Please output the segmentation mask."
        if expr and expr[0].islower() and expr.endswith("."):
            expr = expr[:-1]
        return f"Please segment the {expr.lower()} in this image."
    if benchmark == "reasonvos":
        if is_sent:
            return f"{expr}. Please output the segmentation mask."
        return f"Please segment the {expr.lower()} in this image."
    if benchmark in ("mevis", "ytvos", "davis"):
        return f"Please segment the {expr.lower()} in this image."
    expr = expr.strip()
    if expr.endswith("?"):
        return f"{expr} Please output segmentation mask."
    return f"Can you segment the {expr.rstrip('.').lower()} in this video?"


def build_seg_messages(expression: str, question: Optional[str] = None) -> List[ChatMessage]:
    """Teacher-forced [SEG] conversation; the question defaults to the
    demo's (`eval_seg_question(expression)`)."""
    q = question if question is not None else eval_seg_question(expression)
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
                 num_frames_mllm: int = 8, sam_chunk: int = 8,
                 device_preprocess: bool = False):
        self.model = model
        self.processor = processor
        self.num_frames_mllm = num_frames_mllm
        self.sam_chunk = sam_chunk
        self.device_preprocess = device_preprocess
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

    def sam_frames(self, frames: Sequence[np.ndarray]) -> torch.Tensor:
        """Up to `sam_chunk` frames as SAM's input, (chunk, S, S, 3), zero
        frames padding the chunk: the host route's uint8 frames, or under
        `device_preprocess` normalized f32 frames."""
        size = self.model.sam_image_size
        u8 = torch.as_tensor(np.stack(frames), device=self.model.device)
        if self.device_preprocess:
            x = sam_preprocess_frames_device(u8, size, pad_to=self.sam_chunk)
        else:
            x = resize_u8_bicubic_aa(u8, (size, size))
            if len(frames) < self.sam_chunk:
                x = torch.cat([x, x.new_zeros(self.sam_chunk - len(frames), *x.shape[1:])])
        return x

    @torch.no_grad()
    def encode_frames(self, frames: Sequence[np.ndarray]) -> Tuple[torch.Tensor, ...]:
        """SAM features of up to `sam_chunk` frames (SAM2's (s0, s1, s2),
        SAM-v1's image embedding alone), zero frames padding the chunk;
        resized on the device."""
        t0 = time.perf_counter()
        feats = self.model.encode_frames(self.sam_frames(frames))
        self._sync()
        self.phase_seconds["sam_encode"] += time.perf_counter() - t0
        return feats

    @torch.no_grad()
    def decode_logits(self, feats, emb: torch.Tensor) -> torch.Tensor:
        """(chunk, S, S) mask logits for one [SEG]: at SAM2's resolution, or
        SAM-v1's low resolution (a quarter of its input's side)."""
        lang = emb[None, None, :].expand(self.sam_chunk, 1, emb.shape[-1])
        return self.model.decode_logits(feats, lang)

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


EOS_TOKEN_ID = 151645  # <|im_end|>
PAD_TOKEN_ID = 151643  # <|endoftext|>


class UniGRChat:
    """Free-form QA (the VideoInfer / VideoRefer / ViP-Bench paths). Takes a
    `Qwen25VL` or a `UniGR` composite (whose `qwen` it keeps) and runs on
    its device and dtype. With a `draft_model` (a smaller Qwen2.5-VL on the
    same device, which gets the same vision inputs), `answer` runs
    `speculative_greedy_generate` with `spec_k` proposals an iteration;
    `answer_batch` stays greedy. `last_stats` holds the last call's prefill
    and decode seconds and forward counts (the generators' `stats`)."""

    def __init__(self, model, processor: QwenVLProcessor, max_new_tokens: int = 64,
                 draft_model=None, spec_k: int = 4):
        if not hasattr(model.cfg, "vision"):  # a UniGR composite
            model = model.qwen
        self.model = model
        self.processor = processor
        self.max_new_tokens = max_new_tokens
        self.draft_model = draft_model
        self.spec_k = spec_k
        self.last_stats: Dict[str, float] = {}

    def encode(self, question: str, video_frames=None, images=None):
        """The processor's output for one question."""
        content: List[Dict[str, Any]] = []
        if video_frames is not None:
            content.append({"type": "video"})
        for _ in images or []:
            content.append({"type": "image"})
        content.append({"type": "text", "text": question})
        return self.processor(
            [ChatMessage("user", content)],
            videos=[video_frames] if video_frames is not None else [],
            images=[[im] for im in (images or [])],
            add_generation_prompt=True,
        )

    def prepare(self, encs, length_bucket: int = 64) -> Dict[str, Any]:
        """`greedy_generate`'s inputs for processor outputs: the prompts
        right-padded to a `length_bucket` multiple (pads masked by the
        attention mask and the cache's key validity), their vision inputs
        concatenated in order."""
        qcfg = self.model.cfg
        lens = [np.asarray(e["input_ids"]).shape[1] for e in encs]
        lmax = max(lens) + (-max(lens)) % max(length_bucket, 1)
        ids = np.full((len(encs), lmax), PAD_TOKEN_ID, np.int64)
        mask = np.zeros((len(encs), lmax), np.int64)
        grids_i: List = []
        grids_v: List = []
        spg: List = []
        patches: List[np.ndarray] = []
        for i, e in enumerate(encs):
            row = np.asarray(e["input_ids"])[0]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
            grids_i += list(e.get("image_grid_thw", []) or [])
            grids_v += list(e.get("video_grid_thw", []) or [])
            spg += list(e.get("second_per_grid_ts", []) or [])
            for key in ("pixel_values", "pixel_values_videos"):
                if key in e:
                    patches.append(np.asarray(e[key]))
        pos, deltas = get_rope_index(
            qcfg, ids, image_grid_thw=grids_i or None, video_grid_thw=grids_v or None,
            second_per_grid_ts=spg or None, attention_mask=mask,
        )
        pp = la = None
        if patches:
            la = layout_device_args(
                compute_vision_layout(list(grids_i) + list(grids_v), qcfg.vision), qcfg.vision)
            pp = torch.from_numpy(np.concatenate(patches, 0))
        return dict(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                    position_ids=torch.from_numpy(pos), rope_deltas=torch.from_numpy(deltas),
                    pixel_patches=pp, vision_layout=la)

    def _generate(self, encs, length_bucket: int, suppress_ids: Sequence[int]) -> torch.Tensor:
        stats: Dict[str, float] = {}
        toks = greedy_generate(
            self.model, **self.prepare(encs, length_bucket),
            max_new_tokens=self.max_new_tokens, eos_token_id=EOS_TOKEN_ID,
            pad_token_id=PAD_TOKEN_ID, suppress_ids=suppress_ids, stats=stats,
        )
        self.last_stats = stats
        return toks.cpu()

    def answer(self, question: str, video_frames: Optional[Sequence[np.ndarray]] = None,
               images: Optional[Sequence[np.ndarray]] = None,
               suppress_ids: Sequence[int] = ()) -> str:
        """One answer; the prompt is right-padded to a multiple of 64."""
        enc = self.encode(question, video_frames, images)
        if self.draft_model is None:
            toks = self._generate([enc], 64, suppress_ids)
        else:
            inputs = self.prepare([enc], 64)
            stats: Dict[str, float] = {}
            toks, _ = speculative_greedy_generate(
                self.model, self.draft_model, **inputs, k=self.spec_k,
                draft_pixel_patches=inputs["pixel_patches"],
                draft_vision_layout=inputs["vision_layout"],
                max_new_tokens=self.max_new_tokens, eos_token_id=EOS_TOKEN_ID,
                pad_token_id=PAD_TOKEN_ID, suppress_ids=suppress_ids, stats=stats)
            self.last_stats = stats
        return self._decode_row(toks[0].tolist())

    def _decode_row(self, ids) -> str:
        keep = []
        for t in ids:
            if t in (EOS_TOKEN_ID, PAD_TOKEN_ID):
                break
            keep.append(int(t))
        tok = self.processor.tokenizer
        return tok.decode(keep) if hasattr(tok, "decode") else " ".join(map(str, keep))

    def answer_batch(self, questions: Sequence[str],
                     video_frames_list: Optional[Sequence[Sequence[np.ndarray]]] = None,
                     images_list: Optional[Sequence[Sequence[np.ndarray]]] = None,
                     suppress_ids: Sequence[int] = (), length_bucket: int = 64) -> List[str]:
        """One batched prefill and decode over several questions. One
        modality per batch (videos, images or text alone): the tower's
        tokens are scattered in patch-concatenation order, which matches
        the text order only then."""
        if video_frames_list is not None and images_list is not None:
            raise ValueError("answer_batch: one modality per batch; pass videos or images")
        encs = [self.encode(
            q, None if video_frames_list is None else video_frames_list[i],
            None if images_list is None else images_list[i])
            for i, q in enumerate(questions)]
        toks = self._generate(encs, length_bucket, suppress_ids)
        return [self._decode_row(toks[i].tolist()) for i in range(len(questions))]
