"""Host-side Qwen2.5-VL processor: chat templating, smart resize, pixel
patchification and the [SEG]-extended tokenizer. The port's own copy of
`rga3_tpu/data/processor.py`, with one stated deviation: frames are resized
with torch's antialiased bicubic (`ops.resize.resize_u8_bicubic_aa`), where
the JAX package uses PIL's bicubic. The two follow the same filter and the
tests hold the difference in pixel values to a tolerance; PIL is not needed.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize_u8_bicubic_aa

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SEG_TOKEN = "[SEG]"
CHAT_TEMPLATE_PREFIX = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 4 * 28 * 28,
                 max_pixels: int = 16384 * 28 * 28) -> Tuple[int, int]:
    """HF qwen_vl_utils.smart_resize."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess_frames(frames: Sequence[np.ndarray], min_pixels: int,
                      max_pixels: int, patch_size: int = 14,
                      merge_size: int = 2, temporal_patch_size: int = 2,
                      normalize: bool = True):
    """Frames ((H, W, 3) uint8 RGB) -> (patches (L, C*tps*ps*ps), grid_thw)
    in Qwen2VLImageProcessor's patch order. normalize=False returns the
    resized uint8 values (CLIP normalization then runs in the tower)."""
    h, w = frames[0].shape[:2]
    rh, rw = smart_resize(h, w, patch_size * merge_size, min_pixels, max_pixels)
    x = resize_u8_bicubic_aa(torch.from_numpy(np.stack(frames)), (rh, rw))
    arr = x.numpy().astype(np.float32)
    if normalize:
        mean = np.asarray(OPENAI_CLIP_MEAN, np.float32) * 255.0
        std = np.asarray(OPENAI_CLIP_STD, np.float32) * 255.0
        arr = (arr - mean) / std
    arr = arr.transpose(0, 3, 1, 2)  # (T, C, H, W)
    t = arr.shape[0]
    if t % temporal_patch_size:
        extra = temporal_patch_size - t % temporal_patch_size
        arr = np.concatenate([arr, arr[-1:].repeat(extra, 0)])
        t = arr.shape[0]
    grid_t, grid_h, grid_w = t // temporal_patch_size, rh // patch_size, rw // patch_size
    c = arr.shape[1]
    patches = arr.reshape(
        grid_t, temporal_patch_size, c,
        grid_h // merge_size, merge_size, patch_size,
        grid_w // merge_size, merge_size, patch_size,
    ).transpose(0, 3, 6, 4, 7, 2, 1, 5, 8).reshape(
        grid_t * grid_h * grid_w, c * temporal_patch_size * patch_size ** 2
    )
    return patches.astype(np.float32 if normalize else np.uint8), (grid_t, grid_h, grid_w)


@dataclass
class ChatMessage:
    role: str
    content: List[Dict[str, Any]]  # {"type": "text", "text": ...} | {"type": "video"} | ...


def render_chat(messages: Sequence[ChatMessage], add_generation_prompt: bool = True) -> str:
    """Qwen2.5 chat template with vision placeholders."""
    out = []
    if not any(m.role == "system" for m in messages):
        out.append(CHAT_TEMPLATE_PREFIX)
    for m in messages:
        out.append(f"<|im_start|>{m.role}\n")
        for part in m.content:
            kind = part.get("type")
            if kind == "text":
                out.append(part["text"])
            elif kind == "image":
                out.append("<|vision_start|><|image_pad|><|vision_end|>")
            elif kind == "video":
                out.append("<|vision_start|><|video_pad|><|vision_end|>")
        out.append("<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def expand_vision_tokens(text: str, image_grids=(), video_grids=(), merge_unit: int = 4) -> str:
    """Replace each <|image_pad|>/<|video_pad|> with grid_t*h*w/4 copies."""
    for t, h, w in image_grids:
        text = text.replace("<|image_pad|>", "<|placeholder|>" * (t * h * w // merge_unit), 1)
    for t, h, w in video_grids:
        text = text.replace("<|video_pad|>", "<|videoplaceholder|>" * (t * h * w // merge_unit), 1)
    return text.replace("<|placeholder|>", "<|image_pad|>").replace(
        "<|videoplaceholder|>", "<|video_pad|>"
    )


class WordTokenizer:
    """Minimal word-level tokenizer with the real Qwen special-token ids, for
    smoke runs and tests without tokenizer files. Words map to
    `abs(hash(word)) % 50000 + 1000`, as in the JAX package: ids agree
    between the two packages within one process."""

    SPECIALS = {
        "<|im_start|>": 151644,
        "<|im_end|>": 151645,
        "<|endoftext|>": 151643,
        "<|vision_start|>": 151652,
        "<|vision_end|>": 151653,
        "<|image_pad|>": 151655,
        "<|video_pad|>": 151656,
        SEG_TOKEN: 151665,  # inside every model's vocab
        "user": 872,
        "assistant": 77091,
    }
    pad_token_id = 151643

    def convert_tokens_to_ids(self, tok: str) -> int:
        return self.SPECIALS.get(tok, abs(hash(tok)) % 50000 + 1000)

    def __call__(self, text: str, add_special_tokens: bool = False):
        pattern = "|".join(
            re.escape(s) for s in self.SPECIALS if s.startswith("<") or s == SEG_TOKEN
        )
        ids = []
        for part in re.split(f"({pattern})", text):
            if not part:
                continue
            if part in self.SPECIALS:
                ids.append(self.SPECIALS[part])
            else:
                ids.extend(
                    self.convert_tokens_to_ids(w)
                    for w in part.replace("\n", " \n ").split(" ") if w
                )
        return {"input_ids": ids}

    def decode(self, ids) -> str:
        """Specials by name, other ids as `tok<id>` (word ids do not invert)."""
        inv = {v: k for k, v in self.SPECIALS.items()}
        return " ".join(inv.get(int(i), f"tok{int(i)}") for i in ids)


class QwenVLProcessor:
    """Tokenizer + vision preprocessing."""

    def __init__(self, tokenizer, min_pixels: int = 4 * 28 * 28,
                 max_pixels: int = 1280 * 28 * 28,
                 video_max_pixels: int = 320 * 28 * 28,
                 tokens_per_second: int = 2, ship_uint8: bool = True):
        self.tokenizer = tokenizer
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.video_max_pixels = video_max_pixels
        self.tokens_per_second = tokens_per_second
        self.ship_uint8 = ship_uint8

    @classmethod
    def from_pretrained(cls, model_dir: str, **kw):
        if model_dir == "dummy":
            return cls(WordTokenizer(), **kw)
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_dir)
        if SEG_TOKEN not in tok.get_vocab():
            tok.add_tokens(SEG_TOKEN)
        return cls(tok, **kw)

    @property
    def seg_token_id(self) -> int:
        return self.tokenizer.convert_tokens_to_ids(SEG_TOKEN)

    def __call__(self, messages: Sequence[ChatMessage], images=(), videos=(),
                 video_fps: float = 2.0, add_generation_prompt: bool = True):
        norm = not self.ship_uint8
        image_patches, image_grids, video_patches, video_grids = [], [], [], []
        for frames in images:
            p, g = preprocess_frames(list(frames), self.min_pixels, self.max_pixels, normalize=norm)
            image_patches.append(p)
            image_grids.append(g)
        for frames in videos:
            p, g = preprocess_frames(list(frames), self.min_pixels, self.video_max_pixels, normalize=norm)
            video_patches.append(p)
            video_grids.append(g)
        text = expand_vision_tokens(
            render_chat(messages, add_generation_prompt), image_grids, video_grids
        )
        ids = np.asarray(self.tokenizer(text, add_special_tokens=False)["input_ids"], np.int32)
        out: Dict[str, Any] = {
            "input_ids": ids[None],
            "attention_mask": np.ones((1, len(ids)), np.int64),
            "text": text,
        }
        if image_patches:
            out["pixel_values"] = np.concatenate(image_patches, 0)
            out["image_grid_thw"] = image_grids
        if video_patches:
            out["pixel_values_videos"] = np.concatenate(video_patches, 0)
            out["video_grid_thw"] = video_grids
            out["second_per_grid_ts"] = [2.0 / video_fps] * len(video_grids)
        return out
