"""Region-QA organizer, counterpart of
`rga3_tpu/data/visual_prompts/organizer.py`: the per-dataset shape pools
(`VISUAL_PROMPT_CONFIG`), unique-colour sampling, marker substitution, and
`vip_processor`, which builds a row's conversation and draws every
instance's overlay, returning (blended image, conversation turns). Unknown
dataset types raise KeyError.
"""
from __future__ import annotations

import json
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..templates import WORDS_SHAPE
from .builders import (
    create_question_direct_qa,
    create_question_direct_qar,
    create_question_prompt,
    create_question_prompt_direct,
    create_question_prompt_direct_pointQA,
    create_question_prompt_flicker30k,
    vip_conv_generator,
)
from .generator import COLOR_POOL, image_blending

# "vip_llava" is a repo extension: ViP-LLaVA instruct rows
# carry pre-built conversations with <bboxN>/<regionN> markers, handled by
# the osprey-style substitution path.
VISUAL_PROMPT_CONFIG: Dict[str, Tuple[List[str], str]] = {
    "refcocog": (["rectangle", "ellipse", "triangle", "point", "scribble",
                  "mask contour", "mask", "arrow"], ""),
    "vcr": (["rectangle", "ellipse", "triangle", "scribble",
             "mask contour", "mask", "arrow"], ""),
    "vg_rel": (["rectangle", "ellipse"], ""),
    "flickr30k": (["rectangle", "ellipse", "arrow"], ""),
    "v7w": (["rectangle"], "constant"),
    "pointQA_twice": (["rectangle"], "constant"),
    "osprey": (["rectangle", "ellipse"], ""),
    "vip_llava": (["rectangle", "ellipse", "point", "scribble", "arrow"],
                  ""),
}

# eval-time styles (ViP-Bench VCR probes use constant
# point prompts)
VISUAL_PROMPT_CONFIG_TEST: Dict[str, Tuple[List[str], str]] = {
    "vcr_qa": (["point"], "constant"),
    "vcr_qar": (["point"], "constant"),
}


def shape_phrase(color_name: Optional[str], shape: str,
                 with_preposition: bool = True) -> str:
    """'within the red rectangle' / 'the red rectangle'."""
    word1, word2 = WORDS_SHAPE[shape]
    color = f" {color_name}" if color_name else ""
    return (
        f"{word1} the{color} {word2}" if with_preposition
        else f"the{color} {word2}"
    )


def sample_shape_colors(
    n: int,
    shape_pool: Sequence[str],
    unique_colors: bool = True,
    random_rgb_prob: float = 0.5,
) -> List[Tuple[Optional[str], Tuple[int, int, int], str]]:
    """Per-instance (color_name, rgb, shape); named colors stay unique."""
    used = set()
    out = []
    for _ in range(n):
        shape = random.choice(list(shape_pool))
        for _ in range(20):
            if random.random() < random_rgb_prob:
                name, rgb = None, (
                    random.randint(0, 255), random.randint(0, 255),
                    random.randint(0, 255),
                )
            else:
                name, rgb = random.choice(list(COLOR_POOL.items()))
            if not unique_colors or rgb not in used:
                break
        used.add(rgb)
        out.append((name, rgb, shape))
    return out


def substitute_region_markers(
    conversations: List[Dict[str, str]],
    shape_colors: Sequence[Tuple[Optional[str], tuple, str]],
) -> List[Dict[str, str]]:
    """Replace <bbox>/<bboxN>/<regionN>/<region> markers with shape+color
    phrases (Osprey's `<reg(in|ion)N?>`, the digit optional; VCR's
    `<bboxN>`)."""
    out = []
    for turn in conversations:
        v = turn["value"]
        for i, (name, _, shape) in enumerate(shape_colors):
            phrase = shape_phrase(name, shape, with_preposition=False)
            v = re.sub(rf"<reg(in|ion){i + 1}?>", phrase, v)
            v = v.replace(f"<bbox{i}>", shape_phrase(name, shape))
            v = v.replace(f"<region{i}>", phrase)
        if shape_colors:
            name0, _, shape0 = shape_colors[0]
            v = v.replace("<bbox>", shape_phrase(name0, shape0))
            v = v.replace(
                "<region>",
                shape_phrase(name0, shape0, with_preposition=False),
            )
        out.append({"from": turn["from"], "value": v})
    return out


def _load_vcr_meta(source: Dict, image_folder: Optional[str]) -> Dict:
    """VCR per-image metadata (boxes/segms): `source['meta_dir']` with its
    './dataset' prefix rebased onto the image folder, or a pre-loaded dict
    in `source['meta']`."""
    if "meta" in source:
        return source["meta"]
    meta_dir = source["meta_dir"]
    if image_folder:
        meta_dir = meta_dir.replace("./dataset", image_folder)
    with open(meta_dir) as f:
        return json.load(f)


def vip_processor(
    source: Dict,
    image,
    image_size_anchor: int = 448,
    dataset_type: Optional[str] = None,
    alpha: Optional[int] = None,
    visual_prompt_style: Optional[str] = None,
    image_folder: Optional[str] = None,  # rebases VCR meta_dir paths
):
    """Overlay every instance prompt and return (image, conversation).

    VCR builds its
    conversation from raw question/answer/rationale fields (three
    sub-styles), Flickr30k from the grounded caption, V7W/PointQA from
    bbox options, refcocog/vg_rel/osprey via vip_conv_generator;
    every branch then rasterizes its instances with image_blending.

    `visual_prompt_style` selects the eval-time configs
    (VISUAL_PROMPT_CONFIG_TEST — 'vcr_qa'/'vcr_qar').
    Unknown dataset types raise KeyError.
    """
    if dataset_type is None:
        dataset_type = source["id"].split("-")[0]
    sub_type = (
        source["id"].split("-")[1] if "-" in source.get("id", "") else ""
    )
    if visual_prompt_style is not None:
        pool, style = VISUAL_PROMPT_CONFIG_TEST[visual_prompt_style]
    else:
        pool, style = VISUAL_PROMPT_CONFIG[dataset_type]
    color_list = list(COLOR_POOL.items())

    if dataset_type in {"vg_rel", "v7w", "pointQA_twice", "osprey"}:
        source["segmentations"] = [None] * len(source["bboxes"])

    if dataset_type == "vcr":
        meta = _load_vcr_meta(source, image_folder)
        if visual_prompt_style == "vcr_qa":
            shape_colors, all_idx, conversation = create_question_direct_qa(
                source, pool, color_list
            )
        elif visual_prompt_style == "vcr_qar":
            shape_colors, all_idx, conversation = create_question_direct_qar(
                source, pool, color_list
            )
        else:
            shape_colors, all_idx, conversation = create_question_prompt(
                source, pool, color_list
            )
        # boxes drop the score column; segms keep polygons
        # with >= 4 points, innermost-last
        source["bboxes"] = [meta["boxes"][i][:-1] for i in all_idx]
        source["segmentations"] = []
        for i in all_idx:
            seg_data = []
            for seg in reversed(meta["segms"][i]):
                if len(seg) >= 4:
                    seg_data.append(list(np.array(seg).flatten()))
            source["segmentations"].append(seg_data if seg_data else None)
    elif dataset_type == "flickr30k":
        shape_colors, conversation, bboxes = create_question_prompt_flicker30k(
            source, pool, color_list
        )
        source["bboxes"] = bboxes
        source["segmentations"] = [None] * len(bboxes)
    elif dataset_type == "v7w":
        shape_colors, conversation, bboxes = create_question_prompt_direct(
            source, pool, color_list, answer_type="direct"
        )
        source["bboxes"] = bboxes
        source["segmentations"] = [None] * len(bboxes)
    elif dataset_type == "pointQA_twice":
        shape_colors, conversation = create_question_prompt_direct_pointQA(
            source
        )
    elif dataset_type == "osprey":
        # per-instance named color, globally-budgeted retry
        # against reuse
        predefined_shapes = [
            random.choice(pool) for _ in range(len(source["bboxes"]))
        ]
        used_colors: List[tuple] = []
        shape_colors = []
        num_retry = 0
        for _ in source["bboxes"]:
            color_name, color_rgb = random.choice(color_list)
            while color_rgb in used_colors and num_retry < 10:
                num_retry += 1
                color_name, color_rgb = random.choice(color_list)
            used_colors.append(color_rgb)
            shape_colors.append(
                [color_name, color_rgb, predefined_shapes[len(shape_colors)]]
            )
        conversation = vip_conv_generator(
            source, shape_colors, dataset_type, sub_type=sub_type
        )
    elif dataset_type in {"refcocog", "vg_rel", "vip_llava"}:
        # shared color across instances unless vg_rel's
        # shapes collide (then distinct named colors)
        predefined_shapes = [
            random.choice(pool) for _ in range(len(source["bboxes"]))
        ]
        if dataset_type == "vg_rel":
            prob_random = (
                0 if predefined_shapes[0] == predefined_shapes[1] else 0.5
            )
        else:
            prob_random = 0.5
        used_colors = []
        color_rgb = None
        color_name = None
        shape_colors = []
        for idx in range(len(source["bboxes"])):
            while color_rgb is None or color_rgb in used_colors:
                if random.random() < prob_random:
                    color_name, color_rgb = None, (
                        random.randint(0, 255), random.randint(0, 255),
                        random.randint(0, 255),
                    )
                else:
                    color_name, color_rgb = random.choice(color_list)
            if prob_random == 0:
                used_colors.append(color_rgb)
            shape_colors.append(
                [color_name, color_rgb, predefined_shapes[idx]]
            )
        if dataset_type == "vip_llava":
            conversation = substitute_region_markers(
                source.get("conversations", []),
                [tuple(sc) for sc in shape_colors],
            )
        else:
            conversation = vip_conv_generator(
                source, shape_colors, dataset_type, sub_type=sub_type
            )
    else:
        raise KeyError(
            f"vip_processor: unknown dataset type {dataset_type!r} "
            f"(known: {sorted(VISUAL_PROMPT_CONFIG)})"
        )

    segs = source.get("segmentations") or [None] * len(source["bboxes"])
    for (color_name, rgb, shape), bbox, seg in zip(
        shape_colors, source["bboxes"], segs
    ):
        image, _ = image_blending(
            image, shape=shape,
            bbox_coord=tuple(bbox) if bbox else None,
            segmentation=seg, rgb_value=tuple(rgb),
            image_size_anchor=image_size_anchor,
            visual_prompt_style=style, alpha=alpha,
        )
    return image, conversation
