"""The port's visual-prompt overlays and region-QA builders against the JAX
package's, on the CPU, under the same Python and numpy seeds:

* `image_blending` for every shape of `WORDS_SHAPE`, from a mask, from a box
  and from polygons, `blend_image_from_mask` and `video_blending_keyframes`:
  the blended images byte-equal;
* `vip_processor` for every dataset type of `VISUAL_PROMPT_CONFIG` (and the
  eval-time VCR styles): the image bytes and the conversation strings equal;
* the builders (`get_color_shape`, `get_all_qa`, `get_answer`, the VCR,
  Flickr30k, Visual7W and PointQA builders, `vip_conv_generator`),
  `sample_shape_colors` and `substitute_region_markers`: the same strings.
"""
import copy
import random

import numpy as np
import pytest
from PIL import Image

from rga3_tpu.data.templates import WORDS_SHAPE as JAX_WORDS_SHAPE
from rga3_tpu.data.visual_prompts import builders as jb
from rga3_tpu.data.visual_prompts import generator as jg
from rga3_tpu.data.visual_prompts import organizer as jo
from rga3_tpu_torch.data import templates
from rga3_tpu_torch.data.visual_prompts import builders as tb
from rga3_tpu_torch.data.visual_prompts import generator as tg
from rga3_tpu_torch.data.visual_prompts import organizer as to
from rga3_tpu_torch.tools.synth_trees import synth_video

COLOR_LIST = list(tg.COLOR_POOL.items())


def both(seed, f_jax, f_port):
    """(JAX result, port result) of the two calls, each after seeding
    Python's and numpy's global RNGs with `seed`."""
    out = []
    for f in (f_jax, f_port):
        random.seed(seed)
        np.random.seed(seed)
        out.append(f())
    return out


def image_bytes(x):
    if isinstance(x, tuple):
        return tuple(image_bytes(y) for y in x)
    if isinstance(x, list):
        return [image_bytes(y) for y in x]
    if isinstance(x, Image.Image):
        return (x.mode, x.size, x.tobytes())
    return x


@pytest.fixture(scope="module")
def scene():
    frames, masks = synth_video(np.random.default_rng(4), 3, 72, 96, 2)
    return [Image.fromarray(f) for f in frames], masks.astype(np.uint8)


def test_constants_match():
    assert templates.WORDS_SHAPE == JAX_WORDS_SHAPE
    assert tg.COLOR_POOL == jg.COLOR_POOL
    assert to.VISUAL_PROMPT_CONFIG == jo.VISUAL_PROMPT_CONFIG
    assert to.VISUAL_PROMPT_CONFIG_TEST == jo.VISUAL_PROMPT_CONFIG_TEST
    for name in ("WHY_QUESTIONS", "QUESTION_PREFIXES", "OPTIONS_PREFIXES", "DESCRIBE_QUESTIONS",
                 "ANSWER_MAP"):
        assert getattr(tb, name) == getattr(jb, name), name
    for name in ("SHORT_QUESTION_LIST", "LONG_QUESTION_LIST", "EXPLANATORY_QUESTION_LIST",
                 "ANSWER_LIST", "VISUAL_PROMPT", "REFERRING_VQA_PROMPT"):
        from rga3_tpu.data import templates as jt
        assert getattr(templates, name) == getattr(jt, name), name


@pytest.mark.parametrize("shape", list(JAX_WORDS_SHAPE))
def test_image_blending_matches_jax(scene, shape):
    frames, masks = scene
    box = (20.0, 12.0, 70.0, 50.0)
    poly = [[22, 14, 68, 16, 60, 48, 25, 44]]
    calls = [
        dict(mask=masks[0, 0]),
        dict(bbox_coord=box),
        dict(segmentation=poly, image_size_anchor=448, alpha=200),
        dict(mask=masks[1, 0], rgb_value=(10, 200, 30), visual_prompt_style="constant"),
        dict(bbox_coord=box, width=3, return_vip_img=True),
    ]
    for seed in range(4):
        for kw in calls:
            want, got = both(seed, lambda: jg.image_blending(frames[0], shape=shape, **kw),
                             lambda: tg.image_blending(frames[0], shape=shape, **kw))
            assert image_bytes(got) == image_bytes(want), (seed, kw.keys())
    blended = tg.image_blending(frames[0], shape=shape, mask=masks[0, 0])[0]
    assert blended.tobytes() != frames[0].tobytes()


@pytest.mark.parametrize("shape", ["rectangle", "mask", "arrow"])
def test_video_and_eval_blending_match_jax(scene, shape):
    frames, masks = scene
    keys = [True, False, True]
    for seed in range(3):
        for ret in (False, True):
            want, got = both(
                seed,
                lambda: jg.video_blending_keyframes(frames, list(masks[0]), keys, "red", shape,
                                                    return_vip_img=ret),
                lambda: tg.video_blending_keyframes(frames, list(masks[0]), keys, "red", shape,
                                                    return_vip_img=ret))
            assert image_bytes(got) == image_bytes(want)
        want, got = both(seed, lambda: jg.blend_image_from_mask(frames[1], masks[1, 1], "gold", shape),
                         lambda: tg.blend_image_from_mask(frames[1], masks[1, 1], "gold", shape))
        assert image_bytes(got) == image_bytes(want)


VCR_LINE = {
    "question": ["Why is", [0], "looking at", [1], "?"],
    "answer_choices": [[[0], "is hungry", "."], ["Because", [1], "is shiny", "."],
                       ["no reason", "."], [[1], "called", [0], "."]],
    "answer_label": 1,
    "rationale_choices": [[[0], "stares", "."], ["it glows", "."], [[1], "is new", "."],
                          ["habit", "."]],
    "rationale_label": 2,
    "class_names": ["person", "car"],
    "meta": {"boxes": [[10, 10, 40, 40, 0.9], [50, 20, 90, 60, 0.8]],
             "segms": [[[[12, 12], [38, 12], [38, 38], [12, 38]]],
                       [[[52, 22], [88, 22], [70, 58]], [[60, 30], [61, 31]]]]},
}
ROWS = {
    "vip_llava": {"id": "vip-1", "bboxes": [[10, 10, 40, 40], [50, 20, 90, 60]],
                  "segmentations": [[[12, 12, 38, 12, 38, 38]], None],
                  "conversations": [{"from": "human", "value": "<image>\nWhat is <bbox0> by <region1>?"},
                                    {"from": "gpt", "value": "Next to <bbox1>, <region>."}]},
    "vg_rel": {"id": "vg_rel-1", "bboxes": [[10, 10, 40, 40], [50, 20, 90, 60]],
               "answer": "(man, rides, horse)"},
    "vg_rel_gpt4v": {"id": "vg_rel-gpt4v-1", "bboxes": [[10, 10, 40, 40], [50, 20, 90, 60]],
                     "conversations": [{"from": "human", "value": "Relate <bbox0> and <bbox1>."},
                                       {"from": "gpt", "value": "(a, b, c)"}]},
    "refcocog": {"id": "refcocog-1", "bboxes": [[10, 10, 40, 40]], "answer": "a brown dog"},
    "refcocog_gpt4v": {"id": "refcocog-gpt4v-1", "bboxes": [[10, 10, 40, 40]],
                       "conversations": [{"from": "human", "value": "Describe <bbox>."},
                                         {"from": "gpt", "value": "A dog."}]},
    "v7w": {"id": "v7w-1", "question": "Which region shows the dog?",
            "bboxes": [[0, 0, 10, 10], [5, 5, 20, 20], [1, 1, 4, 4], [8, 8, 30, 30]],
            "answer": [5, 5, 20, 20]},
    "pointQA_twice": {"id": "pointQA_twice-1", "bboxes": [[10, 10, 40, 40]],
                      "general_question": "How many dogs?", "answer": "two"},
    "flickr30k": {"id": "flickr30k-1", "bbox": [[[10, 10, 50, 50]], [[60, 20, 90, 60], [5, 5, 20, 20]]],
                  "grounding": "A man <bbox0> holds a kite <bbox1> on the beach"},
    "osprey": {"id": "osprey-conv-1", "bboxes": [[10, 10, 40, 40], [50, 20, 90, 60]],
               "conversations": [{"from": "human", "value": "What is <region1> next to <region2>?"},
                                 {"from": "gpt", "value": "A tree."}]},
    "vcr": dict(VCR_LINE, id="vcr-1"),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_vip_processor_matches_jax(scene, row):
    frames, _ = scene
    prefix = ROWS[row]["id"].split("-")[0]
    dtype = prefix if prefix in jo.VISUAL_PROMPT_CONFIG else "vip_llava"
    styles = [None, "vcr_qa", "vcr_qar"] if row == "vcr" else [None]
    for seed in range(5):
        for style in styles:
            for kw in (dict(), dict(alpha=150, image_size_anchor=96)):
                want, got = both(
                    seed,
                    lambda: jo.vip_processor(copy.deepcopy(ROWS[row]), frames[2],
                                             dataset_type=dtype, visual_prompt_style=style, **kw),
                    lambda: to.vip_processor(copy.deepcopy(ROWS[row]), frames[2],
                                             dataset_type=dtype, visual_prompt_style=style, **kw))
                assert image_bytes(got) == image_bytes(want), (seed, style)


def test_builders_match_jax():
    corpus = [["Why is", [0], "chasing", [1, 2], "?"], ["Because", [1], "ran", "."]]
    sci = {0: ["red", (255, 0, 0), "rectangle"], 1: [None, (1, 2, 3), "arrow"],
           2: ["blue", (0, 0, 255), "mask"]}
    pool = ["rectangle", "ellipse", "arrow", "mask contour"]
    for seed in range(10):
        cases = [
            (lambda m: m.get_color_shape([0, 1, 2, 3], pool, COLOR_LIST)),
            (lambda m: m.get_all_qa(corpus, sci, ["dog", "cat", "ball"])),
            (lambda m: m.get_all_qa(corpus, sci, ["dog", "cat", "ball"], answer_type="direct")),
            (lambda m: [m.get_answer(c, "The dog is running.", True) for c in range(4)]),
            (lambda m: m.get_question("Is it?", ["a", "b", "c", "d"], True)),
            (lambda m: m.get_question(None, ["a", "b"], True, why_question=True)),
            (lambda m: m.create_question_prompt(copy.deepcopy(VCR_LINE), pool, COLOR_LIST)),
            (lambda m: m.create_question_direct_qa(copy.deepcopy(VCR_LINE), pool, COLOR_LIST)),
            (lambda m: m.create_question_direct_qar(copy.deepcopy(VCR_LINE), pool, COLOR_LIST)),
            (lambda m: m.create_question_prompt_flicker30k(copy.deepcopy(ROWS["flickr30k"]), pool,
                                                           COLOR_LIST)),
            (lambda m: m.create_question_prompt_direct(copy.deepcopy(ROWS["v7w"]), ["rectangle"],
                                                       COLOR_LIST, answer_type="direct")),
            (lambda m: m.create_question_prompt_direct_pointQA(dict(ROWS["pointQA_twice"]))),
            (lambda m: m.vip_conv_generator(copy.deepcopy(ROWS["osprey"]),
                                            [list(s) for s in sci.values()], "osprey")),
            (lambda m: m.vip_conv_generator(copy.deepcopy(ROWS["vg_rel"]),
                                            [list(s) for s in sci.values()], "vg_rel")),
            (lambda m: m.add_period_and_autocorrect("mr. smith goes ,to town")),
            (lambda m: m.build_prompt("Q?", ["a", "b", "c", "d"])),
        ]
        for f in cases:
            want, got = both(seed, lambda: f(jb), lambda: f(tb))
            assert got == want, seed
        want, got = both(seed, lambda: jo.sample_shape_colors(4, pool),
                         lambda: to.sample_shape_colors(4, pool))
        assert got == want
    sc = [("red", (255, 0, 0), "rectangle"), (None, (9, 9, 9), "ellipse")]
    convs = copy.deepcopy(ROWS["vip_llava"]["conversations"])
    assert to.substitute_region_markers(convs, sc) == jo.substitute_region_markers(convs, sc)
