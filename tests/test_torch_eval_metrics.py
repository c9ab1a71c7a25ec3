"""The port's host-side metric code against the JAX package's, on the same
numpy inputs made from a seed. Exact equality throughout (the same numpy
arithmetic in both), except where stated.

* jf_metrics: every function at 480x854 and 720x1280 (crops of random
  ellipse masks, a shifted prediction) and on empty / full masks. In this
  environment the JAX package dilates through OpenCV, the port through its
  numpy decomposition; the dilation alone is also held to `cv2.dilate` at
  every disk radius `f_measure` reaches up to 1080p (1..18).
* polygon rasterisation against OpenCV itself (`cv2.fillPoly`,
  `cv2.polylines(..., True, v, 1)`), byte for byte.
* meters, DAVIS evaluation and connected components against the JAX package.
"""
import math
import os

import cv2
import numpy as np
import pytest

from rga3_tpu.evaluation import davis_eval as jdavis
from rga3_tpu.evaluation import jf_metrics as jjf
from rga3_tpu.runtime import connected_components as jcc
from rga3_tpu.utils import meters as jmeters
from rga3_tpu_torch.data import polygon
from rga3_tpu_torch.evaluation import davis_eval as tdavis
from rga3_tpu_torch.evaluation import jf_metrics as tjf
from rga3_tpu_torch.runtime import connected_components as tcc
from rga3_tpu_torch.tools.synth_trees import synth_video
from rga3_tpu_torch.utils import meters as tmeters

SHAPES = [(480, 854), (720, 1280)]


def _stacks(shape, kind, seed=0, t=2):
    """(gt, pred) bool (T, H, W) stacks of one case."""
    rng = np.random.default_rng(seed)
    _, masks = synth_video(rng, t, shape[0], shape[1], 2)
    gt = masks[0]
    pred = np.roll(masks[0] | masks[1], (5, -9), axis=(1, 2))
    if kind == "empty_pred":
        pred = np.zeros_like(gt)
    elif kind == "full_pred":
        pred = np.ones_like(gt)
    elif kind == "both_empty":
        gt = np.zeros_like(gt)
        pred = np.zeros_like(gt)
    elif kind == "crop":  # an odd-sized crop of both
        gt, pred = gt[:, 37:-11, 5:-60], pred[:, 37:-11, 5:-60]
    return gt, pred


@pytest.mark.parametrize("kind", ["random", "crop", "empty_pred", "full_pred", "both_empty"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_jf_metrics_match_jax(shape, kind):
    gt, pred = _stacks(shape, kind, seed=shape[0] + len(kind))
    np.testing.assert_array_equal(tjf.db_eval_iou(gt, pred), jjf.db_eval_iou(gt, pred))
    np.testing.assert_array_equal(tjf.db_eval_iou(gt[0], pred[0]), jjf.db_eval_iou(gt[0], pred[0]))
    void = np.zeros_like(gt)
    void[:, :40] = True
    np.testing.assert_array_equal(tjf.db_eval_iou(gt, pred, void), jjf.db_eval_iou(gt, pred, void))
    np.testing.assert_array_equal(tjf.seg2bmap(pred[0]), jjf.seg2bmap(pred[0]))
    assert tjf.f_measure(pred[0], gt[0]) == jjf.f_measure(pred[0], gt[0])
    assert tjf.f_measure(pred[0], gt[0], void[0]) == jjf.f_measure(pred[0], gt[0], void[0])
    np.testing.assert_array_equal(tjf.db_eval_boundary(gt, pred), jjf.db_eval_boundary(gt, pred))
    assert tjf.jf_score(gt, pred) == jjf.jf_score(gt, pred)
    np.testing.assert_array_equal(tjf.r2vos_accuracy(gt, pred), jjf.r2vos_accuracy(gt, pred))
    fore = gt | np.roll(gt, 30, axis=2)
    np.testing.assert_array_equal(tjf.r2vos_robustness(gt, pred, fore),
                                  jjf.r2vos_robustness(gt, pred, fore))


@pytest.mark.parametrize("n", [1, 3, 4, 7, 64])
def test_db_statistics_match_jax(n):
    v = np.random.default_rng(n).random(n)
    if n > 4:
        v[::5] = np.nan
    np.testing.assert_array_equal(tjf.db_statistics(v), jjf.db_statistics(v))


def test_f_measure_radii_cover_1080p():
    """The radii f_measure reaches for frames up to 1080p are 1..18."""
    radii = {int(np.ceil(0.008 * np.linalg.norm((h, w))))
             for h in range(1, 1081, 7) for w in range(1, 1921, 11)}
    radii.add(int(np.ceil(0.008 * np.linalg.norm((1080, 1920)))))
    assert radii == set(range(1, 19))


@pytest.mark.parametrize("radius", range(1, 19))
def test_numpy_dilation_matches_cv2(radius):
    rng = np.random.default_rng(radius)
    mask = rng.random((150, 210)) > 0.995
    mask[0, 5] = mask[-1, -1] = mask[70, 0] = True  # reaches every border
    selem = tjf.disk(radius)
    np.testing.assert_array_equal(selem, jjf._disk(radius))
    ref = cv2.dilate(mask.astype(np.uint8), selem).astype(bool)
    np.testing.assert_array_equal(tjf.binary_dilate(mask, selem), ref)


def test_binary_dilate_rejects_other_elements():
    with pytest.raises(ValueError):
        tjf.binary_dilate(np.ones((4, 4), bool), np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]]))


# ---- polygons, against OpenCV


def _ring(rng, n, cx, cy, r, sort=True):
    ang = np.sort(rng.uniform(0, 2 * math.pi, n)) if sort else rng.uniform(0, 2 * math.pi, n)
    rad = r * rng.uniform(0.3, 1.0, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)


def _polygon_cases():
    rng = np.random.default_rng(0)
    h, w = 90, 130
    cases = {
        "convex": [[10, 10], [100, 15], [120, 80], [20, 70]],
        "concave": [[10, 10], [60, 40], [110, 5], [100, 85], [15, 80]],
        "self_intersecting": [[3, 13], [1, 20], [33, 8], [29, 11], [32, 19], [90, 70]],
        "one_point": [[40, 30]],
        "two_points": [[5, 80], [120, 3]],
        "collinear": [[10, 10], [40, 40], [70, 70], [20, 20]],
        "horizontal": [[10, 30], [100, 30], [50, 30]],
        "outside_canvas": [[-40, -13], [200, 40], [60, 300], [-3, 87]],
        "grazing_edge": [[7, -4], [200, 133]],
        "huge_coordinates": [[-3000, 2000], [2900, -2500], [1000, 2700]],
        "float_ring": _ring(rng, 40, 60, 45, 50, sort=True),
        "float_star": _ring(rng, 25, 70, 40, 60, sort=False),
    }
    out = []
    for name, pts in cases.items():
        out.append(pytest.param(h, w, [np.asarray(pts, np.float64)], id=name))
    out.append(pytest.param(h, w, [np.asarray(cases["convex"], np.float64),
                                   np.asarray(cases["concave"], np.float64) + 7],
                            id="two_contours"))
    return out


@pytest.mark.parametrize("h,w,contours", _polygon_cases())
def test_polygon_matches_opencv(h, w, contours):
    pts = [c.astype(np.int32) for c in contours]
    for draw, ref in ((polygon.fill_poly, cv2.fillPoly),
                      (polygon.polylines, lambda im, p, v: cv2.polylines(im, p, True, v, 1))):
        mine = np.zeros((h, w), np.uint8)
        theirs = np.zeros((h, w), np.uint8)
        draw(mine, pts, 1)
        ref(theirs, pts, 1)
        np.testing.assert_array_equal(mine, theirs)


def test_polygon_random_and_repainted_match_opencv():
    """Random polygons on random canvases, painted 1 then 255 over each
    other as a ReasonSeg mask is, each shape outline first."""
    rng = np.random.default_rng(1)
    for trial in range(60):
        h, w = int(rng.integers(1, 160)), int(rng.integers(1, 200))
        mine = np.zeros((h, w), np.uint8)
        theirs = np.zeros((h, w), np.uint8)
        for s in range(3):
            n = int(rng.integers(1, 30))
            raw = rng.uniform(-0.3, 1.3, (n, 2)) * [w, h]
            pts = [raw.astype(np.int32)]
            value = 255 if s % 2 else 1
            polygon.polylines(mine, pts, value)
            polygon.fill_poly(mine, pts, value)
            cv2.polylines(theirs, pts, True, value, 1)
            cv2.fillPoly(theirs, pts, value)
        np.testing.assert_array_equal(mine, theirs, err_msg=f"trial {trial}")


# ---- meters, DAVIS, connected components, against the JAX package


def test_meters_match_jax():
    rng = np.random.default_rng(2)
    inters, unions = [], []
    for _ in range(5):
        gt = rng.choice([0, 1, 255], (40, 50), p=[0.6, 0.3, 0.1])
        pred = (rng.random((40, 50)) > 0.5).astype(np.int64)
        mine = tmeters.intersection_and_union(pred, gt, 2, 255)
        ref = jmeters.intersection_and_union(pred, gt, 2, 255)
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)
        inters.append(mine[0])
        unions.append(mine[1])
    i, u = np.stack(inters), np.stack(unions)
    assert tmeters.giou_ciou(i, u) == jmeters.giou_ciou(i, u)
    assert tmeters.giou_ciou(i[:, 1], u[:, 1]) == jmeters.giou_ciou(i[:, 1], u[:, 1])


def _id_maps(seed, t=6, h=40, w=56, n_obj=3):
    rng = np.random.default_rng(seed)
    _, masks = synth_video(rng, t, h, w, n_obj)
    gt = np.zeros((t, h, w), np.uint8)
    for o in range(n_obj):
        gt[masks[o]] = o + 1
    pred = np.roll(gt, 2, axis=2)
    pred[pred == 2] = 7  # a proposal id the ground truth lacks
    return gt, pred


def test_davis_metrics_match_jax():
    np.testing.assert_array_equal(tdavis.DAVIS_PALETTE, jdavis.DAVIS_PALETTE)
    rng = np.random.default_rng(3)
    objs = [rng.random((3, 20, 30)).astype(np.float32) for _ in range(3)]
    objs[1][0, :5] = objs[2][0, :5] = 0.9  # exact ties go to the lower id
    np.testing.assert_array_equal(tdavis.merge_objects_to_palette(objs),
                                  jdavis.merge_objects_to_palette(objs))
    results = {f"seq{s}": dict(zip(("gt", "pred"), _id_maps(s))) for s in range(3)}
    results["seq_none"] = {"gt": results["seq0"]["gt"], "pred": np.zeros_like(results["seq0"]["gt"])}
    assert tdavis.evaluate_davis(results) == jdavis.evaluate_davis(results)
    for task in ("unsupervised", "semi-supervised"):
        assert (tdavis.evaluate_davis_official(results, task=task)
                == jdavis.evaluate_davis_official(results, task=task))
    globs = [tdavis.evaluate_davis_official({k: v}, task="unsupervised")["global"]
             for k, v in results.items()]
    assert tdavis.average_annotators(globs) == jdavis.average_annotators(globs)


def _tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_davis_postprocess_and_annotators_match_jax(tmp_path):
    """Per-expression 0/255 masks of 2 objects x 4 annotators -> palette
    trees (byte-identical) -> the official tables averaged over annotators."""
    import json

    from PIL import Image

    src = tmp_path / "masks"
    gt_dir = tmp_path / "gt"
    videos = {}
    for v in range(2):
        gt, _ = _id_maps(10 + v, t=4, n_obj=2)
        vid = f"v{v}"
        exps = {}
        rng = np.random.default_rng(v)
        for e in range(8):  # expression index = obj * 4 + annotator
            obj = e // 4 + 1
            exps[str(e)] = {"exp": f"object {obj}"}
            d = src / vid / str(e)
            d.mkdir(parents=True)
            for i in range(4):
                m = np.roll(gt[i] == obj, int(rng.integers(-2, 3)), axis=1)
                Image.fromarray(m.astype(np.uint8) * 255).save(d / f"{i:05d}.png")
        videos[vid] = {"expressions": exps, "frames": [f"{i:05d}" for i in range(4)]}
        jdavis.save_palette_pngs(gt, [f"{i:05d}" for i in range(4)], str(gt_dir / vid))
    ann = tmp_path / "meta_expressions.json"
    ann.write_text(json.dumps({"videos": videos}))
    tdirs = tdavis.postprocess_davis(str(src), str(ann), str(tmp_path / "port"))
    jdirs = jdavis.postprocess_davis(str(src), str(ann), str(tmp_path / "jax"))
    assert [os.path.basename(d) for d in tdirs] == [os.path.basename(d) for d in jdirs]
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    for task in ("unsupervised", "semi-supervised"):
        assert (tdavis.eval_davis_annotators(str(tmp_path / "port"), str(gt_dir), task=task)
                == jdavis.eval_davis_annotators(str(tmp_path / "jax"), str(gt_dir), task=task))


@pytest.mark.parametrize("shape", [(2, 24, 31), (3, 1, 40, 33)], ids=["nhw", "n1hw"])
def test_connected_components_match_jax(shape, monkeypatch):
    # the JAX package's own numpy route (its native one would build into
    # the source tree)
    monkeypatch.setattr(jcc, "_build_lib", lambda: None)
    rng = np.random.default_rng(len(shape))
    mask = (rng.random(shape) > 0.55).astype(np.uint8)
    labels, areas = tcc.get_connected_components(mask)
    jlabels, jareas = jcc.get_connected_components(mask)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(areas, jareas)
    assert labels.dtype == areas.dtype == np.int32
    for i in range(shape[0]):
        plane = mask[i].reshape(shape[-2:])
        lab, area = tcc.cc_plain(plane)
        np.testing.assert_array_equal(lab, labels[i].reshape(shape[-2:]))
        np.testing.assert_array_equal(area, areas[i].reshape(shape[-2:]))
    scores = rng.normal(size=shape).astype(np.float32)
    for max_area in (1, 4, 50):
        np.testing.assert_array_equal(tcc.fill_holes_in_mask_scores(scores, max_area),
                                      jcc.fill_holes_in_mask_scores(scores, max_area))


def test_connected_components_build_into_build_dir():
    from rga3_tpu_torch.utils.native import BUILD_DIR

    assert os.path.dirname(tcc.library()._name) == str(BUILD_DIR)
