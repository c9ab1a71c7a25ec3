"""The port's image referring-segmentation drivers against the JAX
package's (which draws polygons with OpenCV).

* Annotations (exact): ReasonSeg labelme JSON (targets, an "ignore" shape, a
  "flag" shape, float points, a cp1252 file) through `get_mask_from_json`;
  COCO polygon lists, uncompressed and compressed RLEs through
  `segmentation_to_mask`; a tiny pickled RefCOCO index through `REFER`.
* Drivers (exact): `evaluate_image_masks`, `run_reason_seg_val`,
  `run_refer_seg_val` and `run_all_image_seg_vals` with one fake segmentor.
* The learned tiny checkpoint (runs/learning_proof_tiny/params_f16.npz)
  through the port's own `run_reason_seg_val` with the port's segmentor:
  gIoU and cIoU within 0.01 of the JAX package's driver on its segmentor.
* The CLI, `python -m rga3_tpu_torch.evaluation.eval_img`, at tiny size on
  the CPU, in a fresh process.
"""
import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from rga3_tpu.data import coco as jcoco
from rga3_tpu.data.datasets.image_seg import get_mask_from_json as jax_get_mask
from rga3_tpu.data.refer import REFER as JaxREFER
from rga3_tpu.evaluation import image_seg_eval as jise
from rga3_tpu.utils import rle as jrle
from rga3_tpu_torch.data import coco as tcoco
from rga3_tpu_torch.data.datasets.image_seg import get_mask_from_json
from rga3_tpu_torch.data.refer import REFER
from rga3_tpu_torch.evaluation import image_seg_eval as tise
from rga3_tpu_torch.tools.synth_trees import write_reason_seg_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ring(rng, n, cx, cy, r):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r * rng.uniform(0.4, 1.0, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1).tolist()


@pytest.mark.parametrize("encoding", ["utf-8", "cp1252"])
def test_get_mask_from_json_matches_jax(tmp_path, encoding):
    rng = np.random.default_rng(0)
    h, w = 70, 96
    anno = {
        "shapes": [
            {"label": "target", "points": _ring(rng, 14, 40, 30, 25)},
            {"label": "Ignore", "points": _ring(rng, 9, 50, 35, 15)},
            {"label": "flag", "points": [[0, 0], [90, 0], [90, 60]]},
            {"label": "target", "points": _ring(rng, 6, 80, 60, 30)},  # off the canvas
            {"label": "target", "points": [[3.7, 5.2]]},
        ],
        "text": ["the café chair", "another"],
        "is_sentence": True,
    }
    path = tmp_path / "a.json"
    path.write_bytes(json.dumps(anno, ensure_ascii=False).encode(encoding))
    mask, comments, is_sentence = get_mask_from_json(str(path), h, w)
    jmask, jcomments, jis_sentence = jax_get_mask(str(path), h, w)
    np.testing.assert_array_equal(mask, jmask)
    assert mask.dtype == np.uint8 and set(np.unique(mask)) == {0, 1, 255}
    assert (comments, is_sentence) == (jcomments, jis_sentence)


def test_segmentation_to_mask_matches_jax():
    rng = np.random.default_rng(1)
    h, w = 60, 80
    poly = [np.ravel(_ring(rng, 10, 30, 25, 20)).tolist(),
            np.ravel(_ring(rng, 5, 60, 40, 15)).tolist()]
    m = np.zeros((h, w), np.uint8)
    m[10:40, 20:70] = 1
    compressed = jrle.encode(m)
    uncompressed = {"size": [h, w], "counts": [int(c) for c in
                                               _counts(m.T.reshape(-1))]}
    for seg in (poly, compressed, uncompressed):
        mine = tcoco.segmentation_to_mask(seg, h, w)
        np.testing.assert_array_equal(mine, jcoco.segmentation_to_mask(seg, h, w))
        assert mine.dtype == np.uint8 and mine.any()


def _counts(flat):
    """Uncompressed COCO counts of a column-major flat mask."""
    out, val, run = [], 0, 0
    for v in flat:
        if v != val:
            out.append(run)
            val, run = v, 0
        run += 1
    return out + [run]


def _write_refcoco(base, rng, n_images=3):
    """<base>/refer_seg/refcoco/{refs(unc).p, instances.json} and the
    images under images/mscoco/images/train2014/."""
    d = base / "refer_seg" / "refcoco"
    img_dir = base / "refer_seg" / "images" / "mscoco" / "images" / "train2014"
    d.mkdir(parents=True)
    img_dir.mkdir(parents=True)
    images, anns, refs = [], [], []
    for i in range(n_images):
        h, w = 40 + 4 * i, 56
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            img_dir / f"COCO_{i}.jpg")
        images.append({"id": i, "file_name": f"COCO_{i}.jpg", "height": h, "width": w})
        m = np.zeros((h, w), np.uint8)
        m[5 + i:25, 10:40] = 1
        seg = (jrle.encode(m) if i % 2 else
               [np.ravel(_ring(rng, 8, 28, 20, 15)).tolist()])
        anns.append({"id": 100 + i, "image_id": i, "segmentation": seg, "category_id": 1})
        for k, split in enumerate(("val", "testA")):
            refs.append({"ref_id": 10 * i + k, "image_id": i, "ann_id": 100 + i,
                         "split": split, "sentences": [{"sent": f"thing {i} {k}"}]})
    with open(d / "refs(unc).p", "wb") as f:
        pickle.dump(refs, f)
    (d / "instances.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": [{"id": 1, "name": "thing"}]}))


class FakeSegmentor:
    """A mask from the image's red channel, its threshold picked by the
    expression's text."""

    def segment_video(self, frames, expression, question=None):
        x = np.stack(frames).astype(np.int64)
        return x[..., 0] > 40 + sum(map(ord, expression)) % 150


def test_refer_matches_jax(tmp_path):
    _write_refcoco(tmp_path, np.random.default_rng(2))
    data_root = str(tmp_path / "refer_seg")
    api, japi = REFER(data_root, "refcoco", "unc"), JaxREFER(data_root, "refcoco", "unc")
    for split in ("", "val", "testA", "testB"):
        assert api.getRefIds(split=split) == japi.getRefIds(split=split)
    assert api.getRefIds(image_ids=[1, 2]) == japi.getRefIds(image_ids=[1, 2])
    assert api.getRefIds(image_ids=1) == japi.getRefIds(image_ids=1)
    assert api.loadRefs([0, 11]) == japi.loadRefs([0, 11]) and api.loadRefs(10) == japi.loadRefs(10)
    assert api.loadAnns(101) == japi.loadAnns(101)
    assert (api.Imgs, api.Cats, api.imgToRefs) == (japi.Imgs, japi.Cats, japi.imgToRefs)
    for rid in api.getRefIds():
        ref = api.loadRefs(rid)[0]
        np.testing.assert_array_equal(api.get_mask(ref), japi.get_mask(ref))
    with pytest.raises(FileNotFoundError):
        REFER(data_root, "refcoco+", "unc")
    fake = FakeSegmentor()
    for split in ("val", "testA"):
        assert (tise.run_refer_seg_val(fake, str(tmp_path), "refcoco", split)
                == jise.run_refer_seg_val(fake, str(tmp_path), "refcoco", split))


def test_image_drivers_match_jax(tmp_path):
    write_reason_seg_tree(str(tmp_path), "val", seed=3, n_images=4, size=(50, 70))
    write_reason_seg_tree(str(tmp_path), "test", seed=4, n_images=2, size=(40, 60))
    _write_refcoco(tmp_path, np.random.default_rng(5))
    fake = FakeSegmentor()
    for split, n in (("val", None), ("val", 3), ("test", None)):
        assert (tise.run_reason_seg_val(fake, str(tmp_path), split, max_samples=n)
                == jise.run_reason_seg_val(fake, str(tmp_path), split, max_samples=n))
    assert (tise.run_all_image_seg_vals(fake, str(tmp_path))
            == jise.run_all_image_seg_vals(fake, str(tmp_path)))
    assert tise.VAL_SPLITS == jise.VAL_SPLITS
    with pytest.raises(FileNotFoundError):
        tise.run_reason_seg_val(fake, str(tmp_path), "train")
    rng = np.random.default_rng(6)
    gts = [rng.choice([0, 1, 255], (30, 40), p=[0.5, 0.4, 0.1]).astype(np.uint8)
           for _ in range(4)]
    preds = [rng.random((30, 40)) > 0.5 for _ in range(4)]
    preds[0][:] = False
    assert tise.evaluate_image_masks(preds, gts) == jise.evaluate_image_masks(preds, gts)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_learned_checkpoint_port_driver_matches_jax(tmp_path):
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.convert import load_params_npz, torch_state_dict_from_flax
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
    from synth_data import build_learn_root

    npz = os.path.join(ROOT, "runs", "learning_proof_tiny", "params_f16.npz")
    elt = _load_script("export_learned_tiny")
    jmodel, _, jproc = elt.build_train_tiny_model()
    build_learn_root(str(tmp_path), seed=11)  # positions unseen in training
    jscores = elt.eval_giou(jmodel, elt.load_params_npz(npz), jproc, str(tmp_path), n=6)

    proc = QwenVLProcessor.from_pretrained("dummy")
    q = tiny_config()
    q = q.replace(text=q.text.replace(lora_rank=128, lora_alpha=256.0))
    sam = tiny_sam2_config()
    cfg = UniGRConfig(qwen=q, sam2=sam,
                      seg=SegHeadConfig(out_dim=sam.d_model, seg_token_id=proc.seg_token_id))
    tm = UniGR(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(load_params_npz(npz)), strict=True)
    tscores = tise.run_reason_seg_val(UniGRSegmentor(tm, proc, num_frames_mllm=2),
                                      str(tmp_path), split="val", max_samples=6)
    assert tscores["n"] == jscores["n"] == 6
    for key in ("gIoU", "cIoU"):
        assert tscores[key] > 0.5
        assert abs(tscores[key] - jscores[key]) <= 0.01, (key, tscores, jscores)


def test_eval_img_cli_runs_on_the_cpu(tmp_path):
    write_reason_seg_tree(str(tmp_path / "data"), "val", seed=7, n_images=2, size=(56, 84))
    out = tmp_path / "scores" / "img.json"
    proc = subprocess.run(
        [sys.executable, "-m", "rga3_tpu_torch.evaluation.eval_img", "--model_dir", "dummy",
         "--model_size", "tiny", "--device", "cpu", "--data_root", str(tmp_path / "data"),
         "--datasets", "ReasonSeg:val", "--out", str(out)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    scores = json.loads(out.read_text())
    assert list(scores) == ["ReasonSeg|val"] and scores["ReasonSeg|val"]["n"] == 2
    assert 0.0 <= scores["ReasonSeg|val"]["gIoU"] <= 1.0
