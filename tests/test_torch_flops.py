"""The port's analytic FLOP counters and profiling helpers
(`rga3_tpu_torch.utils.flops`, `utils.profiling`) against the JAX
package's, on the CPU.

* Every `*_flops` counter (and the primitives and the memory-bank token
  count) equals JAX's exactly on the same shapes, at the tiny config with
  the tiny SAM2 and at Qwen2.5-VL-3B / 7B with SAM2 Hiera-L, with the SAM2
  backbone frozen and trained.
* `mfu` equals JAX's on fixed inputs at the same peak, and `StepTimer` its
  summary and rolling window on the same clock readings.
* `trace(None)` is a no-op and `trace(dir)` writes a Chrome trace holding
  the `annotate`d region; `peak_flops_per_chip` is the H100's 989 TFLOP/s
  and raises for any other card and without a card; no TPU peak appears in
  the port.
"""
import json
import os

import pytest
import torch

from rga3_tpu.config import SegHeadConfig as JaxSegHead
from rga3_tpu.models.qwen25vl import config as jqc
from rga3_tpu.models.sam2 import config as jsc
from rga3_tpu.models.unigr import UniGRConfig as JaxUniGRConfig
from rga3_tpu.utils import flops as jf
from rga3_tpu.utils import profiling as jp
from rga3_tpu_torch.config import SegHeadConfig
from rga3_tpu_torch.models.qwen25vl import config as tqc
from rga3_tpu_torch.models.sam2 import config as tsc
from rga3_tpu_torch.models.unigr import UniGRConfig
from rga3_tpu_torch.utils import flops as tf
from rga3_tpu_torch.utils import profiling as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {
    "tiny": ("tiny_config", "tiny_sam2_config"),
    "3b+hiera_l": ("QWEN25_VL_3B", "SAM2_HIERA_L"),
    "7b+hiera_l": ("QWEN25_VL_7B", "SAM2_HIERA_L"),
}


def configs(size, qc, sc, head, unigr):
    qname, sname = SIZES[size]
    q, s = getattr(qc, qname), getattr(sc, sname)
    q = q() if callable(q) else q
    s = s() if callable(s) else s
    return q, s, [unigr(qwen=q, sam2=s, seg=head(out_dim=s.d_model, freeze_sam_backbone=f))
                  for f in (True, False)]


def counts(f, q, s, unigrs):
    """Every counter of the flops module `f` on these configs."""
    lk = f.sam2_memory_bank_tokens(s)
    out = {
        "dense": f.dense(3, 5, 7), "attention": f.attention(9, 11, 13),
        "conv2d": f.conv2d(5, 6, 3, 3, 4, 8),
        "hiera": f.hiera_flops(s.hiera, s.image_size),
        "hiera_512": f.hiera_flops(s.hiera, s.image_size // 2),
        "neck": f.sam2_neck_flops(s, s.image_size),
        "heads": f.sam2_heads_flops(s, s.image_size),
        "memory_attention": f.sam2_memory_attention_flops(s, lk),
        "memory_encoder": f.sam2_memory_encoder_flops(s, s.image_size),
        "bank_tokens": lk,
        "track_step": f.sam2_track_step_flops(s),
        "decode_frame": f.sam2_decode_frame_flops(s),
        "lm_prefill": f.qwen_lm_flops(q.text, 1280),
        "lm_decode": f.qwen_lm_flops(q.text, 1, kv_len=1281),
        "lm_no_head": f.qwen_lm_flops(q.text, 512, lm_head=False),
        "vision": f.qwen_vision_flops(q.vision, 4784),
    }
    for i, u in enumerate(unigrs):
        out[f"train_step_{i}"] = f.unigr_train_step_flops(u, 2, 1337, 4, 9600)
        out[f"train_step_text_{i}"] = f.unigr_train_step_flops(u, 1, 512, 2)
    return out


@pytest.mark.parametrize("size", list(SIZES))
def test_flops_equal_jax(size):
    got = counts(tf, *configs(size, tqc, tsc, SegHeadConfig, UniGRConfig))
    want = counts(jf, *configs(size, jqc, jsc, JaxSegHead, JaxUniGRConfig))
    assert got == want
    assert all(v > 0 for v in got.values())


def test_mfu_and_step_timer_equal_jax(monkeypatch):
    peak = jp.peak_flops_per_chip()  # JAX's, on this CPU
    for flops, sec in ((1.5e15, 2.25), (7e12, 0.013), (0.0, 1.0), (1e12, 0.0)):
        assert tp.mfu(flops, sec, peak=peak) == jp.mfu(flops, sec)
    readings = [0.0, 0.5, 1.0, 1.75, 2.0, 4.5, 5.0, 5.1, 6.0, 9.0]
    timers = []
    for mod in (tp, jp):
        clock = iter(readings)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        t = mod.StepTimer(window=3)
        assert t.summary() == {}
        for _ in range(len(readings) // 2):
            t.start()
            t.stop()
        timers.append(t)
    assert timers[0].times == timers[1].times and len(timers[0].times) == 3
    assert timers[0].summary() == timers[1].summary()


def test_trace_and_annotate(tmp_path):
    with tp.trace(None):
        pass
    with tp.trace(str(tmp_path / "none")):
        pass
    with tp.trace(str(tmp_path / "t"), "probe"):
        with tp.annotate("matmul region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].startswith("probe.") and files[0].endswith(
        ".pt.trace.json")
    with open(tmp_path / "t" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"probe", "matmul region"} <= names


def test_peak_is_the_h100s_and_nothing_else():
    assert tp.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5 lite", "cpu"):
        with pytest.raises(ValueError):
            tp.peak_flops_per_chip(name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tp.peak_flops_per_chip()
        with pytest.raises(RuntimeError):
            tp.mfu(1e12, 1.0)
        with pytest.raises(RuntimeError):
            tp.device_timeit(lambda: None)
    # no TPU peak (the JAX package's table) anywhere in the port
    tpu = [form.format(v) for v in jp._PEAK_BF16_FLOPS.values()
           for form in ("{:.0f}", "{!r}")]
    tpu += [f"{v / 1e12:g}e12" for v in jp._PEAK_BF16_FLOPS.values()]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "rga3_tpu_torch")):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(dirpath, n)) as f:
                    src = f.read()
                assert not any(v in src for v in tpu), n
