"""Guards of the PyTorch port: the card by default, no CPU fallback inside a
kernel wrapper for CUDA tensors, and no import of JAX or of the JAX package."""
import ast
import os
import sys

import pytest
import torch

from rga3_tpu_torch import device as port_device
from rga3_tpu_torch.ops import _kernels
from rga3_tpu_torch.ops import attention as tatt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "rga3_tpu_torch")
# the card has no safetensors package either: the port reads the format itself
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rga3_tpu", "safetensors")
LAZY_ONLY = ("triton", "PIL", "transformers", "cv2")  # never at module top level
TOP_LEVEL_ALLOWED = {"torch", "numpy", "scipy", "einops"}


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imports(tree):
    """(module, is_top_level) for every absolute import in the tree; an
    import directly in the module body, or under a top-level if/try, runs at
    import time."""
    out = []
    top_nodes = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            top_nodes.add(id(node))
        elif isinstance(node, (ast.If, ast.Try)):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.Import, ast.ImportFrom)):
                    top_nodes.add(id(sub))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name, id(node) in top_nodes) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.module, id(node) in top_nodes))
    return out


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_nothing_of_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for name, top in _imports(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"
        if top:
            assert root not in LAZY_ONLY, f"{path} imports {name} at top level"
            assert root in TOP_LEVEL_ALLOWED or root in sys.stdlib_module_names, (
                f"{path} imports {name} at top level")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config, unfused
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
    from rga3_tpu_torch.models.qwen25vl import tiny_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError):
        port_device.resolve_device("cuda")
    cfg = UniGRConfig(qwen=tiny_config(1000), sam2=unfused(tiny_sam2_config(64)))
    with pytest.raises(RuntimeError):
        UniGR(cfg)
    assert UniGR(cfg, device="cpu").device.type == "cpu"
    # joining ranks takes NCCL on the card: without CUDA it raises, unless
    # the CPU (gloo) is asked for; it raises before it contacts anyone
    import torch.distributed as dist
    from rga3_tpu_torch.parallel import init_distributed

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed("127.0.0.1:1", num_processes=2, process_id=0)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()
    assert not dist.is_initialized()


def test_cpu_tensors_launch_nothing():
    f0, w0 = tatt.flash_attention.launches, tatt.window_attention.launches
    s0, t0 = dict(tatt.flash_attention.shapes), dict(tatt.window_attention.shapes)
    q = torch.randn(1, 64, 2, 16)
    tatt.flash_attention(q, q, q, causal=True)
    tatt.window_attention(q, q, q, 16)
    assert (tatt.flash_attention.launches, tatt.window_attention.launches) == (f0, w0)
    assert (tatt.flash_attention.shapes, tatt.window_attention.shapes) == (s0, t0)
    assert _kernels._lib is None  # nothing was built or loaded


def test_reset_launches_zeroes_counts_and_calls():
    tatt.flash_attention.launches, tatt.window_attention.launches = 3, 4
    tatt.flash_attention.shapes[("k",)] = [3, None]
    tatt.window_attention.shapes[("k",)] = [4, None]
    tatt.reset_launches()
    assert (tatt.flash_attention.launches, tatt.window_attention.launches) == (0, 0)
    assert tatt.flash_attention.shapes == {} and tatt.window_attention.shapes == {}


def test_kernel_sources_are_listed_and_hashed():
    assert {"flash_attention.cu", "flash_attention_bwd.cu", "window_attention.cu", "gemm.cu",
            "row_ops.cu", "int4_matmul.cu"} <= set(_kernels.SOURCES)
    for name in _kernels.SOURCES + _kernels.HEADERS:
        assert os.path.exists(os.path.join(_kernels.CSRC, name))
    assert len(_kernels._digest()) == 16


def _int4_call():
    from rga3_tpu_torch.ops import quant as tq

    q, sc = tq.quantize_int4(torch.randn(128, 48))
    tq.int4_matmul(torch.randn(3, 128), q, sc)
    return tq.int4_matmul


def _flash_bwd_call():
    q = torch.randn(1, 64, 2, 16, requires_grad=True)
    tatt.flash_attention(q, q, q, causal=True).sum().backward()
    o, lse = tatt.mha_reference(q.detach(), q.detach(), q.detach(), return_lse=True)
    tatt.flash_attention_bwd(q.detach(), q.detach(), q.detach(), o, lse, torch.ones_like(o))
    return tatt.flash_attention_bwd


def _wrapper(name):
    from rga3_tpu_torch.ops import quant as tq

    return {"int4_matmul": tq.int4_matmul, "flash_attention_bwd": tatt.flash_attention_bwd}[name]


@pytest.mark.parametrize("call", [_int4_call, _flash_bwd_call],
                         ids=["int4_matmul", "flash_attention_bwd"])
def test_cpu_tensors_launch_nothing_in_later_wrappers(call):
    name = {_int4_call: "int4_matmul", _flash_bwd_call: "flash_attention_bwd"}[call]
    n0, s0 = _wrapper(name).launches, dict(_wrapper(name).shapes)
    wrapper = call()
    assert (wrapper.launches, wrapper.shapes) == (n0, s0)
    assert _kernels._lib is None


@pytest.mark.parametrize("name", ["int4_matmul", "flash_attention_bwd"])
def test_reset_launches_covers_later_wrappers(name):
    wrapper = _wrapper(name)
    wrapper.launches, wrapper.shapes[("k",)] = 5, [5, None]
    tatt.reset_launches()
    assert wrapper.launches == 0 and wrapper.shapes == {}


def test_quantized_products_raise_under_grad():
    """No quantized product has a backward: under grad each raises rather
    than cut the gradient; under no_grad each computes."""
    from rga3_tpu_torch.models.qwen25vl.language import QuantLinear
    from rga3_tpu_torch.ops import quant as tq

    x = torch.randn(3, 128, requires_grad=True)
    q4, s4 = tq.quantize_int4(torch.randn(128, 48))
    q8, s8 = tq.quantize_int8(torch.randn(128, 48))
    calls = [lambda: tq.int4_matmul(x, q4, s4), lambda: tq.int8_matmul(x, q8, s8),
             lambda: tq.int8_w8a8_matmul(x, q8, s8),
             lambda: QuantLinear.from_linear(torch.nn.Linear(128, 48), 8)(x)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            assert call().shape == (3, 48)


def test_wrappers_are_differentiable_on_the_cpu():
    """On the CPU the wrappers compute their plain versions, which autograd
    runs through: a gradient reaches every input."""
    from rga3_tpu_torch.ops import fused_block as fb

    q = torch.randn(1, 64, 2, 16, requires_grad=True)
    k = torch.randn(1, 64, 2, 16, requires_grad=True)
    (tatt.flash_attention(q, k, k, causal=True).sum()
     + tatt.window_attention(q, k, k, 16).sum()).backward()
    assert q.grad.abs().sum() > 0 and k.grad.abs().sum() > 0
    x = torch.randn(1, 16, 8, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)
    fb.gemm(x, w, torch.zeros(8), epilogue="gelu_tanh").sum().backward()
    assert x.grad.abs().sum() > 0 and w.grad.abs().sum() > 0


def test_qwen_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRChat
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL
    from rga3_tpu_torch.ops.quant import quantize_for_serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Qwen25VL(tiny_config(1000))
    model = quantize_for_serving(Qwen25VL(tiny_config(1000), device="cpu"), "int4")
    assert model.lm.lm_head.kernel_q4.device.type == "cpu"
    chat = UniGRChat(model, QwenVLProcessor.from_pretrained("dummy"), max_new_tokens=2)
    assert chat.model.device.type == "cpu"


@pytest.mark.parametrize("cli", ["eval_vos", "eval_img"])
def test_eval_clis_need_cuda_unless_cpu_is_asked(cli, monkeypatch, tmp_path):
    """The benchmark CLIs build their model on the card: without CUDA they
    raise unless `--device cpu` is given."""
    import importlib

    mod = importlib.import_module(f"rga3_tpu_torch.evaluation.{cli}")
    args = {"eval_vos": ["--stage", "infer", "--out_dir", str(tmp_path / "out")],
            "eval_img": ["--datasets", "ReasonSeg:val", "--out", str(tmp_path / "s.json")]}[cli]
    args += ["--data_root", str(tmp_path), "--model_dir", "dummy", "--model_size", "tiny"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(args)
    assert not (tmp_path / "out").exists() and not (tmp_path / "s.json").exists()
    from rga3_tpu_torch.models.unigr.build import build_model

    model, _ = build_model(mod.parse_args(args + ["--device", "cpu"]))
    assert model.device.type == "cpu"


def test_legacy_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    """The legacy composite (SAM-v1) takes the card by default, as UniGR does:
    without CUDA it raises unless the CPU is asked for."""
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.sam1 import tiny_sam1_config
    from rga3_tpu_torch.models.unigr.legacy import UniGRLegacy, UniGRLegacyConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = UniGRLegacyConfig(qwen=tiny_config(1000), sam1=tiny_sam1_config(64))
    with pytest.raises(RuntimeError):
        UniGRLegacy(cfg)
    model = UniGRLegacy(cfg, device="cpu")
    assert model.device.type == "cpu" and model.qwen.lm.embed_tokens.weight.device.type == "cpu"
