"""Int8 / int4 weight quantization: the hand-written int4 dequant-matmul
kernel, its plain PyTorch version, the int8 products and the quantizers.
Counterpart of `rga3_tpu/ops/quant.py`, in the JAX package's layouts:

  * int8: `kernel_q` (in, out) int8 and `scale` (out,) f32, symmetric per
    output channel (amax / 127);
  * int4: `kernel_q4` (in/2, out) int8 holding two nibbles a byte, row j in
    the low nibble and row j + in/2 in the high one (contiguous halves,
    both sign-extended, values -7..7), and `scale_g` (in/32, out) f32: one
    scale per group of 32 input rows when in % 64 == 0 (rows 0..half/32-1
    for the low half, the rest for the high half), otherwise one row of
    per-channel scales shared by both halves.

`int4_matmul` launches `csrc/int4_matmul.cu` for a CUDA tensor (the port
of the Pallas `_int4_kernel`) and computes `int4_matmul_reference` for a
CPU tensor; it never falls back. It counts its launches in
`int4_matmul.launches` and records its calls in `int4_matmul.shapes`
(`ops.attention.reset_launches()` clears both). The plain version rounds
as the Pallas body does: per group, two f32 partial dots of x against the
unpacked nibbles, each multiplied by its group's scale and added to an f32
sum that is rounded to x's dtype once.

The quantized products are for serving: none of them has a backward (the
JAX package's int4 pallas_call has no VJP either), and each raises when
grad is on and its input requires it, rather than pass on a cut gradient.

The int8 products are plain PyTorch, as the JAX package leaves them to
XLA: weight-only `(x @ q) * scale` in x's dtype, and W8A8 (per-token
absmax / 127 activations, round half to even, an s8 x s8 -> s32 product by
`torch._int_mm`, dequantized in f32).

`quantize_qwen_params` / `quantize_for_serving` act on the port's modules
in place, layer by layer on the module's device: each targeted
`nn.Linear` becomes a `QuantLinear` and its float weight is freed before
the next one is quantized.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import _kernels
from .attention import _record, register

INT4_GROUP = 32  # input rows per scale group


def int4_group(in_dim: int) -> int:
    """Scale-group size: 32 when both packed halves split into whole groups
    (in % 64 == 0), otherwise the whole input dim (per-channel)."""
    return INT4_GROUP if in_dim % (2 * INT4_GROUP) == 0 else in_dim


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., in, out) float kernel -> int8 kernel + (..., out) f32 scale,
    both contiguous (whatever the kernel's strides, e.g. an nn.Linear
    weight's transpose)."""
    wf = w.float()
    amax = wf.abs().amax(-2)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    return q.contiguous(), scale.contiguous()


def quantize_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., in, out) float kernel -> packed (..., in/2, out) int8 +
    (..., in/group, out) f32 scales, both contiguous. The rescale runs in the
    weight's own dtype, as in the JAX package."""
    *lead, in_dim, out = w.shape
    if in_dim % 2:
        raise ValueError(f"quantize_int4: odd input dim {in_dim}")
    g = int4_group(in_dim)
    wf = w.reshape(*lead, in_dim // g, g, out)
    amax = wf.abs().amax(-2).float()
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[..., None, :].to(w.dtype)), -7, 7)
    q = q.to(torch.int8).view(torch.uint8).reshape(*lead, in_dim, out)
    half = in_dim // 2
    packed = (q[..., :half, :] & 15) | ((q[..., half:, :] & 15) << 4)
    return packed.view(torch.int8).contiguous(), scale.contiguous()


def int4_unpack_halves(kernel_q4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed (..., in/2, out) -> (low, high) sign-extended nibbles, int32."""
    p = kernel_q4.to(torch.int32)
    return (p << 28) >> 28, p >> 4


def dequantize_int4(kernel_q4: torch.Tensor, scale_g: torch.Tensor) -> torch.Tensor:
    """Packed int4 + scales -> the (..., in, out) f32 kernel."""
    low, high = int4_unpack_halves(kernel_q4)
    *lead, half, out = low.shape
    in_dim = 2 * half
    g = int4_group(in_dim)
    w = torch.cat([low, high], dim=-2).float().reshape(*lead, in_dim // g, g, out)
    return (w * scale_g.float()[..., None, :]).reshape(*lead, in_dim, out)


def int4_matmul_reference(x: torch.Tensor, kernel_q4: torch.Tensor,
                          scale_g: torch.Tensor) -> torch.Tensor:
    """Plain version of the Pallas `_int4_kernel`: x (..., in) @ dequant ->
    (..., out) in x's dtype. f32 partial dots per scale group (the scales
    hit the partial dots, not the weights), one rounding at the end."""
    half, out = kernel_q4.shape
    lead = x.shape[:-1]
    xf = x.reshape(-1, 2 * half).float()
    m = xf.shape[0]
    low, high = int4_unpack_halves(kernel_q4)
    low, high, s = low.float(), high.float(), scale_g.float()
    g = int4_group(2 * half)
    if g == 2 * half:  # per-channel: one scale row for both halves
        y = (xf[:, :half] @ low + xf[:, half:] @ high) * s[0]
        return y.to(x.dtype).reshape(*lead, out)
    gh = half // g
    y = torch.zeros(m, out, dtype=torch.float32, device=x.device)
    # groups in chunks, so the (M, groups, out) partials stay under ~1 GiB
    step = max(1, (1 << 28) // max(1, m * out))
    for g0 in range(0, gh, step):
        g1 = min(gh, g0 + step)
        rows = slice(g0 * g, g1 * g)
        p_lo = torch.einsum("mgk,gko->mgo", xf[:, rows].reshape(m, g1 - g0, g),
                            low[rows].reshape(g1 - g0, g, out))
        p_hi = torch.einsum("mgk,gko->mgo", xf[:, half:][:, rows].reshape(m, g1 - g0, g),
                            high[rows].reshape(g1 - g0, g, out))
        y += (p_lo * s[g0:g1] + p_hi * s[gh + g0:gh + g1]).sum(1)
    return y.to(x.dtype).reshape(*lead, out)


# csrc/int4_matmul.cu's TMA tile at decode (M <= 4): a work unit is a range
# of stages of 64 packed rows x 128 output columns, or 144 where 128-column
# units would overflow one an SM and 144-column ones do not
INT4_STAGE_ROWS = 64
# rows of x a decode launch takes; from M = 5 to 2 * INT4_DECODE_ROWS the
# wrapper launches the decode tile on row chunks of at most this many, so
# that a row's result does not depend on the rows beside it (M = 1..8)
INT4_DECODE_ROWS = 4


def int4_decode_cols(out: int, sms: int = 132) -> int:
    """Output columns of a decode unit, as the C entry point picks them."""
    return 144 if -(-out // 128) > sms >= -(-out // 144) else 128


@functools.lru_cache(maxsize=None)
def int4_splits(m: int, in_dim: int, out: int, sms: int = 132) -> int:
    """Splits of the groups of a decode launch (M <= INT4_DECODE_ROWS) over
    units whose f32 partials the kernel adds in a fixed order: the fewest that give the
    card 0.8 units an SM, each unit at least two stages (a one-stage unit
    pays a partial's write and sum for 12 KB of loads), or else the most
    such. Decode calls are a few µs, so one unit an SM beats two short ones
    and a second round; measured by `tools/bench_int4.py --sweep`. 1 for a
    prefill and for shapes that take the generic tile (in or out not a
    multiple of 16)."""
    if m > INT4_DECODE_ROWS or in_dim % 16 or out % 16:
        return 1
    stages = -(-in_dim // 2 // INT4_STAGE_ROWS)
    tiles = -(-out // int4_decode_cols(out, sms))
    splits = sorted({-(-stages // per) for per in range(min(2, stages), stages + 1)})
    return next((s for s in splits if tiles * s >= 0.8 * sms), splits[-1])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _int4_workspace_words(m: int, out: int, splits: int) -> int:
    return _kernels.library().rga3_int4_matmul_workspace_words(m, out, splits)


_workspaces: Dict[int, torch.Tensor] = {}


def _int4_workspace(device: torch.device, words: int) -> torch.Tensor:
    """The split calls' workspace on `device`: the kernel's arrival counters
    (zeroed here once; each call leaves them zero) and room for its f32
    partials, grown when a call needs more. The port issues its products on
    one stream, so calls never overlap in time."""
    ws = _workspaces.get(device.index)
    if ws is None or ws.numel() < words:
        ws = torch.zeros(max(words, 1 << 20), dtype=torch.int32, device=device)
        _workspaces[device.index] = ws
    return ws


def refuse_grad(name: str, x: torch.Tensor) -> None:
    """Raise if grad is on and x requires it: a quantized product has no
    backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{name}: quantized weights are for serving and have no backward; "
            "call it under torch.no_grad() or train the float model")


def int4_matmul(x: torch.Tensor, kernel_q4: torch.Tensor,
                scale_g: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ dequant(packed (in/2, out), scales (groups, out)).

    On a CUDA tensor it launches the hand-written kernel: x bf16 and
    contiguous, the packed weight int8 and the scales f32, both contiguous
    and 16-byte aligned, `in` even, any M and `out`. Up to M = 8 every row
    takes the decode tile, rows 1-4 in one launch and 5-8 in a second: the
    tile computes each row alone, in the same order at any M <= 4, so a row
    rounds as it does at M = 1 (speculative decoding's verify forward then
    chooses the tokens one-token steps would; the prefill tile, from M = 9,
    adds the groups in another order). On a CPU tensor it computes
    `int4_matmul_reference`."""
    refuse_grad("int4_matmul", x)
    half, out = kernel_q4.shape
    in_dim = x.shape[-1]
    if in_dim != 2 * half or scale_g.shape != (in_dim // int4_group(in_dim), out):
        raise ValueError(
            f"int4_matmul: x (..., {in_dim}) does not match packed {tuple(kernel_q4.shape)} "
            f"and scales {tuple(scale_g.shape)}")
    if x.device.type == "cpu":
        return int4_matmul_reference(x, kernel_q4, scale_g)
    if not x.is_contiguous():
        raise ValueError("int4_matmul: x, the packed weight and the scales must be contiguous")
    lead = x.shape[:-1]
    m = x.numel() // in_dim
    x2 = x.view(m, in_dim)
    if INT4_DECODE_ROWS < m <= 2 * INT4_DECODE_ROWS:
        y = torch.cat([int4_matmul_launch(x2[:INT4_DECODE_ROWS], kernel_q4, scale_g),
                       int4_matmul_launch(x2[INT4_DECODE_ROWS:], kernel_q4, scale_g)])
    else:
        y = int4_matmul_launch(x2, kernel_q4, scale_g)
    return y.reshape(*lead, out)


def int4_matmul_launch(x: torch.Tensor, kernel_q4: torch.Tensor,
                       scale_g: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on x (M, in), CUDA tensors only: the decode
    tile up to M = 4, the prefill tile above (`int4_matmul` chunks M = 5..8
    into decode launches; this takes them whole)."""
    out = kernel_q4.shape[1]
    m, in_dim = x.shape
    if x.device.type != "cuda":
        raise RuntimeError(f"int4_matmul: no kernel for {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int4_matmul: the CUDA kernel takes bf16 x, got {x.dtype}")
    if kernel_q4.dtype != torch.int8 or scale_g.dtype != torch.float32:
        raise TypeError("int4_matmul: the packed weight must be int8 and the scales f32")
    if not (x.is_contiguous() and kernel_q4.is_contiguous() and scale_g.is_contiguous()):
        raise ValueError("int4_matmul: x, the packed weight and the scales must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, kernel_q4, scale_g)):
        raise ValueError("int4_matmul: inputs must be 16-byte aligned")
    return _int4_launch(x, kernel_q4, scale_g)


def _int4_launch(x, kernel_q4, scale_g):
    out = kernel_q4.shape[1]
    m, in_dim = x.shape
    device, stream = _kernels.launch_on("int4_matmul", x, kernel_q4, scale_g)
    y = torch.empty((m, out), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    splits = int4_splits(m, in_dim, out, _sm_count(device))
    lib = _kernels.library()
    # the split workspace of the tensors' own device
    ws = (_int4_workspace(x.device, _int4_workspace_words(m, out, splits))
          if splits > 1 else None)
    err = lib.rga3_int4_matmul_bf16(
        device, x.data_ptr(), kernel_q4.data_ptr(), scale_g.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), m, in_dim, out,
        int4_group(in_dim), splits, stream,
    )
    _kernels.check(err, "int4_matmul")
    _record(int4_matmul, (m, in_dim, out))
    return y


register(int4_matmul)


def int8_matmul(x: torch.Tensor, kernel_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Weight-only int8: x (..., in) @ dequant(kernel_q (in, out)) in x's dtype."""
    refuse_grad("int8_matmul", x)
    return (x @ kernel_q.to(x.dtype)) * scale.to(x.dtype)


def int8_w8a8_matmul(x: torch.Tensor, kernel_q: torch.Tensor,
                     scale: torch.Tensor, amax: torch.Tensor = None) -> torch.Tensor:
    """W8A8: per-token absmax / 127 activation quantization, an s8 x s8 ->
    s32 product, dequantized by token scale x channel scale in f32.
    `torch._int_mm` needs M > 16 and K, N multiples of 8: the operands are
    zero-padded to those, which changes no sum. `amax` (M, 1) f32, when
    given, is each token's absmax (over the whole K of a row-parallel
    layer, of which x holds a block)."""
    refuse_grad("int8_w8a8_matmul", x)
    lead, k = x.shape[:-1], x.shape[-1]
    n = kernel_q.shape[1]
    xf = x.reshape(-1, k).float()
    if amax is None:
        amax = xf.abs().amax(-1, keepdim=True)
    xs = (amax / 127.0).clamp_min(1e-8)
    xq = torch.round(xf / xs).to(torch.int8)
    m = xq.shape[0]
    kp, np_ = k + (-k) % 8, n + (-n) % 8
    a = F.pad(xq, (0, kp - k, 0, max(m, 17) - m))
    b = F.pad(kernel_q, (0, np_ - n, 0, kp - k))
    y = torch._int_mm(a, b)[:m, :n]
    return (y.float() * xs * scale.float()).to(x.dtype).reshape(*lead, n)


# Linear submodules of the LM that are quantized (q/k/v/o, MLP, lm_head);
# embeddings and the LoRA adapters stay float.
QWEN_QUANT_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj", "lm_head",
)
# vision-tower blocks (QwenVisionConfig.quant_int8); the patch embedding and
# the merger stay float
VISION_QUANT_KEYS = ("attn_qkv", "attn_proj", "mlp_gate", "mlp_up", "mlp_down")


def set_config_flags(model: nn.Module, text: Dict[str, bool], vision: Dict[str, bool]) -> None:
    """Replace fields of every Qwen config a submodule of `model` holds
    (`text` on the LM's, `vision` on the tower's): e.g. `quant_w8a8` or
    `kv_cache_int8` before `quantize_for_serving`."""
    from ..models.qwen25vl.config import Qwen25VLConfig, QwenTextConfig, QwenVisionConfig

    for mod in model.modules():
        cfg = getattr(mod, "cfg", None)
        if isinstance(cfg, QwenTextConfig):
            mod.cfg = cfg.replace(**text)
        elif isinstance(cfg, QwenVisionConfig):
            mod.cfg = cfg.replace(**vision)
        elif isinstance(cfg, Qwen25VLConfig):
            mod.cfg = cfg.replace(text=cfg.text.replace(**text),
                                  vision=cfg.vision.replace(**vision))


@torch.no_grad()
def quantize_qwen_params(model: nn.Module, keys: Sequence[str] = QWEN_QUANT_KEYS,
                         include_vision: bool = False, bits: int = 8) -> nn.Module:
    """Replace, in place, each `nn.Linear` of a Qwen2.5-VL module (or its
    LM) named in `keys`, and the vision blocks' with `include_vision`, by a
    `QuantLinear` of `bits` (8 or 4), one at a time on its own device.
    Biases stay. W8A8 follows the configs' `quant_w8a8` (never on
    `lm_head`, as in the JAX package). The configs' flags are set to match:
    `quant_int8` / `quant_int4` on the LM, `quant_int8` on the vision
    tower."""
    from ..models.qwen25vl import language
    from ..models.qwen25vl.config import QwenTextConfig, QwenVisionConfig

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    cfgs = {type(m.cfg): m.cfg for m in model.modules()
            if isinstance(getattr(m, "cfg", None), (QwenTextConfig, QwenVisionConfig))}
    targets = [(parent, name) for parent in model.modules()
               if type(parent).__module__.startswith(language.__package__)
               for name, child in parent.named_children()
               if isinstance(child, nn.Linear)
               and (name in keys or include_vision and name in VISION_QUANT_KEYS)]
    text = vision = False
    for parent, name in targets:
        is_vision = name in VISION_QUANT_KEYS
        cfg = cfgs.get(QwenVisionConfig if is_vision else QwenTextConfig)
        w8a8 = 32 if (getattr(cfg, "quant_w8a8", False) and name != "lm_head") else 0
        b = 8 if is_vision else bits
        setattr(parent, name, language.QuantLinear.from_linear(
            getattr(parent, name), b, w8a8_min_seq=w8a8))
        vision |= is_vision
        text |= not is_vision
    flag = {8: "quant_int8", 4: "quant_int4"}[bits]
    set_config_flags(model, {flag: True} if text else {},
                   {"quant_int8": True} if vision else {})
    return model


def quantize_for_serving(model: nn.Module, mode: str) -> nn.Module:
    """The serving transform of a Qwen2.5-VL module, in place: "int8" gives
    an int8 LM and int8 vision tower, "int4" an int4 LM and an int8 vision
    tower."""
    if mode == "int8":
        return quantize_qwen_params(model, include_vision=True)
    if mode != "int4":
        raise ValueError(f"mode must be 'int8' or 'int4', got {mode!r}")
    quantize_qwen_params(model, keys=(), include_vision=True, bits=8)
    return quantize_qwen_params(model, keys=QWEN_QUANT_KEYS, bits=4)


def dequantize_qwen_params(tree: Dict) -> Dict:
    """Inverse transform on a nested numpy tree (the JAX package's layout):
    {kernel_q, scale} and {kernel_q4, scale_g} -> {kernel} f32."""
    if not isinstance(tree, dict):
        return tree
    if "kernel_q" in tree and "scale" in tree:
        out = {k: v for k, v in tree.items() if k not in ("kernel_q", "scale")}
        out["kernel"] = (np.asarray(tree["kernel_q"], np.float32)
                         * np.asarray(tree["scale"], np.float32)[..., None, :])
        return out
    if "kernel_q4" in tree and "scale_g" in tree:
        out = {k: v for k, v in tree.items() if k not in ("kernel_q4", "scale_g")}
        out["kernel"] = dequantize_int4(
            torch.from_numpy(np.asarray(tree["kernel_q4"], np.int8)),
            torch.from_numpy(np.asarray(tree["scale_g"], np.float32))).numpy()
        return out
    return {k: dequantize_qwen_params(v) for k, v in tree.items()}


# the pre-quantized checkpoint directory, in the JAX package's format: one
# safetensors file whose keys are the flax parameter paths joined by "/"
# (under "params/"; `kernel_q4` / `scale_g` and `kernel_q` / `scale` leaves
# for the quantized layers, f32 for the float ones) and a meta json with at
# least `mode` ("int4" or "int8"), so a directory written by either package
# loads in the other
QUANT_CKPT_FILE = "rga3_quant.safetensors"
QUANT_CKPT_META = "rga3_quant.json"


def save_quantized(model: nn.Module, out_dir: str, meta: Dict) -> str:
    """Write an (already quantized) port module, e.g. a `UniGR` whose
    `qwen` went through `quantize_for_serving`, as a pre-quantized
    checkpoint directory."""
    import json
    import os

    from ..convert import _flatten, flax_tree_from_torch
    from ..utils import safetensors_io

    flat = {"/".join(("params",) + path): arr
            for path, arr in _flatten(flax_tree_from_torch(model)).items()}
    os.makedirs(out_dir, exist_ok=True)
    safetensors_io.save_file(flat, os.path.join(out_dir, QUANT_CKPT_FILE))
    with open(os.path.join(out_dir, QUANT_CKPT_META), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def is_quantized_dir(model_dir: str) -> bool:
    import os

    return os.path.exists(os.path.join(model_dir, QUANT_CKPT_FILE))


def load_quantized(model_dir: str, dtype: torch.dtype = torch.float32
                   ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Inverse of `save_quantized`: (the port's state dict, float leaves in
    `dtype` and the quantized ones as stored; the meta dict)."""
    import json
    import os

    from ..convert import torch_state_dict_from_flax
    from ..utils import safetensors_io

    tree: Dict = {}
    path = os.path.join(model_dir, QUANT_CKPT_FILE)
    for key, t in safetensors_io.iter_file(path):
        arr = (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    with open(os.path.join(model_dir, QUANT_CKPT_META)) as f:
        meta = json.load(f)
    return torch_state_dict_from_flax(tree, dtype), meta
