"""Qwen2.5 decoder language model, counterpart of
`rga3_tpu/models/qwen25vl/language.py`: causal flash attention with optional
segment ids, M-RoPE, the LoRA adapters on q_proj / v_proj, the KV cache
(bf16, or int8 with per-vector scales) and the int8 / int4 quantized
projections (`QuantLinear`). Under `scan_layers` the layers stay modules of
their own; only the JAX package's parameter tree stacks them (`convert`).

Over the mesh's tensor axis (`parallel.tensor.setup`, through
`parallel.fsdp.shard_model`) each projection holds and computes its block:
q / k / v / gate / up column-parallel over whole heads, o / down
row-parallel with the sum over the group after them, `embed_tokens` and
`lm_head` (or the tied head) vocab-parallel; the KV cache holds the rank's
KV heads. The modules carry the JAX package's logical names
(`logical_axes`, the flax kernel's axes) for the sharding rule.

The KV cache (`make_kv_cache`) is a dict of preallocated planes that a
forward pass writes in place at `idx` and then advances: the port updates
it where the JAX package returns a new pytree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ...ops import rope as rope_ops
from ...ops.attention import flash_attention, mha_reference
from ...ops.precision import exact_f32
from ...ops.quant import (
    INT4_DECODE_ROWS, int4_group, int4_matmul, int8_matmul, int8_w8a8_matmul, quantize_int4,
    quantize_int8,
)
from ...parallel import fsdp
from ...parallel.distributed import (
    all_gather_along, all_reduce, copy_to_tensor, reduce_from_tensor,
)
from ...parallel.tensor import vocab_parallel_embedding
from .config import QwenTextConfig


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, **factory):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **factory))

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


# per-layer cache planes; the scale planes exist only for int8 caches
CACHE_PLANES = ("k", "v", "k_scale", "v_scale")
# cached forwards of up to this many tokens attend one query at a time
# (`Attention._cached_attention`), as the int4 products take up to this many
# rows in decode launches (`ops.quant.int4_matmul`)
ROW_EXACT_TOKENS = 2 * INT4_DECODE_ROWS


def _quantize_kv_i8(t: torch.Tensor):
    """(B, L, Hkv, hd) -> (int8 values, f32 per-vector scale over hd)."""
    tf = t.float()
    s = (tf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(tf / s).to(torch.int8), s[..., 0]


def make_kv_cache(cfg: QwenTextConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None,
                  kv_heads: Optional[int] = None) -> Dict[str, Any]:
    """KV cache for all layers: `k` / `v` (layers, B, max_len, Hkv, hd) in
    `dtype`, or int8 plus f32 `k_scale` / `v_scale` (layers, B, max_len, Hkv)
    with `cfg.kv_cache_int8`; `idx` the filled length (uniform over the
    batch); `seg` (B, max_len) the validity of each key (0 for the pads of
    a right-padded prefill); `fresh` True until the first forward, which
    may then take the flash prefill. `kv_heads` (default: the config's) is
    Hkv: the KV heads a rank computes under the tensor axis."""
    hkv = cfg.num_key_value_heads if kv_heads is None else kv_heads
    shape = (cfg.num_hidden_layers, batch, max_len, hkv, cfg.head_dim)
    cache: Dict[str, Any] = {
        "idx": 0, "fresh": True,
        "seg": torch.zeros((batch, max_len), dtype=torch.int32, device=device),
    }
    if cfg.kv_cache_int8:
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{name}_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


class QuantLinear(nn.Module):
    """Weight-only quantized linear layer in the JAX package's layout, held
    as buffers, for serving (its products raise under grad): bits=4
    `kernel_q4` (in/2, out) int8 + `scale_g` (groups, out) f32
    (`ops.quant.int4_matmul`); bits=8 `kernel_q` (in, out) int8 + `scale`
    (out,) f32, weight-only, or W8A8 when the token axis (the second-to-last
    dim) is at least `w8a8_min_seq` (> 0). An optional bias is added in x's
    dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False,
                 bits: int = 8, w8a8_min_seq: int = 0, device=None, dtype=None):
        super().__init__()
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        self.in_features, self.out_features = in_features, out_features
        self.bits, self.w8a8_min_seq = bits, w8a8_min_seq
        if bits == 4:
            self.register_buffer("kernel_q4", torch.zeros(
                (in_features // 2, out_features), dtype=torch.int8, device=device))
            self.register_buffer("scale_g", torch.ones(
                (in_features // int4_group(in_features), out_features),
                dtype=torch.float32, device=device))
        else:
            self.register_buffer("kernel_q", torch.zeros(
                (in_features, out_features), dtype=torch.int8, device=device))
            self.register_buffer("scale", torch.ones(
                out_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device, dtype=dtype))
                     if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear, bits: int, w8a8_min_seq: int = 0) -> "QuantLinear":
        """Quantize an `nn.Linear` (weight (out, in)) on its own device (a
        whole one: quantize a model before `shard_model` cuts it)."""
        w = lin.weight
        q = cls(lin.in_features, lin.out_features, bias=lin.bias is not None, bits=bits,
                w8a8_min_seq=w8a8_min_seq, device=w.device, dtype=w.dtype)
        if bits == 4:
            q.kernel_q4, q.scale_g = quantize_int4(w.t())
        else:
            q.kernel_q, q.scale = quantize_int8(w.t())
        if lin.bias is not None:
            q.bias.copy_(lin.bias)
        if hasattr(lin, "logical_axes"):
            q.logical_axes = lin.logical_axes
        return q

    def forward(self, x: torch.Tensor, bias_cols: Optional[slice] = None) -> torch.Tensor:
        """x @ the dequantized kernel (+ the bias, or its `bias_cols`)."""
        if self.bits == 4:
            y = int4_matmul(x, self.kernel_q4, self.scale_g)
        elif self._w8a8(x):
            y = int8_w8a8_matmul(x, self.kernel_q, self.scale)
        else:
            y = int8_matmul(x, self.kernel_q, self.scale)
        if self.bias is not None:
            bias = self.bias if bias_cols is None else self.bias[bias_cols]
            y = y + bias.to(x.dtype)
        return y

    def _w8a8(self, x: torch.Tensor) -> bool:
        return bool(self.w8a8_min_seq and x.dim() >= 2 and x.shape[-2] >= self.w8a8_min_seq)

    def row_parallel(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's partial product of a row-parallel layer (no bias),
        x its block of the input (the int4 layout takes the whole input's
        two runs of rows its packed block holds)."""
        group = self.tp.group
        if self.bits == 4:
            half = self.kernel_q4.shape[0]
            whole = all_gather_along(x.contiguous(), x.dim() - 1, group)
            k = whole.shape[-1]
            s = self.tp.index * half
            g = int4_group(k)
            xs = torch.cat([whole[..., s:s + half], whole[..., k // 2 + s:k // 2 + s + half]], -1)
            sg = self.scale_g
            gs, gn, gh = s // g, half // g, k // 2 // g
            sg = torch.cat([sg[gs:gs + gn], sg[gh + gs:gh + gs + gn]], 0).contiguous()
            return int4_matmul(xs.contiguous(), self.kernel_q4, sg)
        if self._w8a8(x):
            amax = all_reduce(x.reshape(-1, x.shape[-1]).float().abs().amax(-1, keepdim=True)
                              .contiguous(), group, op="max")
            return int8_w8a8_matmul(x, self.kernel_q, self.scale, amax=amax)
        return int8_matmul(x, self.kernel_q, self.scale)


def column_linear(lin: nn.Module, x: torch.Tensor, cols: Optional[slice]) -> torch.Tensor:
    """A column-parallel product: the rank's output columns `cols` of a
    layer whose kernel holds only them, its whole bias sliced to them."""
    if cols is None or getattr(lin, "tp", None) is None:
        return lin(x)
    if isinstance(lin, QuantLinear):
        return lin(x, bias_cols=cols)
    return F.linear(x, lin.weight, None if lin.bias is None else lin.bias[cols])


def row_linear(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product over x, the rank's block of the input: the
    partial products summed over the tensor group in f32 (rounded to x's
    dtype once, after the sum), then the bias."""
    tp = getattr(lin, "tp", None)
    if tp is None:
        return lin(x)
    if isinstance(lin, QuantLinear):
        y = lin.row_parallel(x)
    else:
        y = F.linear(x, lin.weight)
    y = reduce_from_tensor(y.float(), tp.group).to(x.dtype)
    if lin.bias is not None:
        y = y + lin.bias.to(y.dtype)
    return y


def named(module: nn.Module, axes) -> nn.Module:
    """`module` carrying the JAX package's logical names of its kernel."""
    module.logical_axes = tuple(axes)
    return module


def make_linear(cfg, in_features: int, out_features: int, bias: bool, w8a8: bool = True,
                **factory) -> nn.Module:
    """`nn.Linear`, or a `QuantLinear` under the config's quantization."""
    int4 = getattr(cfg, "quant_int4", False)
    if cfg.quant_int8 and int4:
        raise ValueError("quant_int8 and quant_int4 are mutually exclusive")
    if cfg.quant_int8 or int4:
        return QuantLinear(
            in_features, out_features, bias=bias, bits=4 if int4 else 8,
            w8a8_min_seq=32 if (w8a8 and getattr(cfg, "quant_w8a8", False)) else 0, **factory)
    return nn.Linear(in_features, out_features, bias=bias, **factory)


class Attention(nn.Module):
    def __init__(self, cfg: QwenTextConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.plain_attention = False
        # the tensor axis (`parallel.tensor.setup`): the heads this rank
        # computes and its columns of q and of k / v
        self.tp, self.local_heads, self.q_cols, self.kv_cols = None, None, None, None
        d, h, hkv, hd = (cfg.hidden_size, cfg.num_attention_heads,
                         cfg.num_key_value_heads, cfg.head_dim)
        self.q_proj = named(make_linear(cfg, d, h * hd, True, **factory), ("embed", "heads"))
        self.k_proj = named(make_linear(cfg, d, hkv * hd, True, **factory), ("embed", "heads"))
        self.v_proj = named(make_linear(cfg, d, hkv * hd, True, **factory), ("embed", "heads"))
        self.o_proj = named(make_linear(cfg, h * hd, d, False, **factory), ("heads", "embed"))
        if cfg.lora_rank > 0:
            r = cfg.lora_rank
            # (in, r) and (r, out), the JAX package's layout; PEFT init
            self.q_proj_lora_a = nn.Parameter(torch.randn(d, r, **factory) / r)
            self.q_proj_lora_b = nn.Parameter(torch.zeros(r, h * hd, **factory))
            self.v_proj_lora_a = nn.Parameter(torch.randn(d, r, **factory) / r)
            self.v_proj_lora_b = nn.Parameter(torch.zeros(r, hkv * hd, **factory))

    def _lora(self, name: str, x: torch.Tensor, base: torch.Tensor,
              cols: Optional[slice] = None) -> torch.Tensor:
        """base + (alpha / r) * x @ A @ B (B's columns `cols` under the
        tensor axis), computed in f32."""
        if self.cfg.lora_rank <= 0:
            return base
        a = getattr(self, f"{name}_lora_a").float()
        b = getattr(self, f"{name}_lora_b").float()
        if cols is not None:
            b = b[:, cols]
        scale = self.cfg.lora_alpha / self.cfg.lora_rank
        return base + (x.float() @ a @ b * scale).to(base.dtype)

    def heads(self):
        """(query heads, KV heads) this rank computes."""
        cfg = self.cfg
        return self.local_heads or (cfg.num_attention_heads, cfg.num_key_value_heads)

    def forward(self, x, cos, sin, segment_ids: Optional[torch.Tensor],
                layer_cache: Optional[Dict[str, torch.Tensor]] = None, cache_idx: int = 0,
                cache_seg: Optional[torch.Tensor] = None, fresh_cache: bool = False):
        """Without `layer_cache`: causal flash attention over x. With it:
        append k / v at `cache_idx` (in place), then attend over the filled
        prefix: a multi-token call into a fresh cache takes causal flash
        over its own block, any other call the masked f32 attention."""
        cfg = self.cfg
        b, l, _ = x.shape
        (h, hkv), hd = self.heads(), cfg.head_dim
        if self.tp is not None:
            x = copy_to_tensor(x, self.tp.group)
        q = self._lora("q_proj", x, column_linear(self.q_proj, x, self.q_cols),
                       self.q_cols).reshape(b, l, h, hd)
        k = column_linear(self.k_proj, x, self.kv_cols).reshape(b, l, hkv, hd)
        v = self._lora("v_proj", x, column_linear(self.v_proj, x, self.kv_cols),
                       self.kv_cols).reshape(b, l, hkv, hd)
        q = rope_ops.apply_rope(q, cos, sin)
        k = rope_ops.apply_rope(k, cos, sin)
        if layer_cache is not None:
            end = cache_idx + l
            if "k_scale" in layer_cache:
                (kq, ks), (vq, vs) = _quantize_kv_i8(k), _quantize_kv_i8(v)
                layer_cache["k"][:, cache_idx:end], layer_cache["v"][:, cache_idx:end] = kq, vq
                layer_cache["k_scale"][:, cache_idx:end] = ks
                layer_cache["v_scale"][:, cache_idx:end] = vs
            else:
                layer_cache["k"][:, cache_idx:end], layer_cache["v"][:, cache_idx:end] = k, v
        if layer_cache is None or (l > 1 and fresh_cache):
            attend = mha_reference if self.plain_attention else flash_attention
            out = attend(q, k, v, causal=True, segment_ids=segment_ids)
        else:
            out = self._cached_attention(q, layer_cache, cache_idx, cache_seg, x.dtype)
        return row_linear(self.o_proj, out.reshape(b, l, h * hd))

    def _cached_attention(self, q, layer_cache, cache_idx, cache_seg, dtype):
        """GQA-native masked attention of q (B, L, H, hd) over the cache's
        filled prefix in f32: keys after each query's position and pad keys
        (`cache_seg` 0) get -1e30. A row's sums run over the keys up to its
        own position, whatever the cache's size, and up to ROW_EXACT_TOKENS
        queries are computed one at a time (the f32 products' kernels change
        with L): so each row rounds as a one-token step at its position does,
        and speculative decoding's verify chooses the tokens greedy decoding
        would."""
        l = q.shape[1]
        if 1 < l <= ROW_EXACT_TOKENS:
            return torch.cat([
                self._cached_attention(q[:, i:i + 1], layer_cache, cache_idx + i, cache_seg, dtype)
                for i in range(l)], 1)
        b, l, h, hd = q.shape
        hkv = self.heads()[1]
        end = cache_idx + l
        ck, cv = layer_cache["k"][:, :end], layer_cache["v"][:, :end]
        if "k_scale" in layer_cache:
            ckf = ck.float() * layer_cache["k_scale"][:, :end, :, None]
            cvf = cv.float() * layer_cache["v_scale"][:, :end, :, None]
        else:
            ckf, cvf = ck.float(), cv.float()
        q5 = q.reshape(b, l, hkv, h // hkv, hd).float()
        logits = torch.einsum("bqkgd,bmkd->bkgqm", q5, ckf) * (hd ** -0.5)
        kpos = torch.arange(end, device=q.device)
        qpos = cache_idx + torch.arange(l, device=q.device)
        valid = (kpos[None, :] <= qpos[:, None])[None, None, None]  # causal
        if cache_seg is not None:
            valid = valid & (cache_seg[:, None, None, None, :end] > 0)
        logits = logits.masked_fill(~valid, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgqm,bmkd->bqkgd", probs, cvf)
        return out.reshape(b, l, h, hd).to(dtype)


class MLP(nn.Module):
    def __init__(self, cfg: QwenTextConfig, **factory):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.tp = None
        self.gate_proj = named(make_linear(cfg, d, f, False, **factory), ("embed", "mlp"))
        self.up_proj = named(make_linear(cfg, d, f, False, **factory), ("embed", "mlp"))
        self.down_proj = named(make_linear(cfg, f, d, False, **factory), ("mlp", "embed"))

    def forward(self, x):
        if self.tp is not None:
            x = copy_to_tensor(x, self.tp.group)
        return row_linear(self.down_proj, F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: QwenTextConfig, **factory):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **factory)
        self.self_attn = Attention(cfg, **factory)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, **factory
        )
        self.mlp = MLP(cfg, **factory)

    def forward(self, x, cos, sin, segment_ids, layer_cache=None, cache_idx=0,
                cache_seg=None, fresh_cache=False):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, segment_ids,
                               layer_cache, cache_idx, cache_seg, fresh_cache)
        return x + self.mlp(self.post_attention_layernorm(x))


REMAT_MODES = ("none", "full", "dots")
# the products without batch dimensions: a decoder layer's weight products
# (q / k / v / o, gate / up / down and the LoRA factors) reach the dispatcher
# as these, its attention's batched products as bmm
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """The "dots" remat policy, JAX's `dots_with_no_batch_dims_saveable`:
    the outputs of the weight products are saved, everything else (norms,
    RoPE, activations, attention) is recomputed in the backward."""
    if op in DOT_OPS:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    # looked up at each call, so that a caller may wrap the policy
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(dots_policy)


def remat_mode(remat: Any) -> str:
    """The decoder's activation strategy from the JAX package's values:
    False / None / "none" store everything; True / "full" recompute each
    decoder layer in the backward; "dots" recompute it but keep the weight
    products' outputs (`dots_policy`). Both run a layer under
    `torch.utils.checkpoint` (non-reentrant)."""
    mode = {False: "none", None: "none", True: "full"}.get(remat, remat)
    if mode not in REMAT_MODES:
        raise ValueError(f"remat={remat!r}: takes {REMAT_MODES}")
    return mode


class QwenLM(nn.Module):
    """Decoder stack over input embeddings with 3-stream M-RoPE ids.
    `remat` ("none", "full" or "dots") applies to the forward without a
    cache, under autograd."""

    def __init__(self, cfg: QwenTextConfig, remat: Any = "none", **factory):
        super().__init__()
        self.cfg = cfg
        # (module prefix, the JAX package's stacked path) under scan_layers:
        # the layers are the same modules, the JAX tree stacks them
        # (`layers_scan/layer/...` along a leading layer axis)
        self.flax_scan = ("layers_", "layers_scan/layer") if cfg.scan_layers else None
        self.remat = remat_mode(remat)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layers_{i}", DecoderLayer(cfg, **factory))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **factory)

    def forward(self, inputs_embeds, position_ids, segment_ids=None,
                cache: Optional[Dict[str, Any]] = None):
        """Hidden states (B, L, D). With a cache: the new tokens' K / V and
        key validity are written at `cache["idx"]`, which then advances."""
        cfg = self.cfg
        cos, sin = rope_ops.mrope_cos_sin(
            position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section
        )
        x = inputs_embeds
        b, l = x.shape[:2]
        idx, cache_seg, fresh = 0, None, False
        if cache is not None:
            idx, fresh = cache["idx"], cache["fresh"]
            cache_seg = cache["seg"]
            cache_seg[:, idx:idx + l] = (1 if segment_ids is None else segment_ids)
        remat = self.remat != "none" and cache is None and torch.is_grad_enabled()
        kw = {"context_fn": _dots_context} if self.remat == "dots" else {}
        for i in range(cfg.num_hidden_layers):
            layer = getattr(self, f"layers_{i}")
            if remat:
                x = torch.utils.checkpoint.checkpoint(layer, x, cos, sin, segment_ids,
                                                      use_reentrant=False, **kw)
                continue
            layer_cache = None
            if cache is not None:
                layer_cache = {key: cache[key][i] for key in CACHE_PLANES if key in cache}
            x = layer(x, cos, sin, segment_ids, layer_cache, idx, cache_seg, fresh)
        if cache is not None:
            cache["idx"], cache["fresh"] = idx + l, False
        return self.norm(x)


class QwenForCausalLM(nn.Module):
    """Embedding + decoder + lm_head (tied for 3B)."""

    def __init__(self, cfg: QwenTextConfig, remat: Any = "none", **factory):
        super().__init__()
        self.cfg = cfg
        # the tensor axis: this rank's vocabulary rows [start, end) of the
        # embedding and columns of the logits (`parallel.tensor.setup`)
        self.tp, self.vocab_range = None, None
        self.embed_tokens = named(nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory),
                                  ("vocab", "embed"))
        self.model = QwenLM(cfg, remat=remat, **factory)
        if not cfg.tie_word_embeddings:
            self.lm_head = named(make_linear(cfg, cfg.hidden_size, cfg.vocab_size, False,
                                             w8a8=False, **factory), ("embed", "vocab"))

    @property
    def compute_dtype(self) -> torch.dtype:
        """The decoder's dtype (the head, or the tied embedding, may be held
        in f32 under f32 parameters)."""
        return self.model.norm.weight.dtype

    @property
    def kv_heads(self) -> int:
        """The KV heads a rank computes (its KV cache's)."""
        return self.model.layers_0.self_attn.heads()[1]

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.vocab_range is not None:
            return vocab_parallel_embedding(self.embed_tokens, input_ids, self.vocab_range[0],
                                            self.tp.group)
        return self.embed_tokens(input_ids)

    def head(self, hidden: torch.Tensor) -> torch.Tensor:
        """The logits (this rank's vocabulary columns under the tensor axis),
        in the head's dtype: under f32 parameters the train entry point
        holds `lm_head` (or the tied embedding) in f32, as the JAX package's
        f32 parameter promotes its bf16 input, and the product then runs in
        f32 with TF32 off around it (`ops.precision.exact_f32`), as JAX
        computes it."""
        if self.tp is not None:
            hidden = copy_to_tensor(hidden, self.tp.group)
        if self.cfg.tie_word_embeddings:
            with fsdp.gathered(self.embed_tokens):
                w = self.embed_tokens.weight
                hidden = hidden.to(w.dtype)
                with exact_f32(hidden):
                    return hidden @ w.t()
        w = getattr(self.lm_head, "weight", None)
        if w is not None and w.is_floating_point():
            hidden = hidden.to(w.dtype)
        with exact_f32(hidden):
            return self.lm_head(hidden)

    def forward(self, input_ids=None, inputs_embeds=None, position_ids=None,
                segment_ids=None, cache: Optional[Dict[str, Any]] = None,
                logits_indices: Optional[torch.Tensor] = None,
                logits: bool = True) -> Dict[str, Any]:
        """`logits_indices` (B,) computes the head at one position per row
        (logits (B, 1, V)); `logits=False` skips the head (callers that read
        only the hidden states, such as the [SEG] gather)."""
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        inputs_embeds = inputs_embeds.to(self.compute_dtype)
        b, l = inputs_embeds.shape[:2]
        if position_ids is None:
            base = torch.arange(l, device=inputs_embeds.device)[None].expand(b, l)
            if cache is not None:
                base = base + cache["idx"]
            position_ids = base[None].expand(3, b, l)
        hidden = self.model(inputs_embeds, position_ids, segment_ids, cache)
        out = None
        if logits:
            sel = hidden
            if logits_indices is not None:
                rows = torch.arange(b, device=hidden.device)
                sel = hidden[rows, logits_indices.to(hidden.device)][:, None]
            out = self.head(sel)
        return {"hidden_states": hidden, "logits": out, "cache": cache}
