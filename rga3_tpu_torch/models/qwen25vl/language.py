"""Qwen2.5 decoder language model, counterpart of
`rga3_tpu/models/qwen25vl/language.py`, for a prefill without a KV cache:
causal flash attention with optional segment ids, M-RoPE, and the LoRA
adapters on q_proj / v_proj. The KV cache, quantization and scanned layers
of the JAX package are not ported yet; their config fields raise."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import rope as rope_ops
from ...ops.attention import flash_attention, mha_reference
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


class Attention(nn.Module):
    def __init__(self, cfg: QwenTextConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.plain_attention = False
        d, h, hkv, hd = (cfg.hidden_size, cfg.num_attention_heads,
                         cfg.num_key_value_heads, cfg.head_dim)
        self.q_proj = nn.Linear(d, h * hd, **factory)
        self.k_proj = nn.Linear(d, hkv * hd, **factory)
        self.v_proj = nn.Linear(d, hkv * hd, **factory)
        self.o_proj = nn.Linear(h * hd, d, bias=False, **factory)
        if cfg.lora_rank > 0:
            r = cfg.lora_rank
            # (in, r) and (r, out), the JAX package's layout; PEFT init
            self.q_proj_lora_a = nn.Parameter(torch.randn(d, r, **factory) / r)
            self.q_proj_lora_b = nn.Parameter(torch.zeros(r, h * hd, **factory))
            self.v_proj_lora_a = nn.Parameter(torch.randn(d, r, **factory) / r)
            self.v_proj_lora_b = nn.Parameter(torch.zeros(r, hkv * hd, **factory))

    def _lora(self, name: str, x: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
        """base + (alpha / r) * x @ A @ B, computed in f32."""
        if self.cfg.lora_rank <= 0:
            return base
        a = getattr(self, f"{name}_lora_a").float()
        b = getattr(self, f"{name}_lora_b").float()
        scale = self.cfg.lora_alpha / self.cfg.lora_rank
        return base + (x.float() @ a @ b * scale).to(base.dtype)

    def forward(self, x, cos, sin, segment_ids: Optional[torch.Tensor]):
        cfg = self.cfg
        b, l, _ = x.shape
        h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = self._lora("q_proj", x, self.q_proj(x)).reshape(b, l, h, hd)
        k = self.k_proj(x).reshape(b, l, hkv, hd)
        v = self._lora("v_proj", x, self.v_proj(x)).reshape(b, l, hkv, hd)
        q = rope_ops.apply_rope(q, cos, sin)
        k = rope_ops.apply_rope(k, cos, sin)
        attend = mha_reference if self.plain_attention else flash_attention
        out = attend(q, k, v, causal=True, segment_ids=segment_ids)
        return self.o_proj(out.reshape(b, l, h * hd))


class MLP(nn.Module):
    def __init__(self, cfg: QwenTextConfig, **factory):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(d, f, bias=False, **factory)
        self.up_proj = nn.Linear(d, f, bias=False, **factory)
        self.down_proj = nn.Linear(f, d, bias=False, **factory)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: QwenTextConfig, **factory):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **factory)
        self.self_attn = Attention(cfg, **factory)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, **factory
        )
        self.mlp = MLP(cfg, **factory)

    def forward(self, x, cos, sin, segment_ids):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, segment_ids)
        return x + self.mlp(self.post_attention_layernorm(x))


class QwenLM(nn.Module):
    """Decoder stack over input embeddings with 3-stream M-RoPE ids."""

    def __init__(self, cfg: QwenTextConfig, **factory):
        super().__init__()
        for flag in ("scan_layers", "quant_int8", "quant_int4", "kv_cache_int8",
                     "quant_w8a8"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"QwenTextConfig.{flag} is not ported")
        self.cfg = cfg
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layers_{i}", DecoderLayer(cfg, **factory))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **factory)

    def forward(self, inputs_embeds, position_ids, segment_ids=None):
        cfg = self.cfg
        cos, sin = rope_ops.mrope_cos_sin(
            position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section
        )
        x = inputs_embeds
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layers_{i}")(x, cos, sin, segment_ids)
        return self.norm(x)


class QwenForCausalLM(nn.Module):
    """Embedding + decoder + lm_head (tied for 3B)."""

    def __init__(self, cfg: QwenTextConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.model = QwenLM(cfg, **factory)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **factory)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def head(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_word_embeddings:
            return hidden @ self.embed_tokens.weight.t()
        return self.lm_head(hidden)

    def forward(self, input_ids=None, inputs_embeds=None, position_ids=None,
                segment_ids=None, logits: bool = True) -> Dict[str, torch.Tensor]:
        """`logits=False` skips the vocabulary projection (callers that
        read only the hidden states, such as the [SEG] gather)."""
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        inputs_embeds = inputs_embeds.to(self.embed_tokens.weight.dtype)
        b, l = inputs_embeds.shape[:2]
        if position_ids is None:
            base = torch.arange(l, device=inputs_embeds.device)[None].expand(b, l)
            position_ids = base[None].expand(3, b, l)
        hidden = self.model(inputs_embeds, position_ids, segment_ids)
        return {
            "hidden_states": hidden,
            "logits": self.head(hidden) if logits else None,
        }
