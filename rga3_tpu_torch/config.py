"""Typed configuration: frozen dataclasses that serialize to/from JSON.

The port's own copy of `rga3_tpu/config.py` (`ConfigBase`, `SegHeadConfig`,
`TrainConfig`); the configs of the models live next to the model code.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Tuple


class ConfigBase:
    """JSON (de)serialization shared by all configs."""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                continue
            ftype = fields[k].type
            if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
                kwargs[k] = ftype.from_dict(v)
            else:
                kwargs[k] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class SegHeadConfig(ConfigBase):
    """[SEG]-token projection head and loss weights."""

    out_dim: int = 256
    ce_loss_weight: float = 1.0
    dice_loss_weight: float = 0.5
    bce_loss_weight: float = 2.0
    dice_scale: float = 1000.0
    train_mask_decoder: bool = True
    freeze_sam_backbone: bool = True
    # resolved at tokenizer build time; -1 = unset
    seg_token_id: int = -1


@dataclass(frozen=True)
class MeshConfig(ConfigBase):
    """The ranks' mesh, the JAX package's fields: `data` splits the batch
    (and may cross nodes); `fsdp` shards the trainable state and the
    gradients (ZeRO-2) and the frozen weights (gathered around each block's
    forward), inside one node; `tensor` is the LM's tensor axis (heads, MLP
    columns and the vocabulary split over its ranks). `parallel.make_mesh`
    raises only for a grid that does not match the ranks and their nodes."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1

    @property
    def axis_names(self) -> Tuple[str, str, str]:
        return ("data", "fsdp", "tensor")


@dataclass(frozen=True)
class TrainConfig(ConfigBase):
    """Training hyperparameters, the JAX package's fields and defaults
    (AdamW, warmup then cosine to a floor, clipping, LoRA, the trainable
    modules on top of LoRA, frames per sample)."""

    lr: float = 4e-5
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    min_lr_ratio: float = 0.03  # cosine floor
    grad_clip: float = 1.0
    epochs: int = 80
    steps_per_epoch: int = 100
    micro_batch_size: int = 2
    grad_accum_steps: int = 8
    precision: str = "bfloat16"
    # dtype of Adam's first moment ("float32" or "bfloat16"); the second
    # moment keeps the parameter's dtype
    adam_mu_dtype: str = "float32"
    lora_r: int = 128
    lora_alpha: int = 256
    lora_dropout: float = 0.05
    lora_target_modules: Tuple[str, ...] = ("q_proj", "v_proj")
    # modules with full fine-tuning on top of LoRA
    trainable_modules: Tuple[str, ...] = (
        "lm_head",
        "embed_tokens",
        "sam_mask_decoder",
        "text_hidden_fcs",
    )
    num_frames_mllm: int = 8
    num_frames_sam: int = 4
    seed: int = 42
    auto_resume: bool = True
    ckpt_dir: str = "runs/default"
    # LM activation strategy: "full" recomputes whole decoder layers in the
    # backward, "none" stores everything, "dots" (the JAX package's default)
    # recomputes them but keeps the weight products' outputs. bool accepted
    # (True -> "full", False -> "none").
    remat: Any = "dots"
