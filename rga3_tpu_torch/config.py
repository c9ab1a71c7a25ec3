"""Typed configuration: frozen dataclasses that serialize to/from JSON.

The port's own copy of `rga3_tpu/config.py` (`ConfigBase`, `SegHeadConfig`);
the configs of the models live next to the model code.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict


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
