"""SAM2 (Hiera) architecture configs: the port's own copy of
`rga3_tpu/models/sam2/config.py`, field for field, so that a config saved by
either package loads in the other.

The Hiera fusion switches (`use_fused_block`, `use_split_fused_block`,
`use_fused_transition`) choose the same routes as in the JAX package, each
through the port's CUDA kernels (`ops/fused_block.py`); `unfused(cfg)` turns
them off, and the parameter tree is the same either way. The TPU block sizes
(`fused_block_q_small`, `fused_block_q_large`) are kept for file
compatibility and not read.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from ...config import ConfigBase


@dataclass(frozen=True)
class HieraConfig(ConfigBase):
    embed_dim: int = 144
    num_heads: int = 2  # initial; doubles per stage
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    q_stride: Tuple[int, int] = (2, 2)
    q_pool: int = 3  # number of pooling stage transitions
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    gelu_tanh: bool = True
    use_window_kernel: bool = True
    use_fused_block: bool = True
    fused_block_max_dim: int = 576
    fused_block_q_small: int = 512
    fused_block_q_large: int = 0
    use_split_fused_block: bool = True
    use_fused_transition: bool = True
    s2d_patch_embed: bool = False

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        ends, total = [], 0
        for s in self.stages:
            total += s
            ends.append(total - 1)
        return tuple(ends)

    @property
    def q_pool_blocks(self) -> Tuple[int, ...]:
        return tuple(e + 1 for e in self.stage_ends[:-1])[: self.q_pool]

    @property
    def channel_list(self) -> Tuple[int, ...]:
        dims, d = [], self.embed_dim
        for i in range(len(self.stages)):
            if i > 0:
                d = int(d * self.dim_mul)
            dims.append(d)
        return tuple(reversed(dims))


@dataclass(frozen=True)
class Sam2Config(ConfigBase):
    hiera: HieraConfig = field(default_factory=HieraConfig)
    d_model: int = 256
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    scalp: int = 1
    image_size: int = 1024
    backbone_stride: int = 16
    num_maskmem: int = 7
    max_obj_ptrs_in_encoder: int = 16
    mem_dim: int = 64
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    directly_add_no_mem_embed: bool = True
    use_high_res_features_in_sam: bool = True
    multimask_output_in_sam: bool = True
    iou_prediction_use_sigmoid: bool = True
    use_obj_ptrs_in_encoder: bool = True
    add_tpos_enc_to_obj_ptrs: bool = False
    only_obj_ptrs_in_the_past_for_eval: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    fixed_no_obj_ptr: bool = True
    multimask_output_for_tracking: bool = True
    use_multimask_token_for_obj_ptr: bool = True
    multimask_min_pt_num: int = 0
    multimask_max_pt_num: int = 1
    use_mlp_for_obj_ptr_proj: bool = True
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98
    memory_temporal_stride_for_eval: int = 1
    mem_attn_layers: int = 4
    mem_attn_dim_feedforward: int = 2048
    mem_attn_rope_theta: float = 10_000.0
    num_multimask_outputs: int = 3
    twoway_depth: int = 2
    twoway_mlp_dim: int = 2048
    twoway_heads: int = 8

    # release values whose behaviour the modules hard-code
    _HARDCODED = {
        "use_high_res_features_in_sam": True,
        "multimask_output_in_sam": True,
        "multimask_min_pt_num": 0,
        "multimask_max_pt_num": 1,
        "multimask_output_for_tracking": True,
        "use_obj_ptrs_in_encoder": True,
        "add_tpos_enc_to_obj_ptrs": False,
        "only_obj_ptrs_in_the_past_for_eval": True,
        "pred_obj_scores": True,
        "pred_obj_scores_mlp": True,
        "fixed_no_obj_ptr": True,
        "use_mlp_for_obj_ptr_proj": True,
        "directly_add_no_mem_embed": True,
    }

    def __post_init__(self) -> None:
        for name, required in self._HARDCODED.items():
            got = getattr(self, name)
            if got != required:
                raise ValueError(
                    f"Sam2Config.{name}={got!r} is not implemented: the "
                    f"release value {required!r} is hard-coded in the modules"
                )

    @property
    def feat_size(self) -> int:
        return self.image_size // self.backbone_stride

    @property
    def hidden_dim(self) -> int:
        return self.d_model


SAM2_HIERA_L = Sam2Config()


def tiny_sam2_config(image_size: int = 128) -> Sam2Config:
    """Small config for tests: 8 blocks, dim 16, same topology."""
    return Sam2Config(
        hiera=HieraConfig(
            embed_dim=16,
            num_heads=1,
            stages=(1, 2, 4, 1),
            global_att_blocks=(5,),
            window_spec=(4, 2, 4, 2),
            window_pos_embed_bkg_spatial_size=(7, 7),
        ),
        d_model=32,
        mem_dim=16,
        image_size=image_size,
        mem_attn_layers=2,
        mem_attn_dim_feedforward=64,
        twoway_mlp_dim=64,
        twoway_heads=4,
    )


def unfused(cfg: Sam2Config) -> Sam2Config:
    """`cfg` with the Hiera fusions turned off: the unfused block path."""
    return cfg.replace(hiera=cfg.hiera.replace(
        use_fused_block=False, use_fused_transition=False,
    ))
