"""Video segmentation entry points, counterpart of
`rga3_tpu/models/sam2/video.py`:

1. `segment_video_with_language`: every frame a conditioning frame prompted
   with the [SEG] embedding, no memory (UniGR's evaluation path), in
   chunks of frames.
2. `track_video`: the SAM2 memory-propagated tracker. Frame 0 is the
   conditioning frame (language- or point-prompted); frames 1..T-1 attend
   to a static memory bank of 7 mask memories (the cond frame, then t_pos
   1..6) and 16 object pointers, with a key-validity mask, exactly as the
   JAX package builds it for its `lax.scan`. O objects run as one batch,
   each with its own bank; the trunk encodes each frame once.

The frame loop is eager Python: the bank's frame indices are host ints
(no device round trip decides a slot's validity), and the bank's tensors
are updated in place (JAX builds new arrays).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ...device import DeviceLike, resolve_device
from .config import Sam2Config
from .model import Sam2Model


def _on_model_device(model: Sam2Model, device: DeviceLike) -> torch.device:
    """The device to run on: the card unless `device` asks for another,
    which must be the model's."""
    dev = resolve_device(device)
    have = model.no_mem_embed.device
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"the model is on {have}, not on {dev}")
    return have


@torch.no_grad()
def segment_video_with_language(model: Sam2Model, frames, language_embd, chunk: int = 8,
                                device: DeviceLike = None) -> torch.Tensor:
    """frames (T, H, W, 3) (uint8, or normalized float); language_embd
    (1, C) or (T, 1, C). Returns (T, 1, S, S) high-resolution mask logits,
    decoded `chunk` frames at a time."""
    dev = _on_model_device(model, device)
    frames = torch.as_tensor(frames, device=dev)
    language_embd = torch.as_tensor(language_embd, device=dev)
    t = frames.shape[0]
    if language_embd.dim() == 2:
        language_embd = language_embd[None].expand(t, *language_embd.shape)
    outs = [model.decode_frames_with_language(frames[i:i + chunk],
                                              language_embd[i:i + chunk])["high_res_masks"]
            for i in range(0, t, chunk)]
    return torch.cat(outs, 0)


class MemoryBank:
    """The static memory state: a dict of tensors and the host-side frame
    index of each slot (-1: empty)."""

    @staticmethod
    def init(cfg: Sam2Config, batch: int, dtype: torch.dtype, device) -> Dict[str, object]:
        """`dtype` is the trunk features' (bf16 on the card): an f32 bank
        would make the memory attention's K/V f32."""
        ltok = cfg.feat_size ** 2
        n_ring = cfg.num_maskmem - 1
        n_ptr = cfg.max_obj_ptrs_in_encoder - 1

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {
            # the conditioning frame (t_pos 0)
            "cond_feat": zeros(batch, ltok, cfg.mem_dim),
            "cond_ptr": zeros(batch, cfg.hidden_dim),
            "cond_valid": False,
            # the previous frame (t_rel 1), kept whatever the stride
            "prev_feat": zeros(batch, ltok, cfg.mem_dim),
            "prev_frame": -1,
            # the stride-aligned frames (t_rel >= 2)
            "ring_feat": zeros(n_ring, batch, ltok, cfg.mem_dim),
            "ring_frame": [-1] * n_ring,
            # the last n_ptr object pointers
            "ptr_ring": zeros(n_ptr, batch, cfg.hidden_dim),
            "ptr_frame": [-1] * n_ptr,
        }


def wanted_memory_frame(cfg: Sam2Config, frame_idx: int, t_rel: int) -> int:
    """The frame attended at temporal distance t_rel >= 2: every r-th frame,
    r = memory_temporal_stride_for_eval (frame_idx - t_rel when r = 1)."""
    r = cfg.memory_temporal_stride_for_eval
    return ((frame_idx - 2) // r) * r - (t_rel - 2) * r


def ring_slot(cfg: Sam2Config, frame_idx: int) -> int:
    """The ring slot of a stride-aligned frame's memory."""
    r = cfg.memory_temporal_stride_for_eval
    return (frame_idx // r) % (cfg.num_maskmem - 1)


def _full(b: int, n: int, ok: bool, device) -> torch.Tensor:
    return torch.full((b, n), bool(ok), dtype=torch.bool, device=device)


def _build_memory(model: Sam2Model, cfg: Sam2Config, state, frame_idx: int,
                  mem_pos_spatial: torch.Tensor, maskmem_tpos_enc: torch.Tensor):
    """The (B, Lk, mem_dim) bank, its positional encoding, its (B, Lk)
    validity and the number of pointer tokens: the cond frame (t_pos 0),
    the earlier frames earliest to latest (t_pos 1..num_maskmem-1), then the
    object-pointer tokens (cond pointer first), every slot present whether
    valid or not."""
    b, ltok = state["cond_feat"].shape[:2]
    dev = state["cond_feat"].device
    n_ptr = cfg.max_obj_ptrs_in_encoder - 1
    feats = [state["cond_feat"]]
    poses = [mem_pos_spatial[None] + maskmem_tpos_enc[cfg.num_maskmem - 1].reshape(1, 1, -1)]
    valids = [_full(b, ltok, state["cond_valid"], dev)]
    for t_pos in range(1, cfg.num_maskmem):
        t_rel = cfg.num_maskmem - t_pos
        if t_rel == 1:
            want = frame_idx - 1
            feat = state["prev_feat"]
            ok = state["prev_frame"] == want and want >= 0
        else:
            want = wanted_memory_frame(cfg, frame_idx, t_rel)
            slot = ring_slot(cfg, want)
            feat = state["ring_feat"][slot]
            ok = state["ring_frame"][slot] == want and want >= 0
        feats.append(feat)
        poses.append(mem_pos_spatial[None] + maskmem_tpos_enc[t_rel - 1].reshape(1, 1, -1))
        valids.append(_full(b, ltok, ok, dev))
    memory = torch.cat(feats, 1)
    memory_pos = torch.cat([p.expand(b, ltok, cfg.mem_dim) for p in poses], 1)

    ptrs, ptr_ok = [state["cond_ptr"]], [state["cond_valid"]]
    for t_diff in range(1, cfg.max_obj_ptrs_in_encoder):
        want = frame_idx - t_diff
        slot = want % n_ptr
        ptrs.append(state["ptr_ring"][slot])
        ptr_ok.append(state["ptr_frame"][slot] == want and want >= 0)
    ptr_tokens = model.obj_ptrs_to_tokens(torch.stack(ptrs))  # (N * r, B, mem_dim)
    r = cfg.hidden_dim // cfg.mem_dim
    n_tok = ptr_tokens.shape[0]
    memory = torch.cat([memory, ptr_tokens.transpose(0, 1)], 1)
    memory_pos = torch.cat([memory_pos, memory_pos.new_zeros(b, n_tok, cfg.mem_dim)], 1)
    valid = torch.cat(valids + [_full(b, r, ok, dev) for ok in ptr_ok], 1)
    return memory, memory_pos, valid, n_tok


@torch.no_grad()
def track_video(model: Sam2Model, frames, language_embd=None, point_coords=None,
                point_labels=None, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Memory-propagated tracking of O objects from frame-0 prompts:
    `language_embd` (O, N, C), or clicks `point_coords` (O, P, 2) in pixels
    of the SAM image with `point_labels` (O, P). frames (T, S, S, 3), uint8
    (normalized on the device) or normalized float. Returns
    {"high_res_masks": (T, O, S, S) f32 logits, "obj_ptrs": (T, O, C)}.

    Runs on the card unless `device` asks for the CPU; the model must be on
    that device."""
    dev = _on_model_device(model, device)
    cfg = model.cfg
    frames = torch.as_tensor(frames, device=dev)
    if language_embd is not None:
        language_embd = torch.as_tensor(language_embd, device=dev)
        n_obj = language_embd.shape[0]
    else:
        point_coords = torch.as_tensor(point_coords, device=dev)
        point_labels = torch.as_tensor(point_labels, device=dev)
        n_obj = point_coords.shape[0]
    t = frames.shape[0]
    s = cfg.feat_size

    feats = model.forward_image(frames)
    s0, s1, s2 = feats["backbone_fpn"]
    pos2 = feats["vision_pos_enc"][2]

    def tile(x):  # one frame's features -> the objects' batch
        return x[None].expand(n_obj, *x.shape)

    # frame 0: the conditioning frame, prompted, no memory
    pix0 = tile(s2[0]) + model.no_mem_embed.reshape(1, 1, 1, -1)
    out0 = model.forward_sam_heads(pix0, (tile(s0[0]), tile(s1[0])), language_embd,
                                   point_coords, point_labels, multimask_output=True)
    mem0, mem_pos0 = model.encode_new_memory(tile(s2[0]),
                                             out0["high_res_masks"].permute(0, 2, 3, 1))
    bank_dtype = s2.dtype  # the trunk's: bf16 on the card
    state = MemoryBank.init(cfg, n_obj, bank_dtype, dev)
    state["cond_feat"] = mem0.reshape(n_obj, s * s, cfg.mem_dim).to(bank_dtype)
    state["cond_ptr"] = out0["obj_ptr"].to(bank_dtype)
    state["cond_valid"] = True
    mem_pos_spatial = mem_pos0.reshape(s * s, cfg.mem_dim).to(bank_dtype)
    tpos = model.maskmem_tpos_enc
    n_ptr = cfg.max_obj_ptrs_in_encoder - 1
    stride = cfg.memory_temporal_stride_for_eval

    masks, ptrs = [out0["high_res_masks"][:, 0]], [out0["obj_ptr"]]
    for idx in range(1, t):
        memory, memory_pos, valid, nptr = _build_memory(
            model, cfg, state, idx, mem_pos_spatial, tpos)
        pix = model.condition_on_memory(tile(s2[idx]), tile(pos2[idx]), memory, memory_pos,
                                        valid, nptr)
        out = model.forward_sam_heads(pix, (tile(s0[idx]), tile(s1[idx])),
                                      multimask_output=True)
        memf, _ = model.encode_new_memory(tile(s2[idx]), out["high_res_masks"].permute(0, 2, 3, 1))
        memf = memf.reshape(n_obj, s * s, cfg.mem_dim).to(bank_dtype)
        state["prev_feat"], state["prev_frame"] = memf, idx
        if idx % stride == 0:  # the t_rel >= 2 pool keeps stride-aligned frames only
            slot = ring_slot(cfg, idx)
            state["ring_feat"][slot] = memf
            state["ring_frame"][slot] = idx
        pslot = idx % n_ptr
        state["ptr_ring"][pslot] = out["obj_ptr"].to(bank_dtype)
        state["ptr_frame"][pslot] = idx
        masks.append(out["high_res_masks"][:, 0])
        ptrs.append(out["obj_ptr"])
    return {"high_res_masks": torch.stack(masks), "obj_ptrs": torch.stack(ptrs)}
