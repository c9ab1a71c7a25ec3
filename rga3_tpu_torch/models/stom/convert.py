"""The official CoTracker3-offline checkpoint (`scaled_offline.pth`, the
`CoTrackerThreeOffline` state dict) onto the port's
`cotracker3.CoTracker3Offline`, the counterpart of
`rga3_tpu/models/stom/convert.py`.

The port's modules already hold torch layouts (Linear weights (out, in),
convolutions OIHW), so only the names map. The port keeps the flax names
of its submodules: a listed block `layer1_0` / `time_blocks_2` /
`downsample_0` is `layer1.0` / `time_blocks.2` / `downsample.0` in the
checkpoint, and `corr_mlp_fc1` is `corr_mlp.fc1`; every other name is the
same (`virual_tracks` too). The instance norms and the pre-norms have no
parameters on either side; the sincos buffers `time_emb` / `pos_emb` of the
checkpoint are recomputed, not loaded.

  * `to_official_key` / `from_official_key`: one name each way;
  * `export_torch_state_dict(model)`: the checkpoint's state dict;
  * `load_torch_state_dict(model, sd)`: strict, every checkpoint tensor
    consumed (the skipped buffers excepted), every parameter filled, shapes
    checked, errors that name the checkpoint's key and the model's;
  * `infer_config_from_state_dict(sd)`: a `CoTracker3Config` from the
    tensors' shapes;
  * `build_cotracker3_from_state_dict` / `build_cotracker3_from_checkpoint`:
    the model of a state dict or of a `torch.save`d file, on the card unless
    `device` asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from .cotracker3 import CoTracker3Config, CoTracker3Offline

# buffers of the official checkpoint that the model recomputes
SKIPPED_TORCH_KEYS = ("time_emb", "pos_emb")
# submodule lists: `name_i` in the port, `name.i` in the checkpoint
LISTED = ("layer1", "layer2", "layer3", "layer4", "downsample", "time_blocks",
          "space_virtual_blocks", "space_point2virtual_blocks", "space_virtual2point_blocks")


def to_official_key(key: str) -> str:
    """'fnet.layer1_0.conv1.weight' -> 'fnet.layer1.0.conv1.weight'."""
    parts = []
    for seg in key.split("."):
        head, _, idx = seg.rpartition("_")
        if idx.isdigit() and head in LISTED:
            parts.append(f"{head}.{idx}")
        elif seg.startswith("corr_mlp_fc"):
            parts.append("corr_mlp." + seg[len("corr_mlp_"):])
        else:
            parts.append(seg)
    return ".".join(parts)


def from_official_key(key: str) -> str:
    """'fnet.layer1.0.conv1.weight' -> 'fnet.layer1_0.conv1.weight'."""
    segs = key.split(".")
    parts = []
    i = 0
    while i < len(segs):
        seg = segs[i]
        if i + 1 < len(segs) and segs[i + 1].isdigit() and seg in LISTED:
            parts.append(f"{seg}_{segs[i + 1]}")
            i += 2
        elif seg == "corr_mlp" and i + 1 < len(segs):
            parts.append(f"corr_mlp_{segs[i + 1]}")
            i += 2
        else:
            parts.append(seg)
            i += 1
    return ".".join(parts)


def _normalize_sd(sd: Mapping) -> Dict:
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}


def export_torch_state_dict(model: CoTracker3Offline) -> Dict[str, torch.Tensor]:
    """The model's parameters under the checkpoint's names, on the CPU."""
    return {to_official_key(k): v.detach().cpu().clone() for k, v in model.state_dict().items()}


def load_torch_state_dict(model: CoTracker3Offline, state_dict: Mapping) -> CoTracker3Offline:
    """Fill every parameter of `model` from the checkpoint's `state_dict`
    (torch tensors or numpy arrays; a "model." prefix is dropped). Raises
    ValueError at a shape that differs and KeyError listing missing and
    unexpected keys; returns the model."""
    sd = _normalize_sd(state_dict)
    own = model.state_dict()
    new, used, missing = {}, set(), []
    for key, t in own.items():
        off = to_official_key(key)
        if off not in sd:
            missing.append(f"{off} (model: {key})")
            continue
        arr = sd[off] if torch.is_tensor(sd[off]) else torch.as_tensor(np.asarray(sd[off]))
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(
                f"shape mismatch: checkpoint {off} {tuple(arr.shape)} vs model {key} "
                f"{tuple(t.shape)}; for updateformer.input_transform the checkpoint's "
                "token-feature width differs from the config's input_dim")
        new[key] = arr.to(t.dtype)
        used.add(off)
    unexpected = [f"{k} (model: {from_official_key(k)})" for k in sd
                  if k not in used and not any(s in k for s in SKIPPED_TORCH_KEYS)]
    if missing or unexpected:
        raise KeyError(
            f"cotracker3 checkpoint mismatch: missing={missing[:10]} "
            f"(+{max(0, len(missing) - 10)} more), unexpected={unexpected[:10]} "
            f"(+{max(0, len(unexpected) - 10)} more)")
    model.load_state_dict(new, strict=True)
    return model


def infer_config_from_state_dict(sd: Mapping, base: CoTracker3Config = None) -> CoTracker3Config:
    """A `CoTracker3Config` from the checkpoint's tensor shapes.

    The token-feature width fed to `updateformer.input_transform` is
    2 (vis, conf) + corr_levels * corr_mlp_out + 2 * flow_emb_dim
    + (2 if flow_cat_coords else 0): `corr_mlp_out` comes from
    `corr_mlp.fc2`, and with `corr_levels` at `base`'s value the remainder
    parses one way only (the sincos embedding needs an even channel count
    an axis: remainder % 4 == 2 means the coordinates are appended). Also
    read: the hidden size, the correlation radius (fc1's input is
    (2r+1)^4), the encoder's output width, the virtual tracks, the time and
    space depths and whether there is a vis/conf head. The heads, the
    iterations and the resolution are not in the shapes: they stay `base`'s.
    """
    sd = _normalize_sd(sd)
    base = base or CoTracker3Config()

    hid, width = sd["updateformer.input_transform.weight"].shape
    mlp_hidden, p2 = sd["corr_mlp.fc1.weight"].shape
    mlp_out = sd["corr_mlp.fc2.weight"].shape[0]
    patch = int(round(p2 ** 0.5))          # fc1's input is patch^2
    radius = (int(round(patch ** 0.5)) - 1) // 2
    latent = sd["fnet.conv3.weight"].shape[0]
    n_virtual = sd["updateformer.virual_tracks"].shape[1]

    def depth(prefix):
        idx = {int(m.group(1)) for k in sd
               for m in [re.match(rf"updateformer\.{prefix}\.(\d+)\.", k)] if m}
        return (max(idx) + 1) if idx else 0

    levels = base.corr_levels
    rem = width - 2 - levels * mlp_out
    if rem <= 0 or rem % 2:
        # base's corr_levels does not parse: take the nearest that does
        candidates = [lv for lv in range(1, 9)
                      if (width - 2 - lv * mlp_out) > 0 and (width - 2 - lv * mlp_out) % 2 == 0]
        if not candidates:
            raise ValueError(f"cannot parse input_transform width {width} with corr_mlp_out "
                             f"{mlp_out} for any corr_levels in 1..8")
        levels = min(candidates, key=lambda lv: abs(lv - base.corr_levels))
        rem = width - 2 - levels * mlp_out
    cat_coords = rem % 4 == 2
    flow_emb = (rem - (2 if cat_coords else 0)) // 2
    return dataclasses.replace(
        base, latent_dim=latent, corr_levels=levels, corr_radius=radius,
        corr_mlp_hidden=mlp_hidden, corr_mlp_out=mlp_out, hidden_size=hid,
        num_virtual_tracks=n_virtual, time_depth=depth("time_blocks"),
        space_depth=depth("space_virtual_blocks"), flow_emb_dim=flow_emb,
        flow_cat_coords=cat_coords,
        linear_layer_for_vis_conf="updateformer.vis_conf_head.weight" in sd)


def build_cotracker3_from_state_dict(sd: Mapping, base: CoTracker3Config = None,
                                     device: DeviceLike = None) -> CoTracker3Offline:
    """The checkpoint's model: its config inferred from the shapes, every
    parameter loaded strictly, in eval mode on `device` (the card unless
    `device` asks for the CPU)."""
    dev = resolve_device(device)
    sd = _normalize_sd(sd)
    model = CoTracker3Offline(infer_config_from_state_dict(sd, base=base))
    return load_torch_state_dict(model, sd).to(dev).eval()


def _load_torch_sd(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return sd


def load_cotracker3_checkpoint(model: CoTracker3Offline, path: str) -> CoTracker3Offline:
    """Load a `torch.save`d checkpoint (`scaled_offline.pth`) into `model`."""
    return load_torch_state_dict(model, _load_torch_sd(path))


def build_cotracker3_from_checkpoint(path: str, base: CoTracker3Config = None,
                                     device: DeviceLike = None) -> CoTracker3Offline:
    """`scaled_offline.pth` (or any `torch.save`d state dict in its layout,
    bare or under "model") -> its model, as `build_cotracker3_from_state_dict`."""
    return build_cotracker3_from_state_dict(_load_torch_sd(path), base=base, device=device)
