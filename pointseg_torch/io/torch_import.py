"""Reference PyTorch checkpoints into the port's models (counterpart of
`pointseg/io/torch_import.py`, which converts them into the JAX models).

The reference saves `model.state_dict()` to `.pt` files. The port keeps
its key layout everywhere but in the DGCNNs, so a reference state_dict
becomes a port one by two conversions:

- shapes: the reference's 1x1 Conv1d / Conv2d weights (out, in, 1[, 1])
  are the port's Linear weights (out, in), their trailing ones dropped;
- the DGCNNs' keys: the reference's EdgeConv is Sequential(Conv2d(2F ->
  out), BatchNorm2d, LeakyReLU) over cat(x_j - x_i, x_i); its weight
  W = [W_a | W_b] splits into the port's `w_edge` = W_a and `w_center` =
  W_b (an identity split: the port keeps the reference's parameter
  coordinates), its BatchNorm is the port's `bn`; the Sequential(Conv1d,
  BatchNorm1d, act) of `color_conv` and conv5-7 are the port's
  SharedMLP `conv.0` / `batch.0`.

Every other key passes as it is; `load_state_dict(strict=True)` then
names whatever is missing, left over or of another shape.
"""

from __future__ import annotations

from typing import Mapping

import torch

DGCNN_NAMES = ("DGCNN", "DeepGraphCnn")


def _dgcnn_keys(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    out = {}
    for key, value in state_dict.items():
        head, _, rest = key.partition(".")
        if head in ("conv1", "conv2", "conv3", "conv4") and rest == "conv.0.weight":
            w = value.reshape(value.shape[0], value.shape[1])  # (out, 2F)
            half = w.shape[1] // 2
            out[f"{head}.w_edge.weight"] = w[:, :half].contiguous()
            out[f"{head}.w_center.weight"] = w[:, half:].contiguous()
        elif head in ("conv1", "conv2", "conv3", "conv4") and rest.startswith("conv.1."):
            out[f"{head}.bn.{rest[len('conv.1.'):]}"] = value
        elif head in ("color_conv", "conv5", "conv6", "conv7") and rest.startswith("0."):
            out[f"{head}.conv.0.{rest[2:]}"] = value
        elif head in ("color_conv", "conv5", "conv6", "conv7") and rest.startswith("1."):
            out[f"{head}.batch.0.{rest[2:]}"] = value
        else:
            out[key] = value
    return out


def from_reference_state_dict(model_name: str, state_dict: Mapping[str, torch.Tensor],
                              model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The reference state_dict of `model_name` as a state_dict of
    `model` (the port's model of that name): the DGCNNs' keys renamed and
    split, 1x1 convolution weights reshaped to the port's Linear shapes."""
    sd = _dgcnn_keys(state_dict) if model_name in DGCNN_NAMES else dict(state_dict)
    target = model.state_dict()
    for key, value in sd.items():
        want = target.get(key)
        if (want is not None and value.dim() > want.dim() and value.shape[:want.dim()]
                == want.shape and all(s == 1 for s in value.shape[want.dim():])):
            sd[key] = value.reshape(want.shape)
    return sd
