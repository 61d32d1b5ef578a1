"""Ahead-of-time export of a model's eval-mode forward for serving (port
of `pointseg/io/export_aot.py`; `torch.export` in place of `jax.export`).

- `export_forward` traces `forward(state_dict, points) -> logits`, the
  eval-mode model run by `torch.func.functional_call` on the weights it
  is given, and serialises it with `torch.export.save`. The weights are
  runtime arguments, as in the JAX package: the artifact holds no tensor
  (its example inputs are dropped before saving), is a few hundred KB,
  and pairs with any checkpoint of the same architecture and shapes.
- `load_forward` reads it back into `f(state_dict, points) -> logits`.
  A state_dict or points of another shape are refused by the program's
  input guards.

Differences from the JAX package:

- The port's kernels are operators in the traced graph
  (`pointseg_torch/ops/library.py`: `pointseg_torch::fps`, `ball_query`,
  `three_nn`, `knn`, `gather_rows`, ...), so the artifact launches the
  same CUDA kernels as the eager model, and FPS is one node, not its
  loop unrolled. Serving therefore needs `torch` and `pointseg_torch.ops`
  (imported here, it registers the operators and builds the kernels at
  their first launch on a card); a JAX artifact needs only `jax`.
- One artifact is for one device: the device of the trace (`cuda` or
  `cpu`), where a StableHLO artifact may be lowered for several
  platforms at once.
- As in JAX, the traced path is frozen at export: the model's `filler`
  and `static_graph` and its compute dtype are the ones it was built
  with, and each selection's operator is the one the shape rule picks at
  the traced shape (`pointseg_torch::knn_2l` past the flat kNN kernel's
  k = 32, `ball_query_2l` past its K = 32). Static shapes only: export one
  artifact per serving bucket.
"""

from __future__ import annotations

import io
from typing import Callable

import torch
from torch import nn

import pointseg_torch.ops  # noqa: F401  (registers the kernels' operators)


class _Forward(nn.Module):
    """forward(state_dict, points) -> the eval-mode model's logits on
    those weights. The model is kept out of the module tree, so that the
    exported program owns no parameter or buffer of its own."""

    def __init__(self, model: nn.Module):
        super().__init__()
        object.__setattr__(self, "model", model)

    def forward(self, state: dict[str, torch.Tensor], points: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.model, state, (points,))


def export_forward(model: nn.Module, example_points: torch.Tensor,
                   device: torch.device | str | None = None) -> bytes:
    """Serialises `model`'s eval-mode forward at the shape and dtype of
    `example_points` (B, N, F) for `device` (default: the model's), with
    its state_dict as a runtime argument. Puts `model` in eval mode."""
    model.eval()
    if device is None:
        device = next(model.parameters()).device
    device = torch.device(device)
    state = _sorted({k: v.detach().to(device) for k, v in model.state_dict().items()})
    points = example_points.to(device)
    with torch.no_grad():
        program = torch.export.export(_Forward(model), (state, points), strict=False)
    program.example_inputs = None  # the weights travel with each call, not in the artifact
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    return buffer.getvalue()


def load_forward(blob: bytes) -> Callable[[dict, torch.Tensor], torch.Tensor]:
    """`export_forward` bytes -> `f(state_dict, points) -> logits`, run on
    the device the artifact was exported for (the tensors must be
    there)."""
    module = torch.export.load(io.BytesIO(blob)).module()

    def forward(state_dict: dict, points: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(_sorted(state_dict), points)

    return forward


def _sorted(state: dict) -> dict:
    """The state_dict in key order: the program takes its tensors by
    position, so both sides fix one order."""
    return {k: state[k] for k in sorted(state)}
