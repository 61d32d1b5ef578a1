"""The pieces of the benchmark's plain PyTorch reference that its
architectures share (`portbench/reference/archs/`, one module each).
Imports nothing of the program.

A model is a list of parameter specifications (name, shape, init) and a
function of a parameter dict. The names are the reference torch models'
state_dict keys, which the program keeps, so one dict of weights made by
the benchmark loads into both.

BatchNorm in training mode takes the batch's biased variance, as the
program's does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def _mlp_specs(prefix: str, in_features: int, widths, bias: bool = True):
    specs = []
    for i, w in enumerate(widths):
        specs.append((f"{prefix}.conv.{i}.weight", (w, in_features), in_features))
        if bias:
            specs.append((f"{prefix}.conv.{i}.bias", (w,), in_features))
        specs.append((f"{prefix}.batch.{i}.weight", (w,), "ones"))
        specs.append((f"{prefix}.batch.{i}.bias", (w,), "zeros"))
        in_features = w
    return specs


def make_weights(specs, seed: int, device) -> dict[str, torch.Tensor]:
    """Weights from `seed`, made on `device` in one draw: a Linear's weight
    and bias uniform in +-1/sqrt(fan_in) (PyTorch's default), BatchNorm's
    scale 1 and shift 0."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, init in specs if not isinstance(init, str)]
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = ((2.0 * u[at:at + n] - 1.0) / math.sqrt(init)).reshape(shape)
            at += n
    return out


def batch_norm(x: torch.Tensor, weight, bias) -> torch.Tensor:
    """Training-mode BatchNorm over every axis but the last, biased variance."""
    rows = x.reshape(-1, x.shape[-1])
    mean = rows.mean(dim=0)
    var = (rows - mean).square().mean(dim=0)
    y = (rows - mean) * torch.rsqrt(var + BN_EPS) * weight + bias
    return y.reshape(x.shape)


def _mlp(p, prefix: str, x: torch.Tensor, n: int, act=F.relu, bias: bool = True):
    for i in range(n):
        x = F.linear(x, p[f"{prefix}.conv.{i}.weight"],
                     p[f"{prefix}.conv.{i}.bias"] if bias else None)
        x = act(batch_norm(x, p[f"{prefix}.batch.{i}.weight"], p[f"{prefix}.batch.{i}.bias"]))
    return x
