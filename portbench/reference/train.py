"""The reference's training steps: masked cross-entropy and Adam in plain
PyTorch, float32 with TF32 off.

`reference_steps` follows the program's first steps from the same
weights, batches and random streams: the FPS starts from a generator
seeded as the program's train state seeds its own, the dropout masks
from torch's default generator seeded as the benchmark seeds it before
the program's first step (the same draws, in the same order and shapes,
give the same masks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.models import ARCHS

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def masked_cross_entropy(logits: torch.Tensor, onehot: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over each sample's first `lengths` points."""
    logp = F.log_softmax(logits.float(), dim=-1)
    token = -(onehot.float() * logp).sum(dim=-1)
    valid = (torch.arange(logits.shape[1], device=logits.device)[None, :]
             < lengths.long()[:, None]).float()
    total = valid.sum()
    loss = (token * valid).sum() / total.clamp_min(1.0)
    return torch.where(total > 0, loss, torch.zeros_like(loss))


def reference_steps(arch: str, weights: dict[str, torch.Tensor], batches, *, fps_seed: int,
                    dropout_seed: int, lr: float, device, model_kwargs: dict | None = None):
    """Runs len(batches) Adam steps of `arch` from `weights`.

    Returns {"losses": [float], "logits": first step's logits (CPU),
    "grads": first step's gradient per leaf (CPU), "params": the
    parameters after the last step (CPU)}."""
    forward = ARCHS[arch][1]
    kwargs = model_kwargs or {}
    names = list(weights)
    params = [weights[n].detach().to(device).clone().requires_grad_(True) for n in names]
    m = [torch.zeros_like(q) for q in params]
    v = [torch.zeros_like(q) for q in params]
    gen = torch.Generator(device=device)
    gen.manual_seed(fps_seed)
    torch.manual_seed(dropout_seed)
    out = {"losses": []}
    for t, (pts, onehot, lengths) in enumerate(batches, start=1):
        pts, onehot, lengths = (torch.as_tensor(a).to(device) for a in (pts, onehot, lengths))
        logits = forward(dict(zip(names, params)), pts, gen, **kwargs)
        loss = masked_cross_entropy(logits, onehot, lengths)
        grads = torch.autograd.grad(loss, params)
        out["losses"].append(float(loss.detach()))
        if t == 1:
            out["logits"] = logits.detach().cpu()
            out["grads"] = {n: g.detach().cpu() for n, g in zip(names, grads)}
        b1, b2 = ADAM_BETAS
        with torch.no_grad():
            for q, g, mq, vq in zip(params, grads, m, v):
                mq.mul_(b1).add_(g, alpha=1 - b1)
                vq.mul_(b2).addcmul_(g, g, value=1 - b2)
                step = mq / (1 - b1 ** t)
                denom = (vq / (1 - b2 ** t)).sqrt() + ADAM_EPS
                q.sub_(lr * step / denom)
        del logits, loss, grads
    out["params"] = {n: q.detach().cpu() for n, q in zip(names, params)}
    return out
