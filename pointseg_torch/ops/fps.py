"""Farthest point sampling (FPS).

Port of `pointseg/ops/fps.py`. The start index comes from an explicit
`torch.Generator` (training) or is 0 (evaluation), as the JAX package
draws it from the flax 'fps' stream or uses 0. On a CUDA tensor the
whole C-step loop is one launch of `csrc/fps.cu`; on a CPU tensor the
plain PyTorch loop below runs.

Selection is not differentiable: coordinates are detached before either
version sees them.
"""

from __future__ import annotations

import torch

from pointseg_torch.ops import _kernels


def farthest_point_sampling(
    coords: torch.Tensor,
    num_samples: int,
    *,
    generator: torch.Generator | None = None,
    start_indices: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Iteratively selects `num_samples` mutually-far points per cloud.

    Args:
        coords: (B, N, 3) point coordinates.
        num_samples: number of points C to select.
        generator: draws a random start per cloud, uniform over N. With
            neither `generator` nor `start_indices` the start is 0 (or
            the first valid point under `mask`).
        start_indices: optional (B,) explicit start indices; overrides
            `generator`.
        mask: optional (B, N) bool; False points are never selected
            while at least `num_samples` valid points exist.

    Returns:
        (B, C) int32 indices of the sampled points.
    """
    B, N, _ = coords.shape
    C = int(num_samples)
    device = coords.device
    if start_indices is not None:
        start = start_indices.to(device=device, dtype=torch.int32)
    elif generator is not None:
        start = torch.randint(0, N, (B,), generator=generator,
                              device=generator.device).to(device, torch.int32)
        if mask is not None:
            # an excluded draw becomes the cloud's first valid point
            first_valid = mask.int().argmax(dim=1).to(torch.int32)
            drawn_valid = mask.gather(1, start[:, None].long())[:, 0]
            start = torch.where(drawn_valid, start, first_valid)
    elif mask is not None:
        start = mask.int().argmax(dim=1).to(torch.int32)
    else:
        start = torch.zeros((B,), dtype=torch.int32, device=device)

    coords = coords.detach().to(torch.float32).contiguous()
    if mask is not None:
        mask = mask.to(device=device, dtype=torch.bool).contiguous()
    if _kernels.on_cuda(coords):
        return _fps_cuda(coords, C, start.contiguous(), mask)
    return farthest_point_sampling_plain(coords, C, start, mask)


def farthest_point_sampling_plain(
    coords: torch.Tensor,
    num_samples: int,
    start: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch FPS: the JAX oracle's loop, op for op.

    Distances are in difference form, summed as (dx*dx + dy*dy) + dz*dz
    with every operation rounded on its own (eager PyTorch fuses
    nothing), so the result is bit-identical to the CUDA kernel's.
    `torch.argmax` returns the first maximal index, so ties go to the
    lowest index, as in the kernel and in JAX.
    """
    B, N, _ = coords.shape
    x, y, z = coords.float().unbind(-1)  # (B, N) each
    dist = torch.full((B, N), float("inf"), device=coords.device)
    if mask is not None:
        dist = torch.where(mask, dist, float("-inf"))
    out = torch.empty((B, num_samples), dtype=torch.int32, device=coords.device)
    far = start.long()[:, None]  # (B, 1)
    for i in range(num_samples):
        out[:, i] = far[:, 0]
        if i == num_samples - 1:
            break
        dx = x - x.gather(1, far)
        dy = y - y.gather(1, far)
        dz = z - z.gather(1, far)
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = dist.argmax(dim=1, keepdim=True)
    return out


def _fps_cuda(coords, num_samples, start, mask):
    B, N, _ = coords.shape
    _kernels.check(coords, "coords", torch.float32, (B, N, 3))
    _kernels.check(start, "start_indices", torch.int32, (B,))
    if mask is not None:
        _kernels.check(mask, "mask", torch.bool, (B, N))
    out = torch.empty((B, num_samples), dtype=torch.int32, device=coords.device)
    if B == 0 or N == 0 or num_samples == 0:
        return out
    # distance buffer for clouds too large for shared memory (see fps.cu)
    scratch = torch.empty((B, N), dtype=torch.float32, device=coords.device)
    _kernels.launch(
        "fps", "pointseg_fps", coords.device,
        _kernels.ptr(coords), _kernels.ptr(start), _kernels.ptr(mask),
        _kernels.ptr(out), _kernels.ptr(scratch), B, N, num_samples,
    )
    return out


def sample(
    coords: torch.Tensor,
    num_samples: int,
    *,
    generator: torch.Generator | None = None,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Returns the sampled coordinates (B, C, 3) rather than indices."""
    from pointseg_torch.ops.gather import gather_rows

    idx = farthest_point_sampling(coords, num_samples, generator=generator, mask=mask)
    return gather_rows(coords, idx)
