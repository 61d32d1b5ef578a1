"""EdgeConv's gather-reduce: over each point's k neighbour rows of a
per-point table, plus an optional per-point offset, the max, the min
and, in training, the sum and the sum of squares.

`edge_reduce_plain` is the composition that the fused EdgeConv of the
JAX package (`pointseg/nn/blocks.py::EdgeConv`) computes: `gather_rows`
into (B, M, k, C), then `amax`, `amin` and the two sums over k (in
float32 or wider). On a CUDA float32 or bfloat16 table `edge_reduce` is
one launch of `csrc/edgereduce.cu` instead, which never forms the
gathered rows, with a backward of its own (a second kernel) that never
forms their gradient either: ties of the max or the min share its
gradient evenly, as autograd's `amax` backward and `jnp.max`'s do, and
the gradient is added with atomics in float32 and cast once to the
table's dtype, as kernel 7's scatter-add does, so it is not
bit-reproducible from run to run. The forward saves the table, the
indices, the max, the min and their tie counts (1 byte each where k <=
255), nothing of size (B, M, k, C).

The table may have more rows than there are query points: `idx` (B, M,
k) indexes N rows (the point-sharded forward's rank rows against the
gathered table). A CPU table, a table of any other dtype and a call
while `torch.export` traces take the plain composition (whose gather is
kernel 7 on the card, or the `pointseg_torch::gather_rows` operator in
an exported graph); `launches` says which a table takes.

The offset d (B, M, C), one row per query point, makes the rows reduced
x_ij = p[idx_ij] + d_i, rounded to the table's dtype as the
composition's add rounds it: the kernels add it as they read each row,
so max, min, tie counts and sums are over x itself. Its gradient is
(B, M, C) and needs no kernel: g_max + g_min + k g_s + 2 g_q s
(`offset_grad`). PointNeXt's InvResMLP grouped layer reduces through it
(`nn/blocks.py::GroupedFirstLayer.pool`); EdgeConv passes none.

`LAUNCHES["edge_reduce"]` counts both kernels: 4 + 4 a DGCNN training
step, 15 + 15 a PointNeXt-XL one (15 a forward).
"""

from __future__ import annotations

import torch

from pointseg_torch.ops import _kernels
from pointseg_torch.ops.gather import gather_rows

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's table dtypes


def edge_reduce_plain(p_table: torch.Tensor, idx: torch.Tensor, sums: bool,
                      offset: torch.Tensor | None = None):
    """Plain PyTorch `edge_reduce`: the gathered rows (plus the offset)
    and four reductions."""
    gp = gather_rows(p_table, idx)  # (B, M, k, C)
    if offset is not None:
        gp = gp + offset[:, :, None, :]
    out = (gp.amax(dim=2), gp.amin(dim=2))
    if sums:  # in float32 (or wider)
        g = gp.to(torch.promote_types(gp.dtype, torch.float32))
        out += (g.sum(dim=2), (g * g).sum(dim=2))
    return out


def launches(p_table: torch.Tensor) -> bool:
    """Whether `edge_reduce` on `p_table` runs the kernel pair: a CUDA
    float32 or bfloat16 table, outside `torch.export`'s tracing."""
    return (not torch.compiler.is_exporting() and _kernels.on_cuda(p_table)
            and p_table.dtype in _DTYPE_CODE)


def offset_grad(g_max, g_min, g_s, g_q, s, k: int) -> torch.Tensor:
    """The offset's gradient, (B, M, C): every row of a point holds the
    offset once, so it gets the max's and the min's whole gradient and,
    with sums, k g_s + 2 g_q s (d/dd of sum x and of sum x^2)."""
    acc = torch.promote_types(g_max.dtype, torch.float32)
    grad = g_max.to(acc) + g_min.to(acc)
    if g_s is not None:
        grad = grad + k * g_s + 2.0 * g_q * s
    return grad


def count_dtype(k: int) -> torch.dtype:
    """The dtype of the kernel's tie counts for k neighbours."""
    return torch.uint8 if k <= 255 else torch.int32


def _check(p_table: torch.Tensor, idx: torch.Tensor, offset: torch.Tensor | None = None):
    if (p_table.dim() != 3 or idx.dim() != 3 or idx.shape[0] != p_table.shape[0]
            or idx.shape[2] < 1 or idx.is_floating_point() or idx.dtype == torch.bool):
        raise ValueError(f"edge_reduce: need a (B, N, C) table and (B, M, k >= 1) integer "
                         f"indices, got {tuple(p_table.shape)} and {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if offset is not None and (
            offset.shape != (*idx.shape[:2], p_table.shape[2]) or offset.dtype != p_table.dtype
            or offset.device != p_table.device):
        raise ValueError(f"edge_reduce: the offset must be (B, M, C) = "
                         f"{(*idx.shape[:2], p_table.shape[2])} of the table's dtype and "
                         f"device, got {offset.dtype} {tuple(offset.shape)} on {offset.device}")
    if idx.device != p_table.device:
        raise ValueError(f"table is on {p_table.device}, idx on {idx.device}")
    if not p_table.is_cuda:
        raise ValueError(f"the CUDA edge_reduce takes tensors on the card, got {p_table.device}")
    if p_table.dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA edge_reduce takes {tuple(_DTYPE_CODE)} rows, got "
                         f"{p_table.dtype}")


def _edge_reduce_cuda(p_table: torch.Tensor, idx: torch.Tensor, sums: bool, counts: bool,
                      offset: torch.Tensor | None = None):
    """One launch of the forward kernel on a contiguous table (and
    offset) and contiguous int32 indices: (max, min, s, q, count_max,
    count_min), None for what `sums` and `counts` leave out."""
    _check(p_table, idx, offset)
    if (not p_table.is_contiguous() or idx.dtype != torch.int32 or not idx.is_contiguous()
            or (offset is not None and not offset.is_contiguous())):
        raise ValueError("edge_reduce's kernel takes a contiguous table and offset and "
                         "contiguous int32 indices")
    B, N, C = p_table.shape
    M, k = idx.shape[1], idx.shape[2]
    vmax, vmin = p_table.new_empty((B, M, C)), p_table.new_empty((B, M, C))
    s = q = cmax = cmin = None
    if sums:
        s = p_table.new_empty((B, M, C), dtype=torch.float32)
        q = torch.empty_like(s)
    if counts:
        cmax = p_table.new_empty((B, M, C), dtype=count_dtype(k))
        cmin = torch.empty_like(cmax)
    if vmax.numel():
        ptr = _kernels.ptr
        _kernels.launch("edge_reduce", "pointseg_edge_reduce", p_table.device,
                        p_table.data_ptr(), idx.data_ptr(), ptr(offset), vmax.data_ptr(),
                        vmin.data_ptr(), ptr(s), ptr(q), ptr(cmax), ptr(cmin), B, M, N, k, C,
                        _DTYPE_CODE[p_table.dtype])
    return vmax, vmin, s, q, cmax, cmin


def _edge_reduce_backward_cuda(p_table, idx, vmax, vmin, cmax, cmin, g_max, g_min, g_s, g_q,
                               offset=None):
    """One launch of the backward kernel into a zeroed float32 gradient,
    cast once to the table's dtype. `g_s` and `g_q` are None without sums;
    `offset` is the forward's."""
    B, N, C = p_table.shape
    M, k = idx.shape[1], idx.shape[2]
    grad = torch.zeros((B, N, C), dtype=torch.float32, device=p_table.device)
    g_max, g_min = g_max.contiguous(), g_min.contiguous()
    if g_s is not None:
        g_s, g_q = g_s.contiguous(), g_q.contiguous()
    if vmax.numel():
        ptr = _kernels.ptr
        _kernels.launch("edge_reduce", "pointseg_edge_reduce_backward", p_table.device,
                        p_table.data_ptr(), idx.data_ptr(), ptr(offset), vmax.data_ptr(),
                        vmin.data_ptr(), cmax.data_ptr(), cmin.data_ptr(), g_max.data_ptr(),
                        g_min.data_ptr(), ptr(g_s), ptr(g_q), grad.data_ptr(), B, M, N, k, C,
                        _DTYPE_CODE[p_table.dtype])
    return grad.to(p_table.dtype)


class _EdgeReduce(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient in
    `p_table` and `offset_grad` as the offset's; the indices carry none."""

    @staticmethod
    def forward(ctx, p_table, idx, sums, offset):
        vmax, vmin, s, q, cmax, cmin = _edge_reduce_cuda(p_table, idx, sums, True, offset)
        ctx.save_for_backward(p_table, idx, vmax, vmin, cmax, cmin, offset,
                              s if offset is not None else None)
        return (vmax, vmin, s, q) if sums else (vmax, vmin)

    @staticmethod
    def backward(ctx, g_max, g_min, g_s=None, g_q=None):
        p_table, idx, vmax, vmin, cmax, cmin, offset, s = ctx.saved_tensors
        grad = _edge_reduce_backward_cuda(p_table, idx, vmax, vmin, cmax, cmin,
                                          g_max, g_min, g_s, g_q, offset)
        g_offset = None
        if offset is not None and ctx.needs_input_grad[3]:
            g_offset = offset_grad(g_max, g_min, g_s, g_q, s, idx.shape[2]).to(offset.dtype)
        return grad, None, None, g_offset


def edge_reduce(p_table: torch.Tensor, idx: torch.Tensor, sums: bool,
                offset: torch.Tensor | None = None):
    """Max and min over each point's neighbour rows (plus its offset)
    and, with `sums`, their sum and sum of squares.

    Args:
        p_table: (B, N, C) per-point rows.
        idx: (B, M, k) integer indices into N; int32 goes to the kernel
            as it is, any other integer type is converted once.
        sums: also return s and q (the training statistics' sums).
        offset: None, or (B, M, C) rows of the table's dtype, one added
            to every neighbour row of its point before the reductions.

    Returns:
        (max, min) or (max, min, s, q), each (B, M, C): max and min in
        the table's dtype, s and q in float32 (or wider); differentiable
        in `p_table` and `offset`.
    """
    if not launches(p_table):
        return edge_reduce_plain(p_table, idx, sums, offset)
    _check(p_table, idx, offset)
    # what the kNN kernels return passes as it is; anything else is converted once
    p_table, idx = p_table.contiguous(), idx.to(torch.int32).contiguous()
    if offset is not None:
        offset = offset.contiguous()
    grads = p_table.requires_grad or (offset is not None and offset.requires_grad)
    if grads and torch.is_grad_enabled():
        return _EdgeReduce.apply(p_table, idx, sums, offset)
    vmax, vmin, s, q, _, _ = _edge_reduce_cuda(p_table, idx, sums, False, offset)
    return (vmax, vmin, s, q) if sums else (vmax, vmin)
