"""Row gathers: batched (`gather_rows`, `gather_rows_with_coords`) and
over one flat table (`gather_rows_flat`).

`gather_rows` and `gather_rows_with_coords` are ported from
`pointseg/ops/gather.py`. On a CUDA tensor the forward is one launch of
`csrc/gather.cu` (the counterpart of the JAX package's forward-only
`gather_rows_dma`), rows of any dtype; on a CPU tensor it is
`gather_rows_plain` (`torch.gather`). `gather_rows_with_coords` gathers
the feature rows and the coordinate rows of SetAbstraction grouping with
one set of indices: one launch on the card that writes both outputs,
where the JAX package gathers from the concatenation of the two tables
(a TPU measure: a separate 12-byte-row gather was slow there, and on this
card the concatenation costs a copy of the table a call). The backward
is a scatter-add (`index_add_` into a zero table) on both devices, as the
JAX package's is a product outside any kernel; coordinates get none. On
the card `index_add_` adds with atomics, so gradients there are not
bit-reproducible from run to run. A table that needs no gradient, or a
call under `torch.no_grad()`, goes to the launch without an autograd
node. The JAX package's one-hot matrix-unit strategies and its bf16
coordinate packing exist for the TPU and are not ported. Indices are
selections and carry no gradient.

`gather_rows_flat(table, idx)` is the counterpart of
`pointseg/ops/pallas/gather.py::gather_rows_flat`: rows of one table of
R rows by absolute row index, forward only, any dtype, rows of any byte
width. The device-resident block store samples its batches with it. On a
CUDA tensor it is one launch of the second kernel in `csrc/gather.cu`;
on a CPU tensor `gather_rows_flat_plain` (`index_select`).

An index outside the table is an error on both devices: the CPU version
raises, and the kernel, which cannot be checked from the host without a
synchronisation, never reads out of bounds but traps, so the next
synchronisation raises a CUDA error.
"""

from __future__ import annotations

import torch

from pointseg_torch.ops import _kernels

MAX_B = 65535  # the batch is the kernel's second grid dimension


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch `gather_rows` (`torch.gather`); any dtype."""
    B, _, C = table.shape
    flat = idx.reshape(B, -1).long()
    rows = torch.gather(table, 1, flat[..., None].expand(-1, -1, C))
    return rows.reshape(*idx.shape, C)


def _check_batched(table: torch.Tensor, idx: torch.Tensor, coords: torch.Tensor | None) -> None:
    if (table.dim() != 3 or idx.dim() < 1 or idx.shape[0] != table.shape[0]
            or idx.is_floating_point() or idx.dtype == torch.bool):
        raise ValueError(f"gather_rows: need a (B, N, C) table and (B, ...) integer indices, "
                         f"got {tuple(table.shape)} and {idx.dtype} {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"table is on {table.device}, idx on {idx.device}")
    if table.shape[0] > MAX_B:
        raise ValueError(f"the CUDA gather takes B <= {MAX_B} (a grid dimension), "
                         f"got {table.shape[0]}")
    if coords is not None and (coords.dim() != 3 or coords.shape[:2] != table.shape[:2]
                               or coords.device != table.device):
        raise ValueError(f"coords {tuple(coords.shape)} on {coords.device} do not pair with "
                         f"the table {tuple(table.shape)} on {table.device}")


def _gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor,
                      coords: torch.Tensor | None = None):
    """One launch of the batched kernel: the rows of `table` at `idx` and,
    with `coords`, the rows of `coords` at the same indices into a second
    output. A call at the PointNet++ family's shapes is host time beside a
    kernel of microseconds, so nothing here is done twice: an int32
    contiguous `idx` (what ball query and kNN return) passes as it is, a
    table is copied only when it is not contiguous, and each row's byte
    width comes from the shape."""
    _check_batched(table, idx, coords)
    if not table.is_contiguous():
        table = table.contiguous()
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        idx = idx.to(torch.int32).contiguous()
    B, N, width = table.shape
    out = table.new_empty((*idx.shape, width))
    out2, row_bytes2 = None, 0
    if coords is not None:
        if not coords.is_contiguous():
            coords = coords.contiguous()
        out2 = coords.new_empty((*idx.shape, coords.shape[2]))
        row_bytes2 = coords.shape[2] * coords.element_size()
    if idx.numel():
        _kernels.launch("gather_rows", "pointseg_gather_rows", table.device,
                        table.data_ptr(), _kernels.ptr(coords), idx.data_ptr(), out.data_ptr(),
                        _kernels.ptr(out2), B, N, idx.numel() // B,
                        width * table.element_size(), row_bytes2)
    return out if coords is None else (out, out2)


def _gather(table: torch.Tensor, idx: torch.Tensor, coords: torch.Tensor | None):
    """The forward on the tensors' device, with no autograd node."""
    if _kernels.on_cuda(table):
        return _gather_rows_cuda(table, idx, coords)
    rows = gather_rows_plain(table, idx)
    return rows if coords is None else (rows, gather_rows_plain(coords, idx))


class _GatherRows(torch.autograd.Function):
    """`_gather` with the scatter-add backward into `table`; `coords`
    (None or a detached table) come back without a gradient."""

    @staticmethod
    def forward(ctx, table, idx, coords):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        out = _gather(table, idx, coords)
        if coords is not None:
            ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, grad, *_):
        (idx,) = ctx.saved_tensors
        B, N, C = ctx.table_shape
        offsets = torch.arange(B, device=idx.device, dtype=torch.long) * N
        rows = (idx.reshape(B, -1).long() + offsets[:, None]).reshape(-1)
        out = torch.zeros((B * N, C), dtype=grad.dtype, device=grad.device)
        out.index_add_(0, rows, grad.reshape(-1, C))
        return out.reshape(B, N, C), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gathers rows of a batched table by integer indices.

    Args:
        table: (B, N, C) rows of any dtype.
        idx: (B, ...) integer indices into N, any trailing shape; int32
            goes to the kernel as it is, any other integer type is
            converted once.

    Returns:
        (B, *idx.shape[1:], C); differentiable in `table`.
    """
    if table.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(table, idx, None)
    return _gather(table, idx, None)


def gather_rows_flat_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch `gather_rows_flat` (`index_select`); raises on an
    index outside [0, R)."""
    return table.detach().index_select(0, idx.to(torch.int64))


def _gather_rows_flat_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One launch of the flat kernel. A call is all host time beside a
    kernel of a few microseconds, so nothing here is done twice: an int64
    contiguous `idx` is passed as it is, and the row's byte width comes
    from the output's first stride."""
    if idx.device != table.device:
        raise ValueError(f"table is on {table.device}, idx on {idx.device}")
    if not table.is_contiguous():
        raise ValueError("gather_rows_flat: the table must be contiguous "
                         "(a copy of a table of gigabytes is not made silently)")
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        idx = idx.to(torch.int64).contiguous()
    shape = table.shape
    # `new_empty` takes dtype and device from the table: a third less host
    # time than `torch.empty` with both spelt out
    out = table.new_empty((idx.shape[0], *shape[1:]))
    if out.numel():
        # the first stride of a fresh tensor is its row's element count (the
        # table's own may be anything when it has a single row)
        row_bytes = out.stride(0) * out.element_size()
        _kernels.launch("gather_rows_flat", "pointseg_gather_rows_flat", table.device,
                        table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                        shape[0], idx.shape[0], row_bytes)
    return out


def gather_rows_flat(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of one flat table by absolute row index, forward only.

    Args:
        table: (R, ...) rows of any dtype and width (1-byte labels,
            16-byte packed words, nine floats); contiguous on a CUDA device.
        idx: (Mrows,) integer row indices in [0, R). The kernel reads
            int64 (a table may hold more than 2^31 rows); any other
            integer type is converted once, here.

    Returns:
        (Mrows, ...) rows, detached from `table`'s graph (the JAX
        function stops gradients likewise).
    """
    dtype = idx.dtype
    if idx.dim() != 1 or (dtype != torch.int64 and (idx.is_floating_point()
                                                    or dtype == torch.bool)):
        raise ValueError(f"idx must be a 1-D integer tensor, got {idx.dtype} {tuple(idx.shape)}")
    if table.dim() < 1:
        raise ValueError("table needs a row dimension")
    if _kernels.on_cuda(table):
        return _gather_rows_flat_cuda(table, idx)
    return gather_rows_flat_plain(table, idx)


def gather_rows_with_coords(
    features: torch.Tensor, coords: torch.Tensor, idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gathers feature rows and coordinate rows with the same indices.

    One launch on the card, which writes both outputs, whatever the two
    dtypes; two `torch.gather`s on the CPU. Both outputs are contiguous.
    Coordinates are selection geometry and are detached, as in the JAX
    package; `features` stays differentiable.

    Returns:
        ((B, *idx.shape[1:], H), (B, *idx.shape[1:], 3)).
    """
    coords = coords.detach()
    if features.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(features, idx, coords)
    return _gather(features, idx, coords)
