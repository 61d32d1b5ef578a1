"""Row gathers: batched (`gather_rows`) and over one flat table
(`gather_rows_flat`).

`gather_rows` and `gather_rows_with_coords` are ported from
`pointseg/ops/gather.py`. On a CUDA tensor the forward is one launch of
`csrc/gather.cu` (the counterpart of the JAX package's forward-only
`gather_rows_dma`); on a CPU tensor it is `gather_rows_plain`
(`torch.gather`). The backward is a scatter-add (`index_add_` into a
zero table) on both, as the JAX package's is a product outside any
kernel. On the card `index_add_` adds with atomics, so gradients there
are not bit-reproducible from run to run. The JAX package's one-hot
matrix-unit strategies and its bf16 coordinate packing exist for the TPU
and are not ported. Indices are selections and carry no gradient.

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


def _gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B, N, C = table.shape
    table = table.contiguous()
    flat = idx.reshape(B, -1).to(torch.int32).contiguous()
    M = flat.shape[1]
    _kernels.check(table, "table", torch.float32, (B, N, C))
    _kernels.check(flat, "idx", torch.int32, (B, M))
    if table.device != flat.device:
        raise ValueError("table and idx must be on the same device")
    if B > MAX_B:
        raise ValueError(f"the CUDA gather takes B <= {MAX_B} (a grid dimension), got {B}")
    out = torch.empty((B, M, C), dtype=table.dtype, device=table.device)
    if out.numel():
        _kernels.launch("gather_rows", "pointseg_gather_rows", table.device,
                        _kernels.ptr(table), _kernels.ptr(flat), _kernels.ptr(out), B, N, M, C)
    return out.reshape(*idx.shape, C)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        if _kernels.on_cuda(table):
            return _gather_rows_cuda(table, idx)
        return gather_rows_plain(table, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        B, N, C = ctx.table_shape
        offsets = torch.arange(B, device=idx.device, dtype=torch.long) * N
        rows = (idx.reshape(B, -1).long() + offsets[:, None]).reshape(-1)
        out = torch.zeros((B * N, C), dtype=grad.dtype, device=grad.device)
        out.index_add_(0, rows, grad.reshape(-1, C))
        return out.reshape(B, N, C), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gathers rows of a batched table by integer indices.

    Args:
        table: (B, N, C) rows; float32 on a CUDA device.
        idx: (B, ...) integer indices into N, any trailing shape.

    Returns:
        (B, *idx.shape[1:], C); differentiable in `table`.
    """
    return _GatherRows.apply(table, idx)


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

    One gather over the concatenated (features, coords) table when the
    dtypes agree, two otherwise. Coordinates are selection geometry and
    are detached, as in the JAX package; `features` stays differentiable.

    Returns:
        ((B, *idx.shape[1:], H), (B, *idx.shape[1:], 3)).
    """
    coords = coords.detach()
    h = features.shape[-1]
    if features.dtype == coords.dtype:
        rows = gather_rows(torch.cat([features, coords], dim=-1), idx)
        return rows[..., :h], rows[..., h:]
    return gather_rows(features, idx), gather_rows(coords, idx)
