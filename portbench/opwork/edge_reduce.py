"""EdgeConv's gather-reduce: table (B, N, C), idx (B, M, k), sums ->
max, min (B, M, C) in the table's dtype and, with `sums`, the float32
sums s and q over each point's k neighbour rows.

In a training step the forward kernel also writes the max's and the
min's tie counts (1 byte each where k <= 255, else 4), and autograd
launches `edge_reduce_backward_kernel` from its own thread, outside the
forward call's range. It reads the table, the indices, max, min, the
counts and the four gradients (of max and min in the table's dtype, of s
and q in float32) and writes the table's gradient, accumulated in
float32. The operations (forward: max, min, and with the sums an add, a
square and an add; backward: two compares, the two shares of the max's
and the min's gradient, g_s + 2 p g_q and the add into the gradient) lie
far below the bytes' bound.
"""

from portbench.work import nbytes

BACKWARD_KERNELS = ("edge_reduce_backward_kernel",)


def _sizes(args):
    (ts, tsz), (ix, isz), sums = args[0], args[1], args[2]
    B, M, k = ix
    out = B * M * ts[-1]  # elements of one (B, M, C) output
    counts = 1 if k <= 255 else 4
    return ts, tsz, ix, isz, sums, out, counts, k


def work(args):
    ts, tsz, ix, isz, sums, out, counts, k = _sizes(args)
    ops = (5.0 if sums else 2.0) * out * k
    written = out * (2 * tsz + (8 if sums else 0) + 2 * counts)
    return ops, nbytes(ts, tsz) + nbytes(ix, isz) + written


def backward_work(args):
    ts, tsz, ix, isz, sums, out, counts, k = _sizes(args)
    ops = 9.0 * out * k
    read = out * (2 * tsz + 2 * counts + 2 * tsz + (8 if sums else 0))
    return ops, nbytes(ts, tsz) + nbytes(ix, isz) + read + nbytes(ts, 4)
