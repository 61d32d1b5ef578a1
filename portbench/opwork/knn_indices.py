"""kNN: x (B, N, F), k -> (B, N, k) int32 indices; the Gram products."""

from portbench.work import nbytes


def work(args):
    (xs, xsz), k = args[0], args[1]
    B, N, F = xs
    return 2.0 * B * N * N * F, nbytes(xs, xsz) + 4 * B * N * k
