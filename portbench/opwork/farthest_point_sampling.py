"""FPS: coords (B, N, 3), C -> (B, C) indices; nine operations a point a
round."""

from portbench.work import nbytes


def work(args):
    (shape, size), C = args[0], args[1]
    B, N, _ = shape
    return 9.0 * B * C * N, nbytes(shape, size) + 4 * B + 4 * B * C
