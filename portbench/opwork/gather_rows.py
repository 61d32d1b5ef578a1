"""Row gather: table (B, N, D), idx (B, ...) -> (B, ..., D)."""

import math

from portbench.work import nbytes


def work(args):
    (ts, tsz), (ix, isz) = args[0], args[1]
    out = math.prod(ix) * ts[-1] * tsz
    return 0.0, nbytes(ts, tsz) + nbytes(ix, isz) + out
