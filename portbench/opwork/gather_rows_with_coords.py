"""Row gather of features and coordinates in one call: table (B, N, D),
coords (B, N, 3), idx (B, ...) -> (B, ..., D) and (B, ..., 3)."""

import math

from portbench.work import nbytes


def work(args):
    (ts, tsz), (cs, csz), (ix, isz) = args[0], args[1], args[2]
    rows = math.prod(ix)
    return 0.0, (nbytes(ts, tsz) + nbytes(cs, csz) + nbytes(ix, isz)
                 + rows * ts[-1] * tsz + rows * 3 * csz)
