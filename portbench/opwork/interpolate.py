"""3-NN inverse-distance interpolation: features (B, M, D), target
coords (B, N, 3), source coords (B, M, 3) -> (B, N, D)."""

from portbench.work import nbytes


def work(args):
    (fs, fsz), (ts, tsz), (ss, ssz) = args[0], args[1], args[2]
    B, M, D = fs
    N = ts[1]
    ops = 10.0 * B * N * M + 6.0 * B * N * D
    return ops, (nbytes(fs, fsz) + nbytes(ts, tsz) + nbytes(ss, ssz)
                 + B * N * D * fsz)
