"""Ball query: centroids (B, C, 3), coords (B, N, 3), K -> (B, C, K)
indices and counts; ten operations a (centroid, point) distance."""

from portbench.work import nbytes


def work(args):
    (cs, csz), (ps, psz), K = args[0], args[1], args[2]
    B, C, _ = cs
    N = ps[1]
    return 10.0 * B * C * N, nbytes(cs, csz) + nbytes(ps, psz) + 5 * B * C * K
