"""The work counters against values worked out by hand."""

from portbench import work


def test_pointnet2_ssg_matmul_flops_of_one_cloud():
    # one cloud of 4,096 points, forward; each grouped first layer once a
    # point for its features and once a (centroid, neighbour) for xyz
    sa = (2 * 4096 * 6 * 32 + 2 * 1024 * 32 * 3 * 32 + 2 * 1024 * 32 * (32 * 32 + 32 * 64)
          + 2 * 1024 * 64 * 64 + 2 * 256 * 32 * 3 * 64 + 2 * 256 * 32 * (64 * 64 + 64 * 128)
          + 2 * 256 * 128 * 128 + 2 * 64 * 32 * 3 * 128 + 2 * 64 * 32 * (128 * 128 + 128 * 256)
          + 2 * 64 * 256 * 256 + 2 * 16 * 32 * 3 * 256 + 2 * 16 * 32 * (256 * 256 + 256 * 512))
    fp = (2 * 64 * (768 * 256 + 256 * 256) + 2 * 256 * (384 * 256 + 256 * 256)
          + 2 * 1024 * (320 * 256 + 256 * 128) + 2 * 4096 * 4 * 128 * 128)
    head = 2 * 4096 * 128 * 14
    assert work.pointnet2_ssg_forward_flops(1, 4096) == sa + fp + head
    assert work.step_matmul_flops("pointnet2_ssg", 8, 4096) == 3 * 8 * (sa + fp + head)


def test_dgcnn_matmul_flops_of_one_cloud():
    rows = 4096
    edge = 2 * rows * 2 * (3 * 64 + 64 * 64 + 64 * 64 + 64 * 128)
    rest = 2 * rows * (3 * 64 + 384 * 1024 + 1408 * 512 + 512 * 256 + 256 * 14)
    assert work.dgcnn_forward_flops(1, 4096) == edge + rest


def test_one_knn_call():
    flops, nbytes = work.op_work("knn_indices", [((8, 4096, 64), 4), 20])
    assert flops == 2 * 8 * 4096 * 4096 * 64
    assert nbytes == 4 * 8 * 4096 * 64 + 4 * 8 * 4096 * 20
    # the Gram products bound it: 17.2 GFLOP over 67 TFLOP/s
    assert abs(work.bound_seconds(flops, nbytes) - flops / 67e12) < 1e-15


def test_one_gather_call():
    flops, nbytes = work.op_work("gather_rows", [((8, 4096, 64), 4), ((8, 1024, 32), 4)])
    assert flops == 0
    assert nbytes == 8 * 4096 * 64 * 4 + 8 * 1024 * 32 * 4 + 8 * 1024 * 32 * 64 * 4
    assert work.bound_seconds(flops, nbytes) == nbytes / 3.35e12


def test_gather_with_coordinates_and_bf16_rows():
    _, nbytes = work.op_work("gather_rows_with_coords",
                             [((8, 4096, 32), 2), ((8, 4096, 3), 4), ((8, 1024, 32), 4)])
    rows = 8 * 1024 * 32
    assert nbytes == 8 * 4096 * 32 * 2 + 8 * 4096 * 3 * 4 + rows * 4 + rows * 32 * 2 + rows * 12
