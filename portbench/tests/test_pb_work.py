"""The work counters against values worked out by hand, found by name in
`portbench/reference/archs/` and `portbench/opwork/`."""

import pytest

from portbench import harness, work

SPEC = harness.load_benchmark()


def _arch_kwargs(arch):
    """The `arch_kwargs` of the configuration of `BENCHMARK.json` that runs `arch`."""
    cells = [harness.Cell(SPEC, w["name"]) for w in SPEC["workloads"]]
    return next(c.config["arch_kwargs"] for c in cells if c.config["arch"] == arch)


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
    assert harness.arch_module("pointnet2_ssg").forward_flops(1, 4096) == sa + fp + head
    assert work.step_matmul_flops("pointnet2_ssg", 8, 4096) == 3 * 8 * (sa + fp + head)
    kwargs = _arch_kwargs("pointnet2_ssg")
    assert work.step_matmul_flops("pointnet2_ssg", 8, 4096, **kwargs) == 3 * 8 * (sa + fp + head)


def test_dgcnn_matmul_flops_of_one_cloud():
    rows = 4096
    edge = 2 * rows * 2 * (3 * 64 + 64 * 64 + 64 * 64 + 64 * 128)
    rest = 2 * rows * (3 * 64 + 384 * 1024 + 1408 * 512 + 512 * 256 + 256 * 14)
    dgcnn = harness.arch_module("dgcnn")
    assert dgcnn.forward_flops(1, 4096) == edge + rest
    assert dgcnn.forward_flops(1, 4096, **_arch_kwargs("dgcnn")) == edge + rest


def test_one_knn_call():
    flops, nbytes = harness.op_module("knn_indices").work([((8, 4096, 64), 4), 20])
    assert flops == 2 * 8 * 4096 * 4096 * 64
    assert nbytes == 4 * 8 * 4096 * 64 + 4 * 8 * 4096 * 20
    # the Gram products bound it: 17.2 GFLOP over 67 TFLOP/s
    assert abs(work.bound_seconds(flops, nbytes) - flops / 67e12) < 1e-15


def test_one_gather_call():
    args = [((8, 4096, 64), 4), ((8, 1024, 32), 4)]
    flops, nbytes = harness.op_module("gather_rows").work(args)
    assert flops == 0
    assert nbytes == 8 * 4096 * 64 * 4 + 8 * 1024 * 32 * 4 + 8 * 1024 * 32 * 64 * 4
    assert work.bound_seconds(flops, nbytes) == nbytes / 3.35e12
    assert harness.op_module("gather_neighbors").work(args) == (flops, nbytes)


def test_gather_with_coordinates_and_bf16_rows():
    _, nbytes = harness.op_module("gather_rows_with_coords").work(
        [((8, 4096, 32), 2), ((8, 4096, 3), 4), ((8, 1024, 32), 4)])
    rows = 8 * 1024 * 32
    assert nbytes == 8 * 4096 * 32 * 2 + 8 * 4096 * 3 * 4 + rows * 4 + rows * 32 * 2 + rows * 12


def test_edge_reduce_of_a_dgcnn_step():
    """The rule of the port's kernel table, row 9: forward, the table, the
    indices, four outputs and two 1-byte tie counts; backward, the table,
    the indices, max, min, the counts, four gradients and the table's
    float32 gradient. DGCNN's four calls at B 32 x 4,096, k 20: 0.2880 ms
    and 0.4382 ms at 3.35 TB/s, the bytes bounding both."""
    op = harness.op_module("edge_reduce")
    assert op.BACKWARD_KERNELS == ("edge_reduce_backward_kernel",)
    fwd = bwd = 0.0
    for C in (64, 64, 64, 128):
        table, idx, out = 32 * 4096 * C * 4, 32 * 4096 * 20 * 4, 32 * 4096 * C
        args = [((32, 4096, C), 4), ((32, 4096, 20), 4), True]
        f_ops, f_bytes = op.work(args)
        b_ops, b_bytes = op.backward_work(args)
        assert f_bytes == table + idx + out * (4 + 4 + 4 + 4 + 1 + 1)
        assert b_bytes == table + idx + out * (4 + 4 + 1 + 1 + 4 * 4) + table
        assert f_ops / 67e12 < f_bytes / 3.35e12 and b_ops / 67e12 < b_bytes / 3.35e12
        fwd += work.bound_seconds(f_ops, f_bytes)
        bwd += work.bound_seconds(b_ops, b_bytes)
    assert round(fwd * 1e3, 4) == 0.2880 and round(bwd * 1e3, 4) == 0.4382
    # an evaluation call writes no sums; k over 255 takes 4-byte counts
    out = 32 * 4096 * 64
    assert op.work([((32, 4096, 64), 4), ((32, 4096, 20), 4), False])[1] == \
        out * 4 + 32 * 4096 * 20 * 4 + out * (4 + 4 + 1 + 1)
    assert op.work([((1, 512, 64), 2), ((1, 512, 300), 4), True])[1] == \
        512 * 64 * 2 + 512 * 300 * 4 + 512 * 64 * (2 + 2 + 4 + 4 + 4 + 4)


@pytest.mark.parametrize("lookup,name,path", [
    (harness.arch_module, "pointnext_xl", "portbench/reference/archs/pointnext_xl.py"),
    (harness.op_module, "no_such_op", "portbench/opwork/no_such_op.py"),
    (harness.metric_reader, "ops.no_such_op_ms", "portbench/metrics/ops.no_such_op_ms.py")])
def test_a_missing_module_names_its_path(lookup, name, path):
    with pytest.raises(FileNotFoundError, match=path.replace(".", r"\.")):
        lookup(name)


def test_every_op_file_is_traced():
    names = harness.traced_ops()
    assert {"edge_reduce", "knn_indices", "gather_rows", "farthest_point_sampling"} <= set(names)
    for name in names:
        assert callable(harness.op_module(name).work)
