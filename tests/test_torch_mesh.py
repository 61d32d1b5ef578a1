"""The layouts of pointseg_torch's meshes and placements against the JAX
package's, in one process (no ranks; `tests/test_torch_tensor_parallel.py`
runs them on ranks):

- `create_hybrid_mesh` / `hybrid_grid` reproduce the three cases of
  `tests/test_parallel.py` (two nodes of four, three nodes with the data
  axis second, one process), rank for rank against the grid JAX builds
  from the same fake devices (a device id is a port rank, a JAX process a
  node);
- `tensor_parallel_sharding` follows `test_tensor_parallel_sharding_rules`
  case by case, and `sharded_param_fraction` of the same leaves;
- for the dry run's four models, every leaf of the JAX variables is placed
  as JAX places it, read through `io/jax_import.py`'s key map (each leaf
  filled with its own number, so its region in the port tensor shows), and
  the sharded fraction is JAX's exactly;
- a GroupedFirstLayer whose `w_feat` is row-parallel and `w_rel` whole
  (no registry model has one) is placed block by block;
- the point split's shares and the refusals: N not divisible by the ranks,
  and a device store whose T is not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointseg.models import DGCNN, PointNetPP, PointNetSeg, PointNeXt
from pointseg.parallel import create_mesh as jax_create_mesh
from pointseg.parallel import sharded_param_fraction as jax_fraction
from pointseg.parallel import tensor_parallel_sharding as jax_sharding
from pointseg.parallel.mesh import create_hybrid_mesh as jax_hybrid_mesh
from pointseg_torch.data.device import CompactDeviceStore, DeviceBlockStore, upload_flat
from pointseg_torch.io import from_jax_variables
from pointseg_torch.models import create_model
from pointseg_torch.nn.blocks import GroupedFirstLayer
from pointseg_torch.parallel import (Mesh, create_hybrid_mesh, create_mesh, hybrid_grid,
                                     shard_points, sharded_param_fraction,
                                     tensor_parallel_sharding)
from pointseg_torch.parallel.points import share_sizes
from pointseg_torch.parallel.tensor_parallel import leaves, plans

torch.set_num_threads(2)


class _FakeDev:
    """`tests/test_parallel.py`'s stand-in device."""

    def __init__(self, pid, did, with_slice=True):
        self.process_index = pid
        self.id = did
        if with_slice:
            self.slice_index = pid
        self.platform = "cpu"
        self.device_kind = "fake"


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(np.array(mesh.devices))


def layout(axes, shape, rank=0):
    """A mesh layout of `shape` seen by `rank`, with no process group."""
    return create_hybrid_mesh("cpu", axes, ici_shape=shape, process_count=1,
                              local_device_count=int(np.prod(shape)), rank=rank)


# --- meshes -----------------------------------------------------------------------------

@pytest.mark.parametrize("with_slice", [True, False])
def test_hybrid_mesh_two_nodes_matches_jax(with_slice):
    fakes = [_FakeDev(p, p * 4 + i, with_slice) for p in range(2) for i in range(4)]
    jm = jax_hybrid_mesh(axes=("data", "model"), devices=fakes, process_count=2,
                         local_device_count=4)
    grid = hybrid_grid(("data", "model"), process_count=2, local_device_count=4)
    np.testing.assert_array_equal(grid, _ids(jm))
    for rank in range(8):
        m = create_hybrid_mesh("cpu", ("data", "model"), process_count=2,
                               local_device_count=4, rank=rank)
        assert m.axis_names == ("data", "model") and m.shape == dict(jm.shape)
        np.testing.assert_array_equal(m.ranks(), _ids(jm))
        assert (m.axis_index("data"), m.axis_index("model")) == divmod(rank, 4)
        # a model line is one node, a data line crosses the nodes
        assert {r // 4 for r in m.axis("model").members} == {rank // 4}
        assert {r // 4 for r in m.axis("data").members} == {0, 1}
        assert (m.rank, m.world_size) == (rank // 4, 2)


def test_hybrid_mesh_of_a_rank_list_matches_jax_of_the_same_devices():
    """JAX lays each process's devices out in the order it is given them;
    the port a node's ranks in the order of the rank list."""
    order = [3, 1, 2, 0, 6, 4, 7, 5]
    fakes = [_FakeDev(d // 4, d) for d in order]
    jm = jax_hybrid_mesh(axes=("data", "model"), devices=fakes, process_count=2,
                         local_device_count=4)
    grid = hybrid_grid(("data", "model"), process_count=2, local_device_count=4, ranks=order)
    np.testing.assert_array_equal(grid, _ids(jm))
    m = create_hybrid_mesh("cpu", ("data", "model"), process_count=2, local_device_count=4,
                           ranks=order, rank=2)
    assert (m.axis_index("data"), m.axis_index("model")) == (0, 2)
    assert m.axis("model").members == (3, 1, 2, 0)


def test_hybrid_mesh_data_axis_second_matches_jax():
    fakes = [_FakeDev(p, p * 4 + i) for p in range(3) for i in range(4)]
    jm = jax_hybrid_mesh(axes=("model", "data"), devices=fakes, process_count=3,
                         local_device_count=4)
    grid = hybrid_grid(("model", "data"), process_count=3, local_device_count=4)
    np.testing.assert_array_equal(grid, _ids(jm))
    m = create_hybrid_mesh("cpu", ("model", "data"), process_count=3, local_device_count=4,
                           rank=6)
    assert m.shape == {"model": 4, "data": 3} == dict(jm.shape)
    assert (m.axis_index("model"), m.axis_index("data")) == (2, 1)
    assert (m.rank, m.world_size) == (1, 3) and m.axis("data").members == (2, 6, 10)


def test_hybrid_mesh_one_process_degenerates_as_jax():
    jm = jax_hybrid_mesh(axes=("data", "model"))
    n = len(jax.devices())
    np.testing.assert_array_equal(
        hybrid_grid(("data", "model"), process_count=1, local_device_count=n), _ids(jm))
    one = create_hybrid_mesh("cpu", ("data", "model"))
    assert one.shape == {"data": 1, "model": 1} and one.world_size == 1
    assert one == create_mesh("cpu", axes=("data", "model"))


def test_meshes_lay_ranks_out_as_jax_reshapes_devices():
    jm = jax_create_mesh(jax.devices()[:8], axes=("data", "model"), shape=(4, 2))
    for rank in range(8):
        m = layout(("data", "model"), (4, 2), rank)
        np.testing.assert_array_equal(m.ranks(), _ids(jm))
        assert (m.rank, m.axis_index("model")) == divmod(rank, 2)
        assert m.world_size == 4 and m.axis_size("model") == 2 and m.size == 8
    one = create_mesh("cpu")
    assert one == Mesh() and one.shape == {"data": 1} and one.axis_names == ("data",)
    assert one.flat() == Mesh() and Mesh(world_size=3).shape == {"data": 3}
    with pytest.raises(ValueError):
        create_mesh("cpu", axes=("data", "model"), shape=(2, 2))  # one process


# --- the placement rule -----------------------------------------------------------------

RULE_CASES = {"wide": (64, 256), "head": (1024, 14), "narrow": (64, 14), "vec": (256,),
              "tiny_vec": (14,), "conv": (1, 1, 64, 256)}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_tensor_parallel_sharding_rules_match_jax(case):
    shape = RULE_CASES[case]
    jm = jax_create_mesh(jax.devices()[:8], axes=("data", "model"), shape=(4, 2))
    want = tuple(jax_sharding(jm, jnp.zeros(shape)).spec)
    assert tensor_parallel_sharding(layout(("data", "model"), (4, 2)), shape) == want
    assert tensor_parallel_sharding(layout(("data",), (8,)), shape) == ()


def test_sharded_param_fraction_of_leaves_matches_jax():
    jm = jax_create_mesh(jax.devices()[:8], axes=("data", "model"), shape=(4, 2))
    tree = {"a": jnp.zeros((64, 256)), "b": jnp.zeros((64, 14)), "c": jnp.zeros((256,))}
    got = sharded_param_fraction({k: v.shape for k, v in tree.items()},
                                 layout(("data", "model"), (4, 2)))
    assert got == jax_fraction(tree, jm)


DRYRUN_MODELS = {  # the JAX dry run's four models and the port's names for them
    "PointNet++": (lambda: PointNetPP(num_classes=14), "PointNet++", {}),
    "PointNet": (lambda: PointNetSeg(num_classes=14), "PointNet", {}),
    "PointNeXt": (lambda: PointNeXt(num_classes=14), "PointNeXt", {}),
    "DeepGraphCnn": (lambda: DGCNN(num_classes=14, k=8, emb_dims=128), "DGCNN",
                     dict(k=8, emb_dims=128)),
}


def _region(mask: np.ndarray) -> tuple:
    """The (start, stop) of a leaf's cells along each dim of its port tensor."""
    where = np.nonzero(mask)
    return tuple((int(w.min()), int(w.max()) + 1) for w in where)


@pytest.mark.parametrize("name", list(DRYRUN_MODELS))
def test_every_leaf_is_placed_as_jax_places_it(name):
    jax_model, port_name, kwargs = DRYRUN_MODELS[name]
    jm = jax_create_mesh(jax.devices()[:4], axes=("data", "model"), shape=(2, 2))
    mesh = layout(("data", "model"), (2, 2))
    variables = jax.jit(lambda k, x: jax_model().init({"params": k}, x, train=False))(
        jax.random.key(0), jnp.zeros((2, 128, 9)))
    flat = flatten_dict(jax.tree.map(np.asarray, variables), sep="/")
    numbered = {path: np.full(leaf.shape, i + 1.0, np.float32)
                for i, (path, leaf) in enumerate(sorted(flat.items()))}
    sd = from_jax_variables(port_name, unflatten_dict(numbered, sep="/"))
    model = create_model(port_name, num_classes=14, **kwargs)
    placed = {f"{module}.{t}" if module else t: p
              for module, (_, tensors) in plans(model, mesh).items()
              for t, p in tensors.items()}
    split_dims = set()
    for i, (path, leaf) in enumerate(sorted(flat.items())):
        spec = tuple(jax_sharding(jm, leaf).spec)
        key = next(k for k, v in sd.items() if v.is_floating_point() and (v == i + 1).any())
        region = _region((sd[key] == i + 1).numpy())
        p = placed.get(key)
        if not spec:  # replicated: the leaf's cells lie in no split segment
            assert p is None or not any(
                split and s < region[p.dim][1] and region[p.dim][0] < s + n
                for s, n, split in p.segments), (path, key)
            continue
        jdim = spec.index("model")
        pdim = 0 if leaf.ndim == 1 else 1 - jdim  # a kernel is the transposed weight
        assert p is not None and p.dim == pdim, (path, key, p)
        assert (region[pdim][0], region[pdim][1] - region[pdim][0], True) in p.segments, (
            path, key, p)
        split_dims.add(pdim)
    assert all(k.endswith("num_batches_tracked") for k in set(sd) - {
        key for key in sd if sd[key].is_floating_point()})
    assert not any(k.endswith("num_batches_tracked") for k in placed)
    assert sharded_param_fraction(model, mesh) == jax_fraction(variables["params"], jm)
    assert split_dims == {0, 1}  # column- and row-parallel layers both occur


def test_grouped_first_layer_places_its_two_kernels_apart():
    """h = 64 < 128: `w_rel` (3, 64) stays whole and `w_feat` (128, 64) is
    row-parallel; at h = 128 both are column-parallel, dim 0 of the one
    weight."""
    mesh = layout(("data", "model"), (2, 2))
    narrow = GroupedFirstLayer(128, [64], 0.2, 8)
    (plan, tensors), = plans(narrow, mesh).values()
    assert plan.mode == "features_row" and set(tensors) == {"weight"}
    assert tensors["weight"].dim == 1
    assert tensors["weight"].segments == ((0, 3, False), (3, 128, True))
    roles = {role: tensor_parallel_sharding(mesh, shape) for _, _, shape, role, _ in
             leaves(narrow) if role in ("w_rel", "w_feat")}
    assert roles == {"w_rel": (), "w_feat": ("model", None)}
    wide = GroupedFirstLayer(64, [128], 0.2, 8)
    got = plans(wide, mesh)
    assert got["conv.0"][0].mode == "column" and got["batch.0"][0].mode == "vector"
    assert got["conv.0"][1]["weight"].segments == ((0, 128, True),)


# --- the point split and the refusals ----------------------------------------------------

def test_point_shares_split_unevenly_and_the_input_must_divide():
    assert share_sizes(16, 3) == [6, 5, 5] and share_sizes(1024, 4) == [256] * 4
    assert share_sizes(2, 4) == [1, 1, 0, 0]
    x = torch.arange(2 * 12 * 3).reshape(2, 12, 3)
    m = layout(("data", "points"), (2, 3), rank=4)
    assert torch.equal(shard_points(m, x, "points"), x[:, 4:8])
    with pytest.raises(ValueError):
        shard_points(layout(("data", "model"), (5, 1), rank=0), x)


@pytest.mark.parametrize("store", ["flat", "compact", "upload"])
def test_a_table_that_does_not_divide_is_refused(store):
    from test_torch_device_data import _canonical_blocks

    pts, labs, counts = _canonical_blocks(num_blocks=3, counts=[101, 64, 64])  # T = 229
    mesh = layout(("data",), (4,), rank=1)
    with pytest.raises(ValueError, match="does not split"):
        if store == "flat":
            DeviceBlockStore(pts, labs, counts, 14, mesh=mesh)
        elif store == "compact":
            CompactDeviceStore(pts, labs, counts, 14, mesh=mesh)
        else:
            upload_flat(pts, "cpu", mesh=mesh)
