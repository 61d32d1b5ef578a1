"""Structural rules of the PyTorch port.

- `pointseg_torch` and `chip_smoke.py` import no JAX, flax or optax, and
  nothing of `pointseg`, not even a module there that imports no JAX:
  the port keeps its own copy of the numpy data layer. Checked on the
  source (AST), not on `sys.modules`, where JAX may already sit.
- CPU tensors run the plain versions and never count as kernel launches;
  other devices are refused.
- The kernel build is pinned to Hopper (`sm_90a`) and its sources ship
  with the package.
"""

import ast
import pathlib
import tomllib

import numpy as np
import pytest
import torch

from pointseg_torch import ops
from pointseg_torch.models import create_model
from pointseg_torch.ops import _kernels

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pointseg_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
ALLOWED_POINTSEG = set()  # nothing of the JAX package
BANNED_ROOTS = {"jax", "jaxlib", "flax", "optax"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            if node.module == "pointseg":
                yield from (f"pointseg.{alias.name}" for alias in node.names)
            else:
                yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_only_the_data_layer(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in BANNED_ROOTS, f"{path.name} imports {name}"
        if root == "pointseg":
            assert name in ALLOWED_POINTSEG, f"{path.name} imports {name}"


def test_cpu_tensors_never_count_as_launches():
    before = dict(_kernels.LAUNCHES)
    rng = np.random.default_rng(0)
    model = create_model("PointNet++").train()
    x = torch.from_numpy(rng.random((2, 1024, 9)).astype(np.float32))
    model(x, generator=torch.Generator().manual_seed(0)).sum().backward()
    pts = x[..., :3]
    ops.three_nn(pts, pts[:, :64])
    dgcnn = create_model("DGCNN", k=8, emb_dims=32, knn_select="two_level").train()
    dgcnn(x[:, :256]).sum().backward()
    ops.gather_rows(x, torch.zeros((2, 5), dtype=torch.int32))
    for name in ("PointNeXt", "PointNet++MSG"):
        new = create_model(name, ball_select="two_level").train()
        new(x, generator=torch.Generator().manual_seed(0)).sum().backward()
    ops.ball_query(pts[:, :8], pts, 0.2, 8, select="two_level")
    assert _kernels.LAUNCHES == before
    assert set(before) == {"fps", "ball_query", "ball_query_2l", "three_nn", "knn", "knn_2l",
                           "gather_rows"}


def test_other_devices_are_refused():
    pts = torch.empty((1, 64, 3), device="meta")
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.farthest_point_sampling(pts, 8)
    for select in ("flat", "two_level"):
        with pytest.raises(ValueError, match="cpu.*cuda"):
            ops.ball_query(pts[:, :8], pts, 0.2, 8, select=select)
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.three_nn(pts, pts[:, :8])
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.knn_indices(pts, 4)
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.gather_rows(pts, torch.zeros((1, 4), dtype=torch.int32, device="meta"))


def test_wrapper_checks_refuse_cpu_and_wrong_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.check(torch.zeros(2, 5, 3), "coords", torch.float32, (2, 5, 3))


def test_kernel_build_targets_hopper_and_sources_ship():
    flags = " ".join(_kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "--fmad=false" in flags
    assert set(_kernels.SOURCES) == {p.name for p in _kernels.CSRC.glob("*.cu")}
    for name in _kernels.SOURCES:
        assert (_kernels.CSRC / name).is_file(), name
    for symbol in _kernels._SIGNATURES:  # every bound entry point is defined in a source
        assert any(f'extern "C" int {symbol}(' in (_kernels.CSRC / name).read_text()
                   for name in _kernels.SOURCES), symbol
    assert _kernels.BUILD_ROOT.is_relative_to(REPO / "build")  # listed in .gitignore
    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    assert "csrc/*.cu" in meta["tool"]["setuptools"]["package-data"]["pointseg_torch"]


def _cuda_path(module: str) -> str:
    """Source of `ops/<module>`'s `_..._cuda` function, the code a CUDA
    tensor runs."""
    import re

    text = (REPO / "pointseg_torch" / "ops" / module).read_text()
    (body,) = re.findall(r"\ndef _\w+_cuda\(.*?(?=\n(?:def|class) |\Z)", text, flags=re.S)
    return body


LIBRARY_IN_SOURCE = r"cublas|cutlass|thrust|cub::|torch/"
LIBRARY_IN_WRAPPER = r"torch\.(topk|sort|cdist|matmul|bmm|gather|index_select|compile)|_plain\("


def test_knn_source_holds_two_selection_kernels_and_the_gather_one():
    """The flat and the two-level kNN are distinct `__global__` kernels,
    the gather one; none of the sources reaches for a library."""
    import re

    knn = (_kernels.CSRC / "knn.cu").read_text()
    gather = (_kernels.CSRC / "gather.cu").read_text()
    names = re.findall(r"__global__ void (\w+)", knn)
    assert {"knn_flat_kernel", "knn_two_level_kernel"} <= set(names)
    assert re.findall(r"__global__ void (\w+)", gather) == ["gather_rows_kernel"]
    for text in (knn, gather):
        assert not re.search(LIBRARY_IN_SOURCE, text)
    for name in ("knn.py", "gather.py"):
        assert not re.search(LIBRARY_IN_WRAPPER, _cuda_path(name)), name


def test_ball_query_source_holds_two_selection_kernels():
    """The flat and the two-level ball query are distinct `__global__`
    kernels with an entry point each; the source reaches for no library
    and the wrapper's CUDA path for no PyTorch selection or plain version."""
    import re

    source = (_kernels.CSRC / "ballquery.cu").read_text()
    names = re.findall(r"__global__ void (\w+)", source)
    assert names == ["ball_query_kernel", "ball_query_two_level_kernel"]
    assert not re.search(LIBRARY_IN_SOURCE, source)
    for depth in (1, 4, 5):  # the depths the wrapper may ask for
        assert f"ball_query_two_level_kernel<{depth}>" in source
    path = _cuda_path("ballquery.py")
    assert not re.search(LIBRARY_IN_WRAPPER, path)
    assert '"pointseg_ball_query"' in path and '"pointseg_ball_query_2l"' in path
