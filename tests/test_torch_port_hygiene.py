"""Structural rules of the PyTorch port.

- `pointseg_torch`, `chip_smoke.py` and the rank-side modules that it
  imports (`tests/torch_parallel_ranks.py`, `tests/torch_tp_ranks.py`)
  import no JAX, flax or optax,
  and nothing of `pointseg`, not even a module there that imports no JAX:
  the port keeps its own copy of the numpy data layer. Checked on the
  source (AST), not on `sys.modules`, where JAX may already sit.
- CPU tensors run the plain versions and never count as kernel launches;
  other devices are refused.
- The kernel build is pinned to Hopper (`sm_90a`) and its sources ship
  with the package.
- The ops layer alone chooses each selection kernel: no public function
  or class takes a kernel choice, and nothing outside `ops/` reaches the
  private route that forces the two-level kernels.
"""

import ast
import ctypes
import importlib
import inspect
import pathlib
import re
import tomllib

import numpy as np
import pytest
import torch

from pointseg_torch import ops
from pointseg_torch.models import create_model
from pointseg_torch.ops import _kernels

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pointseg_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "torch_parallel_ranks.py",
    REPO / "tests" / "torch_tp_ranks.py"]
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
    dgcnn = create_model("DGCNN", k=40, emb_dims=32).train()  # k > 32: kernel 5's shape
    dgcnn(x[:, :256]).sum().backward()
    ops.gather_rows(x, torch.zeros((2, 5), dtype=torch.int32))
    ops.gather_rows_flat(x[0], torch.zeros(5, dtype=torch.int64))
    for name in ("PointNeXt", "PointNet++MSG"):
        new = create_model(name).train()
        new(x, generator=torch.Generator().manual_seed(0)).sum().backward()
    ops.ball_query(pts[:, :8], pts, 0.2, 48)  # K > 32: kernel 6's shape
    assert _kernels.LAUNCHES == before
    ops.edge_reduce(x[..., :4], torch.zeros((2, 6, 3), dtype=torch.int32), True)
    assert _kernels.LAUNCHES == before
    assert set(before) == {"fps", "ball_query", "ball_query_2l", "three_nn", "knn", "knn_2l",
                           "gather_rows", "gather_rows_flat", "edge_reduce"}


def test_other_devices_are_refused():
    pts = torch.empty((1, 64, 3), device="meta")
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.farthest_point_sampling(pts, 8)
    for K in (8, 48):  # the flat and the two-level kernel's shapes
        with pytest.raises(ValueError, match="cpu.*cuda"):
            ops.ball_query(pts[:, :8], pts, 0.2, K)
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.knn_indices(pts, 40)
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.three_nn(pts, pts[:, :8])
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.knn_indices(pts, 4)
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.gather_rows(pts, torch.zeros((1, 4), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.gather_rows_flat(pts[0], torch.zeros(4, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="cpu.*cuda"):
        ops.edge_reduce(pts, torch.zeros((1, 4, 2), dtype=torch.int32, device="meta"), True)


KERNEL_CHOICES = {"select", "ball_select", "knn_select"}


def _public_callables():
    """(qualified name, callable) of every public function and class that
    a module of `pointseg_torch` defines."""
    for path in sorted((REPO / "pointseg_torch").rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if any(p.startswith("_") for p in parts) or parts[-1] == "__main__":
            continue
        module = importlib.import_module(".".join(parts))
        for name, obj in vars(module).items():
            if (not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
                    and getattr(obj, "__module__", None) == module.__name__):
                yield f"{module.__name__}.{name}", obj


def test_no_public_function_or_class_takes_a_kernel_choice():
    """The ball query and kNN pick their CUDA kernel from the call's shape
    (`ops/ballquery.py`, `ops/knn.py`); no caller passes a choice down."""
    seen = 0
    for name, obj in _public_callables():
        targets = [obj.__init__] if inspect.isclass(obj) else [obj]
        if inspect.isclass(obj):
            targets += [f for f in vars(obj).values() if inspect.isfunction(f)]
        for fn in targets:
            try:
                params = set(inspect.signature(fn).parameters)
            except (TypeError, ValueError):  # a builtin slot without a signature
                continue
            seen += 1
            assert not params & KERNEL_CHOICES, (name, fn.__name__, params & KERNEL_CHOICES)
    assert seen > 300  # every subpackage was reached


def test_only_the_ops_layer_reaches_the_two_level_route():
    """The private route that forces kernels 5 and 6 (`"two_level"`,
    `_select`, `_knn`, `_ball_query_cuda`, `_knn_cuda`) and the `_2l`
    operators are named only inside `pointseg_torch/ops/`."""
    banned = re.compile(r"two_level|\b_select\(|\b_knn\(|_ball_query_cuda|_knn_cuda|"
                        r"pointseg_torch\.(knn|ball_query)_2l")
    for path in sorted((REPO / "pointseg_torch").rglob("*.py")):
        if path.parent.name == "ops":
            continue
        code = "\n".join(line.split("#")[0] for line in path.read_text().splitlines())
        assert not banned.search(code), (path, banned.search(code).group(0))


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
    for name in _kernels.HEADERS:  # shipped, and part of the build's hash
        assert (_kernels.CSRC / name).is_file(), name
    assert set(_kernels.HEADERS) == {p.name for p in _kernels.CSRC.glob("*.cuh")}
    assert "SOURCES + HEADERS" in inspect.getsource(_kernels.build)
    assert _kernels.BUILD_ROOT.is_relative_to(REPO / "build")  # listed in .gitignore
    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    shipped = meta["tool"]["setuptools"]["package-data"]["pointseg_torch"]
    assert "csrc/*.cu" in shipped and "csrc/*.cuh" in shipped


def test_launch_does_no_work_that_does_not_depend_on_its_arguments():
    """`launch` is the host cost of every kernel call: no context manager,
    no attribute lookup on the library, no stream object, no build or
    load check beyond one `is None`; the entry points are bound once, by
    `library()`, into `_ENTRY_POINTS` with their argument types."""
    body = inspect.getsource(_kernels.launch).split('"""')[-1]  # past the docstring
    for banned in (r"\bwith\b", r"getattr\(", r"torch\.cuda\.device\(", r"current_stream\(",
                   r"\.cuda_stream", r"argtypes", r"synchronize", r"\btry\b", r"ctypes\."):
        assert not re.search(banned, body), banned
    assert "_ENTRY_POINTS[symbol](*args, index, _raw_stream(index))" in body
    assert "LAUNCHES[kernel] += 1" in body and "CudaError(err)" in body
    loader = inspect.getsource(_kernels.library)
    assert "fn.argtypes = argtypes" in loader and "_ENTRY_POINTS[name] = fn" in loader
    assert "_cuda_getCurrentRawStream" in loader


def test_launch_passes_device_and_stream_last_counts_and_raises(monkeypatch):
    """With a stand-in for the loaded library: the entry point gets the
    wrapper's arguments, then the device index, then that device's raw
    stream handle; a zero return counts one launch, any other raises and
    counts none."""
    seen = []

    def entry(*args):
        seen.append(args)
        return 0 if args[0] == "ok" else 700

    monkeypatch.setattr(_kernels, "_library", object())
    monkeypatch.setattr(_kernels, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setitem(_kernels._ENTRY_POINTS, "pointseg_fps", entry)
    monkeypatch.setitem(_kernels.LAUNCHES, "fps", 0)
    _kernels.launch("fps", "pointseg_fps", torch.device("cuda", 3), "ok", 7)
    assert seen == [("ok", 7, 3, 1003)] and _kernels.LAUNCHES["fps"] == 1
    with pytest.raises(Exception):  # torch.cuda.CudaError (its message needs the CUDA runtime)
        _kernels.launch("fps", "pointseg_fps", torch.device("cuda", 0), "bad")
    assert _kernels.LAUNCHES["fps"] == 1 and seen[-1] == ("bad", 0, 1000)


WRAPPERS = {  # ops module -> the C entry points its CUDA path launches
    "fps.py": ("pointseg_fps",),
    "ballquery.py": ("pointseg_ball_query", "pointseg_ball_query_2l"),
    "interpolate.py": ("pointseg_three_nn",),
    "knn.py": ("pointseg_knn", "pointseg_knn_2l"),
    "gather.py": ("pointseg_gather_rows", "pointseg_gather_rows_flat"),
    "edgereduce.py": ("pointseg_edge_reduce", "pointseg_edge_reduce_backward"),
}


@pytest.mark.parametrize("module", sorted(WRAPPERS))
def test_every_wrapper_reaches_its_kernels_through_launch_and_nothing_else(module):
    """Each entry point is named in exactly one `_kernels.launch(` call of
    its wrapper; no wrapper touches the library, the binding table or
    ctypes itself, or guards the device on its own."""
    text = (REPO / "pointseg_torch" / "ops" / module).read_text()
    calls = re.findall(r"_kernels\.launch\(\s*\"\w+\",\s*\"(\w+)\"", text)
    assert sorted(calls) == sorted(WRAPPERS[module])
    assert not re.search(r"_ENTRY_POINTS|_kernels\.library\(|ctypes|torch\.cuda\.device\(|"
                         r"current_stream|_raw_stream", text)
    assert {s for symbols in WRAPPERS.values() for s in symbols} == set(_kernels._SIGNATURES)


@pytest.mark.parametrize("symbol", sorted(_kernels._SIGNATURES))
def test_every_entry_point_takes_device_and_stream_last_and_guards_the_device(symbol):
    """The binding table and the C definitions agree: `int device, void*
    stream` close every entry point's arguments, and its body begins by
    making that device current through `DeviceScope` (directly, or in the
    one launcher it hands its arguments to)."""
    assert _kernels._SIGNATURES[symbol][-2:] == (ctypes.c_int, ctypes.c_void_p)
    (source,) = [text for text in ((_kernels.CSRC / name).read_text() for name in _kernels.SOURCES)
                 if f'extern "C" int {symbol}(' in text]
    assert '#include "launch.cuh"' in source
    (args, body) = re.findall(rf'extern "C" int {symbol}\((.*?)\) {{\n(.*?)\n}}\n', source,
                              flags=re.S)[0]
    assert re.search(r"int device,\s+void\* stream$", args), args
    assert len(args.split(",")) == len(_kernels._SIGNATURES[symbol])
    guarded = "const DeviceScope scope(device);" in body
    if not guarded:  # the ball queries share one launcher
        (launcher,) = set(re.findall(r"return (launch_\w+)\(", body))
        assert re.search(rf"int {launcher}\(.*?\) {{\n  const DeviceScope scope\(device\);",
                         source, flags=re.S)
        assert body.count("device, stream);") == body.count(f"{launcher}(")
    header = (_kernels.CSRC / "launch.cuh").read_text()
    assert "cudaGetDevice(&previous_)" in header and "previous_ != device" in header
    assert "~DeviceScope()" in header and "cudaSetDevice(previous_)" in header


def _cuda_path(module: str, function: str = r"_\w+_cuda") -> str:
    """Source of `ops/<module>`'s `_..._cuda` function (the one named,
    where a module holds two), the code a CUDA tensor runs."""
    text = (REPO / "pointseg_torch" / "ops" / module).read_text()
    (body,) = re.findall(rf"\ndef {function}\(.*?(?=\n(?:def|class) |\Z)", text, flags=re.S)
    return body


LIBRARY_IN_SOURCE = r"cublas|cutlass|thrust|cub::|torch/"
LIBRARY_IN_WRAPPER = r"torch\.(topk|sort|cdist|matmul|bmm|gather|index_select|compile)|_plain\("


def test_edge_reduce_source_holds_its_forward_and_backward_kernels():
    """EdgeConv's gather-reduce is two `__global__` kernels of its own,
    reaching for no library; its wrapper calls no PyTorch reduction or
    gather on a CUDA tensor."""
    source = (_kernels.CSRC / "edgereduce.cu").read_text()
    assert re.findall(r"__global__ void (\w+)", source) == [
        "edge_reduce_kernel", "edge_reduce_backward_kernel"]
    assert not re.search(LIBRARY_IN_SOURCE, source)
    for function in ("_edge_reduce_cuda", "_edge_reduce_backward_cuda"):
        body = _cuda_path("edgereduce.py", function)
        assert not re.search(LIBRARY_IN_WRAPPER + r"|amax|amin|\.sum\(|index_add", body)


def test_knn_source_holds_two_selection_kernels_and_the_gather_one():
    """The flat and the two-level kNN are distinct `__global__` kernels,
    the gather one; none of the sources reaches for a library."""
    knn = (_kernels.CSRC / "knn.cu").read_text()
    gather = (_kernels.CSRC / "gather.cu").read_text()
    names = re.findall(r"__global__ void (\w+)", knn)
    assert {"knn_flat_kernel", "knn_two_level_kernel"} <= set(names)
    assert re.findall(r"__global__ void (\w+)", gather) == ["gather_rows_kernel",
                                                            "gather_rows_flat_kernel"]
    for text in (knn, gather):
        assert not re.search(LIBRARY_IN_SOURCE, text)
    assert not re.search(LIBRARY_IN_WRAPPER, _cuda_path("knn.py"))
    assert not re.search(LIBRARY_IN_WRAPPER, _cuda_path("gather.py", "_gather_rows_cuda"))


def test_knn_kernels_round_every_product_and_stream_the_tile():
    """The score arithmetic stays exact: every product and sum in `knn.cu`
    is a rounding intrinsic and the build forbids contraction, so no fused
    multiply-add can change a near-tie. The flat kernel is the register
    tile (rows per warp a template argument, a bound on its registers),
    fed by asynchronous copies; the two-level kernel scores with the same
    tile and copies, and selects with its own lane stacks and rounds."""
    knn = (_kernels.CSRC / "knn.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in knn.splitlines())  # comments off
    assert "--fmad=false" in _kernels.NVCC_FLAGS
    assert "__fmul_rn" in code and "__fadd_rn" in code and "__fsub_rn" in code
    assert not re.search(r"fmaf?\(|__fmaf_|mma\.|wmma|wgmma", code)
    # no bare float product or sum of two values: arithmetic goes through the intrinsics
    (flat,) = re.findall(r"__global__ void knn_flat_kernel\(.*?\n}\n", code, flags=re.S)
    (add,) = re.findall(r"void add_products\(.*?\n}\n", code, flags=re.S)
    assert "__fadd_rn(acc[r][j], __fmul_rn(q[r], c[j]))" in add
    assert flat.count("add_products<kRows>(") == 5 and "raw_score(acc[r][j], q2, c2[j])" in flat
    assert re.search(r"template <bool kVec, int kRows>\n__launch_bounds__\(kWarps \* 32,", code)
    assert "cp.async.cg.shared.global" in code and "cp.async.wait_group" in code
    assert flat.count("__syncthreads()") == 1  # one barrier a chunk
    for rows in (8, 4, 2):
        assert f"launch_flat<true, {rows}>" in code and f"launch_flat<false, {rows}>" in code
    (two,) = re.findall(r"__global__ void knn_two_level_kernel\(.*?\n}\n", code, flags=re.S)
    assert two.count("add_products<kRows>(") == 5 and "finish_score(acc[r][j], q2, c2[j])" in two
    assert two.count("__syncthreads()") == 1 and "copy_async_4(qdst" in two
    assert re.search(
        r"template <bool kVec, int kRows, int Depth>\n__launch_bounds__\(kWarps \* 32,", code)
    for depth in (1, 4, 5):
        assert f"launch_two_level_rows<{depth}>(" in code
    for rows in (4, 2):  # the rows a warp `two_level_rows` may choose
        assert f"launch_two_level_vec<{rows}, Depth>(" in code
    assert "launch_two_level_vec<8, Depth>(" not in code
    assert 'extern "C" int pointseg_knn(' in code and 'extern "C" int pointseg_knn_2l(' in code


def test_flat_gather_has_a_kernel_of_its_own_and_no_switch_to_the_plain_version():
    """On a CUDA tensor `gather_rows_flat` reaches `_gather_rows_flat_cuda`
    and nothing else; that function launches `pointseg_gather_rows_flat`
    and holds no library gather, no plain version and no `try`. The
    entry point takes 64-bit sizes, and the kernel computes every offset
    in 64 bits and traps on an index outside the table."""
    path = _cuda_path("gather.py", "_gather_rows_flat_cuda")
    assert not re.search(LIBRARY_IN_WRAPPER + r"|torch\.take|\btry\b|\[rows\]|\[idx\]", path)
    assert '"gather_rows_flat", "pointseg_gather_rows_flat"' in path
    # the call does nothing twice: an int64 contiguous index passes as it is,
    # one allocation, the row's bytes from a stride, and every check is still there
    assert "if idx.dtype != torch.int64 or not idx.is_contiguous():\n" \
           "        idx = idx.to(torch.int64).contiguous()" in path
    assert path.count("new_empty(") == 1 and "torch.empty(" not in path and "math." not in path
    assert "out.stride(0) * out.element_size()" in path
    assert "idx.device != table.device" in path and "not table.is_contiguous()" in path
    public = inspect.getsource(ops.gather_rows_flat)
    assert re.search(r"if _kernels\.on_cuda\(table\):\n\s+return _gather_rows_flat_cuda\(", public)
    assert public.count("gather_rows_flat_plain(") == 1 and "try" not in public
    assert "idx.dim() != 1" in public and "is_floating_point()" in public
    assert "torch.bool" in public and "table.dim() < 1" in public
    assert _kernels._SIGNATURES["pointseg_gather_rows_flat"][3:6] == (ctypes.c_int64,) * 3
    source = (_kernels.CSRC / "gather.cu").read_text()
    (kernel,) = re.findall(r"__global__ void gather_rows_flat_kernel\(.*?\n}\n", source, flags=re.S)
    assert "__trap()" in kernel and "static_cast<size_t>(src) * units" in kernel
    assert "const long long* __restrict__ idx" in kernel and "__shared__" not in kernel
    assert "atomic" not in kernel


def test_device_store_gathers_its_point_tables_through_gather_rows_flat():
    """Every gather from a per-point table in `data/device.py`'s samplers
    is `gather_rows_flat`: no indexing, `index_select`, `take` or `gather`
    touches `points`, `labels` or `packed`, and nothing there reads a
    device value on the host."""
    from pointseg_torch.data import device as dev

    flat = inspect.getsource(dev._sample_batch)
    packed = inspect.getsource(dev._sample_batch_packed)
    assert flat.count("gather_rows_flat(") == 2 and packed.count("gather_rows_flat(") == 1
    for text in (flat, packed, inspect.getsource(dev._choose_rows),
                 inspect.getsource(dev._finish_batch), inspect.getsource(dev._unpack),
                 inspect.getsource(dev._Shard.local), inspect.getsource(dev._assemble),
                 inspect.getsource(dev._DeviceStoreBase.sample),
                 inspect.getsource(dev.DeviceEpochLoader.__iter__),
                 inspect.getsource(dev.DeviceEpochLoader.scan_epoch)):
        body = text.split('"""')[-1]  # past the docstring
        assert not re.search(r"index_select|torch\.take|torch\.gather|\.item\(|nonzero|"
                             r"\bint\(|\bfloat\(|\.cpu\(|\.numpy\(|\.tolist\(|"
                             r"(points|labels|packed)\[", body), text


def test_ball_query_source_holds_two_selection_kernels():
    """The flat and the two-level ball query are distinct `__global__`
    kernels with an entry point each; the source reaches for no library
    and the wrapper's CUDA path for no PyTorch selection or plain version."""
    source = (_kernels.CSRC / "ballquery.cu").read_text()
    names = re.findall(r"__global__ void (\w+)", source)
    assert names == ["ball_query_kernel", "ball_query_two_level_kernel"]
    assert not re.search(LIBRARY_IN_SOURCE, source)
    for depth in (1, 4):  # the depths the wrapper may ask for
        assert f"launch_two_level_groups<{depth}>(" in source
    assert "launch_two_level_groups<5>(" not in source
    for groups in (1, 2):  # the balls a warp `pick_two_level` may choose
        assert f"launch_two_level<{groups}, Depth>(" in source
    assert "launch_two_level<4, Depth>(" not in source
    path = _cuda_path("ballquery.py")
    assert not re.search(LIBRARY_IN_WRAPPER, path)
    assert '"pointseg_ball_query"' in path and '"pointseg_ball_query_2l"' in path


def test_batched_gather_call_does_nothing_twice_and_takes_two_tables():
    """On a CUDA tensor `gather_rows` and `gather_rows_with_coords` reach
    `_gather_rows_cuda`, one launch of `pointseg_gather_rows`, with no
    library gather, no plain version and no `try`. The call does nothing
    twice: an int32 contiguous `idx` passes as it is, a table is copied
    only when it is not contiguous, one check function, outputs from
    `new_empty`; a table that needs no gradient skips the autograd node,
    and the coordinates are a second table, never concatenated. The
    kernel copies rows by bytes (two unit types, one a table) and traps
    on an index outside the table."""
    path = _cuda_path("gather.py", "_gather_rows_cuda")
    assert not re.search(LIBRARY_IN_WRAPPER + r"|\btry\b|torch\.cat", path)
    assert path.count('"gather_rows", "pointseg_gather_rows"') == 1
    assert "if idx.dtype != torch.int32 or not idx.is_contiguous():\n" \
           "        idx = idx.to(torch.int32).contiguous()" in path
    assert "if not table.is_contiguous():\n        table = table.contiguous()" in path
    assert path.count("_check_batched(") == 1 and "_kernels.check(" not in path
    assert path.count("new_empty(") == 2 and "torch.empty(" not in path
    for public in (ops.gather_rows, ops.gather_rows_with_coords):
        text = inspect.getsource(public).split('"""')[-1]
        assert re.search(r"if \w+\.requires_grad and torch\.is_grad_enabled\(\):\n"
                         r"\s+return _GatherRows\.apply\(", text)
        assert "torch.cat" not in text and "_gather(" in text
    assert _kernels._SIGNATURES["pointseg_gather_rows"][8:10] == (ctypes.c_int64,) * 2
    source = (_kernels.CSRC / "gather.cu").read_text()
    (kernel,) = re.findall(r"template <typename T, typename U>\n__global__ void "
                           r"gather_rows_kernel\(.*?\n}\n", source, flags=re.S)
    assert "__trap()" in kernel and "__shared__" not in kernel and "atomic" not in kernel
    for unit in ("uint4", "uint2", "uint32_t", "uint16_t", "uint8_t"):
        assert f"launch_second<{unit}>(r)" in source


def test_fps_register_kernel_keeps_points_in_registers_with_one_barrier_a_step():
    """The register path is a template on (threads, P), bounded to its
    block size; a step's argmax is `redux.sync` of an order-preserving key
    and a ballot for the lowest lane holding it (neighbouring points a
    thread), with one `__syncthreads` a step over two alternating slot
    sets; the distance arithmetic is rounded operation by operation;
    the picks go to global memory once, after the loop. The wrapper
    allocates the distance scratch only for clouds past shared memory."""
    source = (_kernels.CSRC / "fps.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in source.splitlines())
    (kernel,) = re.findall(r"template <int kThreads, int P>\n__launch_bounds__\(kThreads\)\n"
                           r"__global__ void fps_register_kernel\(.*?\n}\n", code, flags=re.S)
    loop = kernel[kernel.index("for (int step = 0;"):kernel.rindex("__syncthreads();")]
    assert loop.count("__syncthreads()") == 1 and "s_key[slot][warp]" in loop
    assert "__shared__ unsigned s_key[2][kWarps];" in kernel
    assert "picks[step] = far" in loop and "out[" not in loop and "out[" in kernel
    assert "__reduce_max_sync" in code and "__ballot_sync" in code
    assert "tid * P + j" in kernel  # a lower lane holds lower indices
    (dist,) = re.findall(r"float sq_dist\(.*?\n}\n", code, flags=re.S)
    assert dist.count("__fsub_rn") == 3 and dist.count("__fmul_rn") == 3
    assert dist.count("__fadd_rn") == 2 and "fminf(dist[j], sq_dist(" in kernel
    assert "if (md[j + width] > md[j])" in kernel  # strict: the first maximum wins
    fps_path = _cuda_path("fps.py")
    assert "if N > MAX_SMEM_POINTS else None" in fps_path and "torch.empty(" not in fps_path
    assert re.search(r"constexpr int kMaxSmemPoints = (\d+);", code).group(1) == str(
        ops.fps.MAX_SMEM_POINTS)


def test_ball_query_and_three_nn_calls_do_nothing_twice_and_launch_once():
    """On a CUDA tensor `ball_query`, `ball_query_raw` and `three_nn` reach
    `_ball_query_cuda` / `_three_nn_cuda` and nothing else: one launch,
    f32 contiguous inputs passed as they are, each input checked once,
    both outputs from `new_empty`, no plain version, no `try`; the repeat
    filler is the kernel's flag, and `torch.where` writes it only on the
    CPU."""
    for module in ("ballquery.py", "interpolate.py"):
        path = _cuda_path(module)
        assert not re.search(LIBRARY_IN_WRAPPER + r"|\btry\b|torch\.where|_kernels\.check\(|"
                             r"torch\.empty\(|\.detach\(", path), module
        assert path.count("new_empty(") == 2 and path.count("_kernels.launch(") == 1 + (
            module == "ballquery.py")
        assert path.count("dtype != torch.float32 or not") == 2
    select = inspect.getsource(ops.ballquery._select)
    assert re.search(r"if _kernels\.on_cuda\(coords\):\n\s+return _ball_query_cuda\(", select)
    assert select.index("return _ball_query_cuda(") < select.index("torch.where(")
    assert 'repeat=filler == "repeat"' in inspect.getsource(ops.ball_query)
    bq = _cuda_path("ballquery.py")
    assert "*args, repeat," in bq
    assert "*args, depth,\n                        repeat, *config)" in bq
    three = inspect.getsource(ops.three_nn)
    assert re.search(r"if _kernels\.on_cuda\(coords_src\):\n(.*\n){2}\s+return _three_nn_cuda\(",
                     three)


def test_flat_ball_query_and_three_nn_kernels_vote_once_a_chunk_and_round_every_step():
    """Both kernels, and the two-level ball query, which scans as the flat
    one does, test a chunk of points against all of a warp's lists with
    one vote and take candidates only behind it; the distance is the
    Gram form rounded operation by operation (no fused multiply-add); the
    ball query ranks a sparse ball's members instead of sorting them, and
    3-NN finds a chunk's nearest candidates with `redux.sync`."""
    for name, kernel in (("ballquery.cu", "ball_query_kernel"), ("threenn.cu", "three_nn_kernel"),
                         ("ballquery.cu", "ball_query_two_level_kernel")):
        code = "\n".join(line.split("//")[0]
                         for line in (_kernels.CSRC / name).read_text().splitlines())
        assert not re.search(r"fmaf?\(|__fmaf_|mma\.|wmma|" + LIBRARY_IN_SOURCE, code)
        (body,) = re.findall(rf"__global__ void {kernel}\(.*?\n}}\n", code, flags=re.S)
        assert body.count("__any_sync(kFull, hit)") == 1, name
        (gram,) = re.findall(r"float gram_sqdist\(.*?\n}\n", code, flags=re.S)
        assert gram.count("__fmul_rn") == 4 and gram.count("__fadd_rn") == 3
        assert gram.count("__fsub_rn") == 1
    bq = (_kernels.CSRC / "ballquery.cu").read_text()
    assert "write_sparse(" in bq and "rank += before(" in bq
    assert "__reduce_min_sync" in (_kernels.CSRC / "threenn.cu").read_text()


# what `torch.distributed` may be asked for: the two collectives that gloo has
# for CUDA tensors, and setting the groups up
DIST_CALLS = {"all_reduce", "broadcast", "init_process_group", "new_group",
              "destroy_process_group", "is_available", "is_initialized", "get_rank",
              "get_world_size", "get_backend", "FileStore"}


@pytest.mark.parametrize("path", sorted((REPO / "pointseg_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_collectives_are_all_reduce_and_broadcast_only(path):
    """Every collective of the port (data, tensor and point parallelism,
    the sharded store) is a sum `all_reduce` or a `broadcast`, so one path
    serves gloo, which has no other for CUDA tensors, and NCCL; nothing
    builds on `DTensor`, whose sharding rules know none of the port's
    operators."""
    text = path.read_text()
    used = set(re.findall(r"\btorch\.distributed\.(\w+)", text))
    if "import torch.distributed as dist" in text:
        used |= set(re.findall(r"\bdist\.(\w+)", text))
    assert used <= DIST_CALLS, (path.name, used - DIST_CALLS)
    assert "DTensor" not in text and "torch.distributed.tensor" not in text
    assert not re.search(r"ReduceOp\.(MAX|MIN|PRODUCT|AVG)", text)
