"""The port's `prepare` and `import-torch` subcommands, the out-of-memory
advice around `train` and the memory telemetry, against the JAX
package's on the CPU.

- `prepare --stage all` over `tests/test_cli.py`'s synthetic raw tree
  writes the same files as the JAX package's, with equal arrays.
- `import-torch` of a reference-layout `.pt` state_dict (a port model's,
  written in the reference's keys and 1x1 convolution shapes) gives back
  the port model's weights exactly, and, after the port's import and the
  JAX package's (`pointseg.cli.main`), checkpoints whose eval logits
  agree at rtol/atol 1e-4, for each of the five `--model` choices. The
  input is 256 points; as in `tests/test_torch_legacy.py`, selections
  agree between the packages at this size. A pickled model object is
  refused with its message.
- `is_oom_error` takes `torch.cuda.OutOfMemoryError` and the JAX
  package's strings; `train` prints `oom_advice` and re-raises.
- `get_memory_usage` has the JAX package's keys.
- Every subcommand and flag of the JAX CLI is taken by the port's;
  `--data-parallel` is the one refused.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointseg import cli as jax_cli
from pointseg.io.checkpoint import load_config as jax_load_config
from pointseg.io.checkpoint import restore_train_state as jax_restore
from pointseg.models import create_model as jax_create_model
from pointseg.runtime import oom_advice as jax_oom_advice
from pointseg.train.state import create_train_state as jax_train_state
from pointseg.utils.memory import get_memory_usage as jax_memory
from pointseg_torch import cli, runtime
from pointseg_torch.data import synthetic
from pointseg_torch.io.checkpoint import load_config, load_checkpoint, restore_train_state
from pointseg_torch.models import create_model
from pointseg_torch.train.state import create_train_state
from pointseg_torch.utils import memory

torch.set_num_threads(2)


def _raw_tree(root):
    """`tests/test_cli.py::test_prepare_pipeline`'s raw annotation tree."""
    raw = root / "raw" / "Area_1" / "office_1" / "Annotations"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in ["ceiling_1.txt", "floor_1.txt", "wall_1.txt"]:
        rows = np.concatenate([rng.uniform(0, 2, size=(800, 3)),
                               rng.uniform(0, 255, size=(800, 3))], axis=1)
        (raw / name).write_text("\n".join(" ".join(f"{v:.4f}" for v in r) for r in rows))
    return root / "raw"


def _prepare_args(raw, out):
    return ["prepare", "--input-path", str(raw), "--areas-path", str(out / "areas"),
            "--chunked-path", str(out / "chunks"), "--blocks-path", str(out / "blocks"),
            "--n-chunks", "2"]


def _same_file(a, b, root_a, root_b):
    if a.suffix == ".npz":
        with np.load(a, allow_pickle=False) as za, np.load(b, allow_pickle=False) as zb:
            assert sorted(za.files) == sorted(zb.files), a.name
            for key in za.files:
                np.testing.assert_array_equal(za[key], zb[key], err_msg=f"{a.name}:{key}")
    elif a.suffix == ".json":
        text_a = a.read_text().replace(str(root_a), "<root>")
        assert json.loads(text_a) == json.loads(b.read_text().replace(str(root_b), "<root>"))
    else:
        assert a.read_bytes() == b.read_bytes(), a.name


def test_prepare_writes_what_jax_writes(tmp_path):
    raw = _raw_tree(tmp_path)
    assert jax_cli.main(_prepare_args(raw, tmp_path / "jax")) == 0
    assert cli.main(_prepare_args(raw, tmp_path / "port")) == 0
    want = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                  if p.is_file())
    got = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                 if p.is_file())
    assert got == want
    assert {"areas/s3dis1.npz", "chunks/chunked_index.json",
            "blocks/block_to_coords_mapping.json"} <= {str(p) for p in got}
    assert any(str(p).startswith("blocks/area_1/") for p in got)
    for rel in got:
        _same_file(tmp_path / "port" / rel, tmp_path / "jax" / rel, tmp_path / "port",
                   tmp_path / "jax")


@pytest.mark.parametrize("stage", ["raw", "chunks", "index", "blocks"])
def test_prepare_runs_each_stage_on_its_own(tmp_path, stage):
    raw = _raw_tree(tmp_path)
    out = tmp_path / "port"
    for done in ["raw", "chunks", "index", "blocks"]:
        cli.main(_prepare_args(raw, out)[:1] + ["--stage", done] + _prepare_args(raw, out)[1:])
        if done == stage:
            break
    written = {"raw": out / "areas" / "s3dis1.npz", "chunks": out / "chunks",
               "index": out / "chunks" / "chunked_index.json",
               "blocks": out / "blocks" / "block_to_coords_mapping.json"}
    assert written[stage].exists()


IMPORT_MODELS = ["PointNet", "PointNet++", "PointNeXt", "DGCNN", "DeepGraphCnn"]


def _reference_layout(name, sd):
    """The reference's keys and shapes for a port state_dict: 1x1
    convolution weights (out, in, 1) where the port has Linear weights
    (PointNet's TNet `fc` layers are Linear in the reference too); the
    DGCNNs' EdgeConv as Sequential(Conv2d (out, 2F, 1, 1) over cat(x_j -
    x_i, x_i), BatchNorm2d) and their other layers as Sequential(Conv1d,
    BatchNorm1d) (`pointseg/io/torch_import.py` reads these)."""
    out = {}
    for key, value in sd.items():
        head, _, rest = key.partition(".")
        if name in ("DGCNN", "DeepGraphCnn") and head in ("conv1", "conv2", "conv3", "conv4"):
            if rest == "w_edge.weight":
                both = torch.cat([value, sd[f"{head}.w_center.weight"]], dim=1)
                out[f"{head}.conv.0.weight"] = both[..., None, None]
            elif rest.startswith("bn."):
                out[f"{head}.conv.1.{rest[3:]}"] = value
            continue
        if name in ("DGCNN", "DeepGraphCnn") and head in ("color_conv", "conv5", "conv6",
                                                          "conv7"):
            key = f"{head}.{rest.replace('conv.0.', '0.').replace('batch.0.', '1.')}"
        out[key] = value[..., None] if value.dim() == 2 and ".fc" not in key else value
    return out


def _reference_pt(name, path):
    """A reference-layout state_dict with BatchNorm statistics off init."""
    torch.manual_seed(3)
    model = create_model(name)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    torch.save(_reference_layout(name, model.state_dict()), path)
    return model


@pytest.mark.parametrize("name", IMPORT_MODELS)
def test_import_torch_gives_the_logits_jax_import_gives(name, tmp_path, capsys):
    pt = tmp_path / "reference.pt"
    original = _reference_pt(name, pt)
    path = cli.import_torch_from_args(cli.build_parser().parse_args(
        ["import-torch", "--torch-checkpoint", str(pt), "--model", name,
         "--out-dir", str(tmp_path / "port"), "--device", "cpu", "--num-points", "256"]))
    assert path.endswith("checkpoint_0.pt") and "Evaluate it with" in capsys.readouterr().out
    assert load_config(str(tmp_path / "port")) == jax_load_config(str(tmp_path / "port")) == {
        "model": name, "num_classes": 14, "imported_from": str(pt)}
    assert jax_cli.main(["import-torch", "--torch-checkpoint", str(pt), "--model", name,
                         "--out-dir", str(tmp_path / "jax"), "--num-points", "256"]) == 0

    x = np.random.default_rng(0).random((2, 256, 9)).astype(np.float32)
    x[..., :3] *= np.array([1.0, 1.0, 0.3], np.float32)
    jax_model = jax_create_model(name, num_classes=14)
    jstate = jax_restore(str(tmp_path / "jax"), jax_train_state(jax_model, jnp.asarray(x)))
    want = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, jnp.asarray(x))
    state = restore_train_state(str(tmp_path / "port"),
                                create_train_state(create_model(name), device="cpu"))
    assert state.step == 0 and load_checkpoint(path)["step"] == 0
    for key, value in original.state_dict().items():  # the port's own weights back
        assert torch.equal(state.model.state_dict()[key], value), key
    with torch.no_grad():
        got = state.model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_import_torch_refuses_a_pickled_model_and_a_wrong_layout(tmp_path):
    torch.save(create_model("DGCNN", emb_dims=32), tmp_path / "model.pt")
    with pytest.raises(SystemExit, match=r"pickled object.*model\.state_dict\(\)"):
        cli.main(["import-torch", "--torch-checkpoint", str(tmp_path / "model.pt"),
                  "--model", "DGCNN", "--out-dir", str(tmp_path / "out"), "--device", "cpu"])
    torch.save({"epoch": 3}, tmp_path / "dict.pt")
    with pytest.raises(SystemExit, match="not a state_dict of tensors"):
        cli.main(["import-torch", "--torch-checkpoint", str(tmp_path / "dict.pt"),
                  "--model", "DGCNN", "--out-dir", str(tmp_path / "out"), "--device", "cpu"])
    torch.save(create_model("DGCNN").state_dict(), tmp_path / "dgcnn.pt")
    with pytest.raises(RuntimeError, match="state_dict"):  # load_state_dict(strict=True)
        cli.main(["import-torch", "--torch-checkpoint", str(tmp_path / "dgcnn.pt"),
                  "--model", "DeepGraphCnn", "--out-dir", str(tmp_path / "out"),
                  "--device", "cpu"])
    assert not (tmp_path / "out").exists()


def test_is_oom_error_takes_the_card_error_and_the_jax_strings():
    assert runtime.is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to ..."))
    assert runtime.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: while allocating"))
    assert runtime.is_oom_error(RuntimeError("Out of memory allocating 4 GiB"))
    assert not runtime.is_oom_error(ValueError("shape mismatch"))
    assert runtime.oom_advice(8, 4096) == jax_oom_advice(8, 4096)
    assert runtime.oom_advice() == jax_oom_advice()


def test_train_prints_the_advice_and_reraises(tmp_path, monkeypatch, capsys):
    from pointseg_torch.train import loop

    def out_of_memory(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB")

    monkeypatch.setattr(loop, "train_step", out_of_memory)
    data = synthetic.make_block_dataset(str(tmp_path / "blocks"), rooms_per_area=1,
                                        points_per_room=1500, seed=0, rgb_u8=True)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        cli.main(["train", "PointNet", "--data-dir", data, "--device", "cpu", "--epochs", "1",
                  "--train-sampling", "64", "--num-workers", "0",
                  "--log-dir", str(tmp_path / "logs"), "--model-dir", str(tmp_path / "models")])
    assert runtime.oom_advice(8, 64) in capsys.readouterr().out


def test_memory_usage_has_the_jax_keys(monkeypatch):
    want = jax_memory()
    got = memory.get_memory_usage()
    assert got.keys() == want.keys() and got["host_rss_mb"] > 0
    if not torch.cuda.is_available():
        assert got["devices"] == []
        assert memory.format_memory_usage().startswith("host RSS: ")

    class Properties:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 3 * 2**20, "allocated_bytes.all.peak": 5 * 2**20})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Properties())
    (device,) = memory.get_memory_usage()["devices"]
    assert device.keys() == want["devices"][0].keys()
    assert device == {"device": "cuda:0", "bytes_in_use": 3 * 2**20,
                      "peak_bytes_in_use": 5 * 2**20, "bytes_limit": 80 * 2**30}
    assert memory.format_memory_usage().startswith("cuda:0: 3MB in use (peak 5MB); host RSS: ")


def _subparsers(parser):
    (sub,) = [a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction"]
    return sub.choices


def _subcommands(parser):
    return {name: {s for a in p._actions for s in a.option_strings}
            | {a.dest for a in p._actions if not a.option_strings}
            for name, p in _subparsers(parser).items()}


def test_every_jax_subcommand_and_flag_is_taken_and_none_refused():
    want = _subcommands(jax_cli.build_parser())
    got = _subcommands(cli.build_parser())
    assert set(want) <= set(got)
    for name, flags in want.items():
        assert flags <= got[name], (name, sorted(flags - got[name]))
    hidden = {name: [a.option_strings for a in p._actions if a.help == argparse.SUPPRESS]
              for name, p in _subparsers(cli.build_parser()).items()}
    assert not any(hidden.values()), hidden  # a flag refused was a hidden one
