"""pointseg_torch.nn blocks against pointseg.nn on the CPU.

Each block is initialised in JAX (with random BatchNorm scales, biases
and running statistics), its variables are carried into the port with
the same conversion `from_jax_variables` uses, and both run on the same
numpy inputs: in eval mode (running statistics) and in train mode (batch
statistics), where the updated running statistics, and the gradients of
a fixed linear readout, must agree as well. FPS starts at 0 in both.

Tolerance: rtol/atol 1e-4 on outputs and statistics. Matrix products
and BatchNorm reductions sum in another order in the two frameworks, and
BatchNorm divides by a batch standard deviation that can be small, so
float32 differences of a few ulps grow to ~1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointseg.nn.blocks import FeaturePropagation as JaxFP
from pointseg.nn.blocks import GroupedFirstLayer as JaxGroupedFirstLayer
from pointseg.nn.blocks import SetAbstraction as JaxSA
from pointseg.nn.mlp import SharedMLP as JaxSharedMLP
from pointseg_torch.io.jax_import import _Reader
from pointseg_torch.nn import (
    FeaturePropagation,
    GroupedFirstLayer,
    SetAbstraction,
    SharedMLP,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _randomized(variables, seed):
    """BatchNorm scale/bias and running stats away from their init."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = flatten_dict(tree)
        for path, v in flat.items():
            v = np.asarray(v)
            if path[-1] in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, v.shape)
            elif path[-1] == "mean" or (path[-1] == "bias" and col == "params"):
                v = rng.normal(0, 0.1, v.shape)
            flat[path] = np.asarray(v, np.float32)
        out[col] = unflatten_dict(flat)
    return out


def _port_state(variables, emit, prefix):
    """Runs `emit(reader)` over variables nested under 'blk' and returns
    the produced state_dict entries whose key starts with `prefix`."""
    nested = {col: {"blk": tree} for col, tree in variables.items()}
    reader = _Reader(nested)
    emit(reader)
    assert not reader.leaves, sorted(reader.leaves)
    return {k[len(prefix):]: v for k, v in reader.sd.items()}


def _run_both(jax_module, port_module, variables, args, seed):
    """Eval and train forwards plus readout gradients; compares all."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(a) for a in args]

    port_module.eval()
    want = jax_module.apply(variables, *jargs, train=False)
    with torch.no_grad():
        got = port_module(*targs)
    want, got = (want[-1], got[-1]) if isinstance(want, tuple) else (want, got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    w = np.random.default_rng(seed).normal(size=np.shape(want)).astype(np.float32)

    def loss(params):
        out, upd = jax_module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *jargs, train=True, mutable=["batch_stats"])
        out = out[-1] if isinstance(out, tuple) else out
        return jnp.sum(out * w), (out, upd["batch_stats"])

    (_, (want_out, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    port_module.train()
    out = port_module(*targs)
    out = out[-1] if isinstance(out, tuple) else out
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    return new_stats, grads


def _check_against(port_module, emit, prefix, new_stats, grads):
    """Port running stats and grads vs JAX's, mapped through `emit`."""
    stats = _port_state({"params": jax.tree.map(np.asarray, grads),
                         "batch_stats": jax.tree.map(np.asarray, new_stats)},
                        emit, prefix)
    sd = port_module.state_dict()
    params = dict(port_module.named_parameters())
    for key, want in stats.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), want.numpy(), err_msg=key, **TOL)
        elif key in params:  # a gradient in parameter layout
            scale = 1.0 + float(np.abs(want.numpy()).max())
            np.testing.assert_allclose(params[key].grad.numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-4 * scale, err_msg=key)
    assert int(sd[next(k for k in sd if k.endswith("num_batches_tracked"))]) == 1


def _inputs(seed, B, N, D):
    rng = np.random.default_rng(seed)
    return (rng.random((B, N, 3)).astype(np.float32),
            rng.normal(size=(B, N, D)).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 50, 6), (2, 10, 4, 6)])
def test_shared_mlp_matches_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jm = JaxSharedMLP([8, 5])
    variables = _randomized(jm.init(jax.random.key(0), jnp.asarray(x)), 1)

    def emit(r):
        return r.mlp("blk", "blk", 2)

    port = SharedMLP(6, [8, 5])
    port.load_state_dict(_port_state(variables, emit, "blk."))
    new_stats, grads = _run_both(jm, port, variables, [x], seed=2)
    _check_against(port, emit, "blk.", new_stats, grads)


@pytest.mark.parametrize("normalize", [False, True])
def test_grouped_first_layer_matches_jax(normalize):
    coords, feats = _inputs(3, 2, 64, 4)
    cents = coords[:, :16].copy()
    jm = JaxGroupedFirstLayer(8, 0.3, 8, normalize=normalize)
    variables = _randomized(jm.init(jax.random.key(1), jnp.asarray(cents),
                                    jnp.asarray(coords), jnp.asarray(feats)), 4)

    def emit(r):
        return r.set_abstraction("blk", 1)

    # the JAX layer's own leaves sit where a SetAbstraction keeps them
    variables_sa = {col: {"point_net0": tree} for col, tree in variables.items()}
    port = GroupedFirstLayer(4, [8], 0.3, 8, normalize=normalize)
    port.load_state_dict(_port_state(variables_sa, emit, "blk.point_net."))
    new_stats, grads = _run_both(jm, port, variables, [cents, coords, feats], seed=5)
    _check_against(port, emit, "blk.point_net.",
                   {"point_net0": new_stats}, {"point_net0": grads})


def test_set_abstraction_matches_jax():
    coords, feats = _inputs(6, 2, 96, 4)
    jm = JaxSA(16, 0.3, [8, 8, 12], K=8)
    variables = _randomized(jm.init(jax.random.key(2), jnp.asarray(coords),
                                    jnp.asarray(feats)), 7)

    def emit(r):
        return r.set_abstraction("blk", 3)

    port = SetAbstraction(16, 0.3, 4, [8, 8, 12], K=8)
    port.load_state_dict(_port_state(variables, emit, "blk."))
    # centroids: the same FPS selection in both
    want_c, _ = jm.apply(variables, jnp.asarray(coords), jnp.asarray(feats))
    port.eval()
    with torch.no_grad():
        got_c, _ = port(torch.from_numpy(coords), torch.from_numpy(feats))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    new_stats, grads = _run_both(jm, port, variables, [coords, feats], seed=8)
    _check_against(port, emit, "blk.", new_stats, grads)


@pytest.mark.parametrize("with_skip", [True, False])
def test_feature_propagation_matches_jax(with_skip):
    rng = np.random.default_rng(9)
    tgt, skip = _inputs(10, 2, 64, 5)
    src = tgt[:, ::4].copy()
    feats = rng.normal(size=(2, 16, 6)).astype(np.float32)
    skip = skip if with_skip else None
    in_features = 6 + (5 if with_skip else 0)
    jm = JaxFP([12, 8])
    variables = _randomized(jm.init(jax.random.key(3), jnp.asarray(tgt), jnp.asarray(src),
                                    None if skip is None else jnp.asarray(skip),
                                    jnp.asarray(feats)), 11)

    def emit(r):
        return r.mlp("blk/point_net", "blk.point_net", 2)

    port = FeaturePropagation(in_features, [12, 8])
    port.load_state_dict(_port_state(variables, emit, "blk."))
    new_stats, grads = _run_both(jm, port, variables, [tgt, src, skip, feats], seed=12)
    _check_against(port, emit, "blk.", new_stats, grads)
