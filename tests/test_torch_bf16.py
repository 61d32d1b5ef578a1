"""bf16 compute in pointseg_torch against the JAX package's `dtype=bfloat16`
on the CPU: the same numpy inputs and the same weights (JAX-initialised,
BatchNorm moved off its init, carried into the port by the conversion of
`pointseg_torch/io/jax_import.py`) through the JAX bf16 module and the
port's (`dtype=torch.bfloat16`), block by block and model by model.

The JAX side is compiled with XLA's excess precision off
(`strict_jit`): by default XLA's fusions keep bf16 intermediates in
float32, so a jitted forward rounds at fewer places than the JAX
package's own module code says, and than the port does (DGCNN's logits:
0.099 from the port's with it, 0.008 without, as op by op).

Tolerances. bf16 keeps 8 significant bits, and the two frameworks round
at other places (a product's sum order, where a cast falls: the port
adds a Linear's bias before its one rounding, flax after it), so
activations and logits are held to max |Δ| <= 2e-2 x max |ref| and the
loss to 2e-2 relative (as `tests/test_train.py` holds the JAX package's
own bf16 loss against its float32 one). That bound sits near bf16's own
noise for the PointNet++ family's logits: there the JAX package's bf16
lies 0.83-2.04e-2 x max from its float32 one, and the port's from the JAX
package's 1.06-1.58e-2 at these weights (PointNet and the DGCNNs:
0.32-0.73e-2). A second, sharper check holds
both packages' bf16 results against the JAX package's float32 result:
the port's max |Δ| may not exceed 1.5 x the JAX package's plus one bf16
ulp at the result's scale.

Gradients are held against the JAX package's bf16 gradient directly
(`gradient_readings`, `gradient_faults`) at the leaves where it carries
its float32 gradient: where JAX's bf16 lies within 0.2 x the float32
leaf's norm of it. Over those leaves together a Euclidean distance, a
cosine and the sharper check in Euclidean norm; at each of them a cosine
and the norm ratio; the other leaves' norm, which is rounding noise in
both packages (a Linear's bias before a training BatchNorm, whose exact
gradient is 0), no more than 1.5 x JAX's. The bounds come from readings
(beside the constants), and every check is shown to bite: a zero
gradient, the port's gradient shuffled within each leaf and the port's
gradient with its largest carrying leaf scaled by 0.9 must each fail. A
float32 gradient in place of the bf16 one would pass: the two packages
round at other places, so the port's bf16 gradient lies as far from
JAX's bf16 one as either lies from float32. 2e-2 x max |ref| per leaf
does not hold for gradients in either package: JAX's own bf16 eval-mode
gradient lies up to 0.54 x max from its float32 one at a leaf
(DeepGraphCnn's conv3 edge weights).

Train mode at model depth. A train-mode BatchNorm normalises with its
batch's statistics, and a channel whose mean is several times its spread
turns the rounding of its input into a larger error of its output: in
PointNet++ the bf16 activations lie 5e-3 from float32 at the first
BatchNorm and 0.54 at the last, the 22nd
(`test_bf16_train_forward_error_grows_through_batchnorms`). So in a
train step only the head's leaves (the last Linear and BatchNorm, 2-4
of 27-154) carry their gradient in bf16, in either package (JAX's
cosine over the whole gradient with float32: PointNet++ 0.23, MSG 0.41,
PointNeXt -0.03, PointNet and the DGCNNs 0.77-0.94). The models'
gradients are held leaf by leaf in eval mode (BatchNorm on running
statistics; 23-150 leaves carry), the train-mode backward in the blocks
(1-3 BatchNorms each), and a train step at its head. Selections (FPS, ball query, 3-NN on
float32 coordinates; DGCNN's kNN on bf16-rounded inputs) are equal index
for index at the pinned input seeds of the f32 model tests. Dtypes:
logits float32; parameters, gradients and Adam state float32; block
outputs bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointseg import ops as jops
from pointseg.models import create_model as jax_create_model
from pointseg.nn.blocks import EdgeConv as JaxEdgeConv
from pointseg.nn.blocks import FeaturePropagation as JaxFP
from pointseg.nn.blocks import GroupedFirstLayer as JaxGroupedFirstLayer
from pointseg.nn.blocks import InvResMLP as JaxInvResMLP
from pointseg.nn.blocks import SetAbstraction as JaxSA
from pointseg.nn.blocks import TNet as JaxTNet
from pointseg.nn.mlp import SharedMLP as JaxSharedMLP
from pointseg.ops.dispatch import set_use_pallas
from pointseg.train.loss import masked_onehot_cross_entropy as jax_ce
from pointseg_torch import ops as tops
from pointseg_torch.io import from_jax_variables
from pointseg_torch.io.jax_import import _Reader, _tnet
from pointseg_torch.models import create_model
from pointseg_torch.nn import (
    BatchNorm,
    EdgeConv,
    FeaturePropagation,
    GroupedFirstLayer,
    InvResMLP,
    SetAbstraction,
    SharedMLP,
    TNet,
)
from pointseg_torch.ops.gather import gather_rows, gather_rows_plain
from pointseg_torch.train.loss import masked_onehot_cross_entropy
from pointseg_torch.train.state import TrainState, make_optimizer, train_step
from test_torch_blocks import _inputs, _port_state, _randomized
from test_torch_model import _assert_same_selections as _pnpp_selections
from test_torch_pointnext import _assert_same_selections as _pnext_selections

torch.set_num_threads(2)

BF16 = torch.bfloat16
REL = 2e-2  # of max |ref|: activations and logits; the loss relative
# Gradient bounds (`gradient_faults`), each about 1.5x the worst reading
# beside it, taken with the inputs and weights of this file. The scaled
# control (one leaf x 0.9, a norm ratio of 1.11) breaks every `leaf_norm`.
# blocks, train mode, the carrying leaves (6-10 of 9-23): distance
# 0.009-0.089 (TNet 0.130), cosine >= 0.9960 (TNet 0.9915), sharper <= 1.02,
# leaf cosine >= 0.9923 (TNet 0.9875), leaf norm ratio <= 1.048, noise <= 1.0
BLOCK_GRADIENT = dict(distance=0.15, cosine=0.985, sharper=1.5, leaf_cosine=0.98,
                      leaf_norm=1.08, noise_norm=1.5)
# models, eval mode (23-150 of 27-154 leaves carry): distance 0.002-0.043,
# cosine >= 0.9991, sharper <= 1.12, leaf cosine >= 0.9955, leaf norm ratio
# <= 1.067, noise <= 1.0
MODEL_GRADIENT = dict(distance=0.06, cosine=0.998, sharper=1.5, leaf_cosine=0.99,
                      leaf_norm=1.09, noise_norm=1.5)
# one train step (2-4 leaves carry: the head): distance 0.025-0.083, cosine
# >= 0.9966, sharper <= 1.035, leaf cosine >= 0.988, leaf norm ratio <= 1.022,
# noise <= 1.09
TRAIN_GRADIENT = dict(distance=0.12, cosine=0.994, sharper=1.5, leaf_cosine=0.98,
                      leaf_norm=1.05, noise_norm=1.5)


@pytest.fixture(autouse=True)
def _jax_oracle():
    """The JAX package's plain (non-Pallas) ops, as its CPU tests run them."""
    set_use_pallas(False)
    yield
    set_use_pallas(None)


def strict_jit(fn):
    """`jax.jit(fn)` compiled with `xla_allow_excess_precision` off, so that
    every bf16 the module code writes is rounded to bf16."""
    def run(*args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    return run


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def ulp_bf16(scale: float) -> float:
    """One bf16 ulp at magnitude `scale` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


def assert_close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= REL * scale, (what, err, scale)


def assert_sharper(got, want_bf16, want_f32, what):
    """The port's bf16 no farther from JAX's float32 (max |Δ|) than 1.5 x
    JAX's own bf16 is, plus one bf16 ulp at the float32 result's scale."""
    got, want_bf16, want_f32 = _np(got), _np(want_bf16), _np(want_f32)
    ours = float(np.abs(got - want_f32).max())
    theirs = float(np.abs(want_bf16 - want_f32).max())
    bound = 1.5 * theirs + ulp_bf16(float(np.abs(want_f32).max()))
    assert ours <= bound, (what, ours, theirs, bound)


def _cos(a, b):
    return float(a @ b) / max(float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-30)


def _carrying(want_bf16, want_f32):
    return [k for k in want_bf16 if np.linalg.norm(_np(want_bf16[k]) - _np(want_f32[k]))
            <= 0.2 * np.linalg.norm(_np(want_f32[k]))]


def gradient_readings(mine, want_bf16, want_f32):
    """How far the port's bf16 gradient (a dict leaf -> array) lies from
    JAX's bf16 gradient. A leaf carries its gradient in bf16 where JAX's
    bf16 lies within 0.2 x the float32 gradient's norm of it; the others
    (a Linear's bias before a BatchNorm in training, whose exact gradient
    is 0, is rounding noise in both packages) do not. Over the carrying
    leaves together: the distance |mine - bf16| / |bf16|, the cosine, and
    the sharper ratio |mine - f32| / (|bf16 - f32| + one bf16 ulp at the
    float32 gradient's largest element); at each carrying leaf the cosine
    and the ratio of the larger to the smaller of |mine| and |bf16|; over
    the other leaves the norm ratio |mine| / |bf16|."""
    m, b, f = ({k: _np(d[k]).ravel().astype(np.float64) for k in sorted(mine)}
               for d in (mine, want_bf16, want_f32))
    carry = _carrying(b, f)
    noise = [k for k in m if k not in carry]
    mv, bv, fv = (np.concatenate([d[k] for k in carry]) for d in (m, b, f))
    ulp = ulp_bf16(float(np.abs(fv).max()))
    joined = lambda d: np.concatenate([d[k] for k in noise] or [np.zeros(1)])  # noqa: E731
    return {
        "carrying": f"{len(carry)} of {len(m)}",
        "distance": np.linalg.norm(mv - bv) / np.linalg.norm(bv),
        "cosine": _cos(mv, bv),
        "sharper": np.linalg.norm(mv - fv) / (np.linalg.norm(bv - fv) + ulp),
        "leaf_cosine": min(_cos(m[k], b[k]) for k in carry),
        "leaf_norm": max(max(p, q) / max(min(p, q), 1e-30) for p, q in (
            (np.linalg.norm(m[k]), np.linalg.norm(b[k])) for k in carry)),
        "noise_norm": np.linalg.norm(joined(m)) / max(np.linalg.norm(joined(b)), 1e-30)
        if noise else 1.0,
    }


def gradient_faults(mine, want_bf16, want_f32, bounds):
    """The readings of `gradient_readings` that break `bounds`: distance,
    sharper, leaf_norm and noise_norm at most, cosine and leaf_cosine at
    least their bound (the sharper one's is 1.5)."""
    got = gradient_readings(mine, want_bf16, want_f32)
    at_least = ("cosine", "leaf_cosine")
    return {k: got[k] for k, bound in bounds.items()
            if (got[k] < bound if k in at_least else not got[k] <= bound)}


def assert_gradients(mine, want_bf16, want_f32, what, bounds):
    """`gradient_faults` finds nothing in the port's gradient, and finds
    something in each control: a zero gradient, the port's own gradient
    shuffled within each leaf, and the port's gradient with its largest
    carrying leaf scaled by 0.9."""
    assert not gradient_faults(mine, want_bf16, want_f32, bounds), (
        what, gradient_faults(mine, want_bf16, want_f32, bounds))
    rng = np.random.default_rng(0)
    mine = {k: _np(g) for k, g in mine.items()}
    zero = {k: np.zeros_like(g) for k, g in mine.items()}
    shuffled = {k: rng.permutation(g.ravel()) for k, g in mine.items()}
    big = max(_carrying({k: want_bf16[k] for k in mine}, want_f32),
              key=lambda k: np.linalg.norm(_np(want_f32[k])))
    scaled = {**mine, big: 0.9 * mine[big]}
    for control in (zero, shuffled, scaled):
        assert gradient_faults(control, want_bf16, want_f32, bounds), what


# ---------------------------------------------------------------- blocks


def _block_case(jax_cls, jax_kwargs, port, variables, to_port, args, seed, grad_arg=0,
                close=True):
    """Train-mode forward of the JAX block in bf16 and in float32 and of the
    port's bf16 block (its weights `to_port(variables)`), each with the
    same fixed linear readout of its last output; compares the outputs
    (by `assert_close` unless `close` is false, and by `assert_sharper`)
    and the gradients (parameters and input `grad_arg`). Returns the
    port's output."""
    port.load_state_dict(to_port(variables))
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    outs, grads, readout = {}, {}, {}
    for dtype in (jnp.bfloat16, jnp.float32):
        jm = jax_cls(**jax_kwargs, dtype=dtype)

        # every input an argument: a constant would be folded at compile time
        def loss(params, *call, jm=jm):
            out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              *call, train=True, mutable=["batch_stats"])
            out = (out[-1] if isinstance(out, tuple) else out)
            if dtype == jnp.bfloat16:
                assert out.dtype == jnp.bfloat16
            out = out.astype(jnp.float32)
            if "w" not in readout:
                readout["w"] = np.random.default_rng(seed).normal(size=out.shape)
            return jnp.sum(out * jnp.asarray(readout["w"], jnp.float32)), out

        (_, outs[dtype]), grads[dtype] = strict_jit(jax.value_and_grad(
            loss, argnums=(0, 1 + grad_arg), has_aux=True))(variables["params"], *jargs)

    port.train()
    targs = [None if a is None else _torch(a) for a in jargs]
    targs[grad_arg] = targs[grad_arg].clone().requires_grad_(True)
    got = port(*targs)
    got = got[-1] if isinstance(got, tuple) else got
    assert got.dtype == BF16
    (got.float() * torch.from_numpy(readout["w"]).float()).sum().backward()
    if close:
        assert_close(got, outs[jnp.bfloat16], "output")
    assert_sharper(got, outs[jnp.bfloat16], outs[jnp.float32], "output")

    params = dict(port.named_parameters())

    def by_leaf(g_params, g_x):
        sd = to_port({"params": jax.tree.map(np.asarray, g_params),
                      "batch_stats": variables["batch_stats"]})
        return {**{k: sd[k].numpy() for k in params}, "input": _np(g_x)}

    assert {p.grad.dtype for p in params.values()} == {torch.float32}
    mine = {**{k: p.grad for k, p in params.items()}, "input": targs[grad_arg].grad}
    assert_gradients(mine, by_leaf(*grads[jnp.bfloat16]), by_leaf(*grads[jnp.float32]),
                     "gradient", BLOCK_GRADIENT)
    return got


def _torch(a):
    """A JAX array as a torch tensor of the same dtype (float32 or bf16)."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(BF16) if a.dtype == jnp.bfloat16 else t


def _emitted(emit, prefix):
    return lambda tree: _port_state(tree, emit, prefix)


@pytest.mark.parametrize("shape", [(8, 512, 6), (8, 64, 16, 6)])
def test_shared_mlp_bf16_matches_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    variables = _randomized(JaxSharedMLP([8, 5]).init(jax.random.key(0), jnp.asarray(x)), 1)
    _block_case(JaxSharedMLP, dict(features=[8, 5]), SharedMLP(6, [8, 5], dtype=BF16),
                variables, _emitted(lambda r: r.mlp("blk", "blk", 2), "blk."), [x], seed=2)


def test_grouped_first_layer_bf16_matches_jax():
    """With `normalize` (PointNeXt's stem); without it, it runs inside
    `test_set_abstraction_bf16_matches_jax`."""
    normalize = True
    coords, feats = _inputs(3, 8, 256, 4)
    cents = coords[:, :64].copy()
    kwargs = dict(width=8, radius=0.3, K=8, normalize=normalize)
    variables = _randomized(JaxGroupedFirstLayer(**kwargs).init(
        jax.random.key(1), jnp.asarray(cents), jnp.asarray(coords), jnp.asarray(feats)), 4)

    def to_port(tree):  # the JAX layer's leaves sit where a SetAbstraction keeps them
        return _port_state({col: {"point_net0": t} for col, t in tree.items()},
                           lambda r: r.set_abstraction("blk", 1), "blk.point_net.")

    _block_case(JaxGroupedFirstLayer, kwargs,
                GroupedFirstLayer(4, [8], 0.3, 8, normalize=normalize, dtype=BF16),
                variables, to_port, [cents, coords, feats], seed=5, grad_arg=2)


def test_set_abstraction_bf16_matches_jax():
    coords, feats = _inputs(6, 8, 256, 4)
    kwargs = dict(num_centroids=64, radius=0.3, mlps=[8, 8, 12], K=8)
    variables = _randomized(JaxSA(**kwargs).init(jax.random.key(2), jnp.asarray(coords),
                                                 jnp.asarray(feats)), 7)
    _block_case(JaxSA, kwargs, SetAbstraction(64, 0.3, 4, [8, 8, 12], K=8, dtype=BF16),
                variables, _emitted(lambda r: r.set_abstraction("blk", 3), "blk."),
                [coords, feats], seed=8, grad_arg=1)


@pytest.mark.parametrize("with_skip", [True, False])
def test_feature_propagation_bf16_matches_jax(with_skip):
    """The interpolated rows come from bf16 features through the gather,
    summed in float32 and cast once (both packages)."""
    rng = np.random.default_rng(9)
    tgt, skip = _inputs(10, 8, 256, 5)
    src = tgt[:, ::4].copy()
    feats = rng.normal(size=(8, 64, 6)).astype(np.float32)
    skip = skip if with_skip else None
    variables = _randomized(JaxFP([12, 8]).init(
        jax.random.key(3), jnp.asarray(tgt), jnp.asarray(src),
        None if skip is None else jnp.asarray(skip), jnp.asarray(feats)), 11)
    port = FeaturePropagation(6 + (5 if with_skip else 0), [12, 8], dtype=BF16)
    # the features arrive in bf16, as an SA stage's output does
    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    _block_case(JaxFP, dict(mlps=[12, 8]), port, variables,
                _emitted(lambda r: r.mlp("blk/point_net", "blk.point_net", 2), "blk."),
                [tgt, src, bf(skip), bf(feats)], seed=12, grad_arg=3)


def test_inv_res_mlp_bf16_matches_jax():
    coords, feats = _inputs(30, 8, 256, 8)
    kwargs = dict(radius=0.3, mlp_size=8, K=8)
    variables = _randomized(JaxInvResMLP(**kwargs).init(
        jax.random.key(4), jnp.asarray(coords), jnp.asarray(feats)), 31)
    feats = jnp.asarray(feats, jnp.bfloat16)  # a bf16 residual, as inside a model
    _block_case(JaxInvResMLP, kwargs, InvResMLP(0.3, 8, 8, dtype=BF16), variables,
                _emitted(lambda r: r.inv_res_mlp("blk"), "blk."), [coords, feats], seed=32,
                grad_arg=1)


def _edge_variables(seed, F_in, out):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 1.5, out)
    scale[::2] *= -1.0  # the fused form takes the min there
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"params": {"w_edge": {"kernel": f32(rng.normal(0, 0.4, (F_in, out)))},
                       "w_center": {"kernel": f32(rng.normal(0, 0.4, (F_in, out)))},
                       "bn": {"scale": f32(scale), "bias": f32(rng.normal(0, 0.1, out))}},
            "batch_stats": {"bn": {"mean": f32(rng.normal(0, 0.1, out)),
                                   "var": f32(rng.uniform(0.5, 1.5, out))}}}


@pytest.mark.parametrize("fused", [True, False])
def test_edgeconv_bf16_matches_jax(fused):
    """The graph is given, so that only values are compared; the rows are
    continuous, so no two neighbours tie."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 256, 6)).astype(np.float32)
    idx = rng.integers(0, 256, (8, 256, 8)).astype(np.int32)
    variables = _edge_variables(1, 6, 16)
    _block_case(lambda dtype, **kw: _JaxWithGraph(JaxEdgeConv(dtype=dtype, **kw), idx),
                dict(out_channels=16, k=8, fused=fused),
                _EdgeWithGraph(EdgeConv(6, 16, 8, fused=fused, dtype=BF16), idx), variables,
                _emitted(lambda r: r.edgeconv("blk"), "blk."), [x], seed=3)


class _EdgeWithGraph(torch.nn.Module):
    """An EdgeConv called on a fixed graph; its keys are the block's."""

    def __init__(self, block, idx):
        super().__init__()
        self.block, self.idx = block, torch.from_numpy(idx)

    def forward(self, x):
        return self.block(x, idx=self.idx)

    def load_state_dict(self, sd, **kwargs):
        return self.block.load_state_dict(sd, **kwargs)

    def named_parameters(self, *args, **kwargs):
        return self.block.named_parameters(*args, **kwargs)


class _JaxWithGraph:
    def __init__(self, block, idx):
        self.block, self.idx = block, jnp.asarray(idx)

    def apply(self, variables, x, **kwargs):
        return self.block.apply(variables, x, idx=self.idx, **kwargs)


def test_edgeconv_bf16_statistics_against_float64():
    """ROADMAP.md F9: the fused EdgeConv's training statistics in bf16, each
    package's against float64 statistics of the same edges, at activations
    whose mean is 8 times their spread (after a LeakyReLU and a BatchNorm
    shift, layer inputs are not centred). The JAX block sums s and q into
    bf16 and forms E[e^2] - E[e]^2 there, where it cancels; the port sums
    them in float32. Held: the port's batch variance within 2e-2 of
    float64's (relative, per channel; bf16 rounding of p and d is all that
    is left), and nearer than the JAX package's. Both printed."""
    rng = np.random.default_rng(5)
    x = (8.0 + rng.normal(size=(4, 512, 8))).astype(np.float32)
    idx = rng.integers(0, 512, (4, 512, 16)).astype(np.int32)
    v = _edge_variables(6, 8, 16)
    v["batch_stats"] = {"bn": {"mean": np.zeros(16, np.float32),
                               "var": np.zeros(16, np.float32)}}  # so the update is 0.1 x batch
    # float64: the edges e_ij = p_j + d_i from the bf16-rounded input
    xb = _np(jnp.asarray(x, jnp.bfloat16)).astype(np.float64)
    we = v["params"]["w_edge"]["kernel"].astype(np.float64)
    wc = v["params"]["w_center"]["kernel"].astype(np.float64)
    p, d = xb @ we, xb @ (wc - we)
    edges = p[np.arange(4)[:, None, None], idx] + d[:, :, None, :]
    want_var = edges.reshape(-1, 16).var(axis=0)

    _, upd = JaxEdgeConv(16, 16, dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x), train=True, idx=jnp.asarray(idx), mutable=["batch_stats"])
    jax_var = np.asarray(upd["batch_stats"]["bn"]["var"], np.float64) / 0.1
    block = EdgeConv(8, 16, 16, dtype=BF16).train()
    block.load_state_dict(_port_state(v, lambda r: r.edgeconv("blk"), "blk."))
    with torch.no_grad():
        block(torch.from_numpy(x), idx=torch.from_numpy(idx))
    port_var = block.bn.running_var.double().numpy() / 0.1
    err_port = float((np.abs(port_var - want_var) / want_var).max())
    err_jax = float((np.abs(jax_var - want_var) / want_var).max())
    print(f"bf16 EdgeConv batch variance, max relative error against float64: "
          f"port {err_port:.3g}, JAX {err_jax:.3g}")
    assert err_port < 2e-2 and err_port < err_jax, (err_port, err_jax)


def test_tnet_bf16_matches_jax():
    """TNet in bf16: the transform comes out bf16 with the identity added in
    bf16. In training its FC BatchNorms normalise over the B = 32 pooled
    rows, which magnifies the last-bit differences of the max-pool: there
    the JAX package's own bf16 transform lies 2.06e-2 x max from its
    float32 one, the port's 1.97e-2, so the training output is held by the
    sharper check (with the gradients); in eval mode by both."""
    x = np.random.default_rng(13).normal(size=(32, 32, 9)).astype(np.float32)
    variables = _randomized(JaxTNet(k=9).init(jax.random.key(5), jnp.asarray(x)), 14)

    def to_port(tree):
        r = _Reader({col: {"stn": t} for col, t in tree.items()})
        _tnet(r, "stn", "stn")
        return {k[len("stn."):]: val for k, val in r.sd.items()}

    port = TNet(9, dtype=BF16)
    _block_case(JaxTNet, dict(k=9), port, variables, to_port, [x], seed=15, close=False)
    port.load_state_dict(to_port(variables))
    want = {dt: strict_jit(lambda v, x, m=JaxTNet(k=9, dtype=dt): m.apply(v, x))(
        variables, jnp.asarray(x)) for dt in (jnp.bfloat16, jnp.float32)}
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert got.dtype == BF16 and want[jnp.bfloat16].dtype == jnp.bfloat16
    assert_close(got, want[jnp.bfloat16], "eval output")
    assert_sharper(got, want[jnp.bfloat16], want[jnp.float32], "eval output")


def test_gather_backward_accumulates_bf16_in_float32():
    """The plain path of kernel 7's backward: a bf16 table's gradient is the
    float32 sum of its bf16 cotangents, cast once (up to one bf16 ulp where
    the float32 sums' order moves a value across a rounding boundary);
    summed in bf16 it would round at every one of a row's 32 neighbour
    contributions."""
    rng = np.random.default_rng(16)
    table = torch.from_numpy(rng.normal(size=(2, 64, 32)).astype(np.float32)).to(BF16)
    idx = torch.from_numpy(rng.integers(0, 64, (2, 64, 32)).astype(np.int32))
    ct = torch.from_numpy(rng.normal(size=(2, 64, 32, 32)).astype(np.float32)).to(BF16)
    t = table.clone().requires_grad_(True)
    out = gather_rows(t, idx)
    assert out.dtype == BF16 and torch.equal(out, gather_rows_plain(table, idx))
    out.backward(ct)
    assert t.grad.dtype == BF16
    want = torch.zeros((2, 64, 32), dtype=torch.float64)
    for b in range(2):
        want[b].index_add_(0, idx[b].reshape(-1).long(), ct[b].reshape(-1, 32).double())
    want32 = want.float()
    ulps = torch.tensor([ulp_bf16(float(v)) for v in want32.abs().reshape(-1)]).reshape(
        want32.shape)
    err = (t.grad.float() - want32).abs()
    assert bool((err <= ulps).all())
    in_bf16 = torch.zeros((2, 64, 32), dtype=BF16)  # one bf16 rounding a neighbour slot
    for b in range(2):
        for j in range(32):
            in_bf16[b] += torch.zeros_like(in_bf16[b]).index_add_(0, idx[b, :, j].long(),
                                                                  ct[b, :, j])
    err_bf16 = (in_bf16.float() - want32).abs()
    assert bool((err_bf16 > ulps).any()) and float(err.mean()) < float(err_bf16.mean())


@pytest.mark.parametrize("F_in", [3, 64])
def test_knn_on_bf16_rounded_inputs_matches_jax(F_in):
    """DGCNN's kNN on bf16 values (the static graph on bf16-rounded xyz,
    the dynamic graphs on bf16 features), upcast to float32 in both
    packages: the same indices. bf16 rounding makes exact distance ties
    common; both break them towards the lower index."""
    rng = np.random.default_rng(17)
    x = jnp.asarray(rng.normal(size=(2, 256, F_in)).astype(np.float32), jnp.bfloat16)
    want = np.asarray(jops.knn_indices(x, 8))
    got = tops.knn_indices(torch.from_numpy(_np(x)).to(BF16), 8).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- models

# name -> (model arguments at test size, B, N, input seed). The seeds are
# PINNED to draws whose selections agree between the packages: the f32
# model tests' for the PointNet++ family (tests/test_torch_model.py,
# test_torch_pointnext.py: coordinates only, the same in bf16); for the
# DGCNNs a draw where all four bf16 graphs agree in eval mode (seeds 0-15
# tried: 0, 1, 9 and 12 agree; elsewhere 1-28 of the 12,288 slots differ
# at near-ties of bf16 features). PointNet selects nothing and runs at
# B = 8 (at B = 2 its TNets' FC BatchNorm zeroes the gradient before it).
MODEL_CASES = {
    "PointNet": ({}, 8, 64, 0),
    "PointNet++": ({"dropout": 0.0}, 2, 1024, 2),
    "PointNet++MSG": ({"dropout": 0.0}, 2, 1024, 9),
    "PointNeXt": ({"dropout": 0.0, "width": 8}, 2, 1024, 2),
    "DeepGraphCnn": ({"dropout": 0.0, "k": 8, "emb_dims": 64}, 2, 256, 0),
    "DGCNN": ({"dropout": 0.0, "k": 8, "emb_dims": 64}, 2, 256, 0),
}
DGCNNS = ("DeepGraphCnn", "DGCNN")


def _model_batch(name):
    _, B, N, seed = MODEL_CASES[name]
    rng = np.random.default_rng(seed)
    x = np.zeros((B, N, 9), np.float32)
    # PointNet++ family: a 1 m x 1 m x 0.3 m slab, whose 0.1 m balls are
    # sparse (fillers occur); the others: a 1 m x 1 m x 3 m block
    extent = [1.0, 1.0, 3.0] if name == "PointNet" or name in DGCNNS else [1.0, 1.0, 0.3]
    x[..., :3] = rng.random((B, N, 3)) * np.array(extent)
    x[..., 3:] = rng.random((B, N, 6))
    y = np.eye(14, dtype=np.float32)[rng.integers(0, 14, (B, N))]
    lengths = np.array([N] * (B - 1) + [N - N // 10], np.int32)
    return x, y, lengths


def _jax_model(name, dtype, **kwargs):
    return jax_create_model(name, num_classes=14, dtype=dtype, **MODEL_CASES[name][0], **kwargs)


@functools.cache
def model_case(name):
    """(batch, JAX-initialised variables with BatchNorm moved off its init,
    and a few negative EdgeConv BatchNorm scales: the fused form's min
    branch)."""
    batch = _model_batch(name)
    v = jax.jit(lambda x: _jax_model(name, jnp.float32).init(
        {"params": jax.random.key(0)}, x, train=False))(jnp.asarray(batch[0]))
    rng = np.random.default_rng(4)
    tree = {}
    for col, sub in v.items():
        flat = flatten_dict(jax.tree.map(np.asarray, sub))
        for path, leaf in flat.items():
            is_bn = path[-2] == "bn" or path[-2].startswith(("BatchNorm", "bn"))
            if path[-1] in ("scale", "var"):
                leaf = rng.uniform(0.5, 1.5, leaf.shape)
                if path[-1] == "scale" and path[-2] == "bn" and name in DGCNNS:
                    leaf[::5] *= -1.0
            elif path[-1] == "mean" or (path[-1] == "bias" and is_bn):
                leaf = rng.normal(0, 0.1, leaf.shape)
            flat[path] = np.asarray(leaf, np.float32)
        tree[col] = unflatten_dict(flat)
    return batch, tree


def _port_model(name, variables, **kwargs):
    model = create_model(name, dtype=BF16, **MODEL_CASES[name][0], **kwargs)
    model.load_state_dict(from_jax_variables(name, variables))
    return model


def _dgcnn_graphs_jax(variables, x, train):
    """Each EdgeConv's graph, replayed layer by layer in bf16."""
    out, h = {}, jnp.asarray(x[..., :3])
    for conv, width in zip(("conv1", "conv2", "conv3", "conv4"), (64, 64, 64, 128)):
        out[conv] = np.asarray(jops.knn_indices(h.astype(jnp.bfloat16), 8))
        v = {"params": variables["params"][conv],
             "batch_stats": variables["batch_stats"][conv]}
        h = JaxEdgeConv(width, 8, dtype=jnp.bfloat16).apply(v, h, train=train,
                                                             mutable=["batch_stats"])[0]
    return out


def _dgcnn_graphs_port(model, x, train):
    out, h = {}, torch.from_numpy(x[..., :3].copy())
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.train(train)
    with torch.no_grad():
        for conv in ("conv1", "conv2", "conv3", "conv4"):
            out[conv] = tops.knn_indices(h.to(BF16), 8).numpy()
            h = getattr(model, conv)(h)
    model.load_state_dict(state)
    return out


def _assert_same_model_selections(name, variables, x, train):
    if name == "PointNet":
        return
    if name in DGCNNS:
        want = _dgcnn_graphs_jax(variables, x, train)
        got = _dgcnn_graphs_port(_port_model(name, variables), x, train)
        for conv in want:
            np.testing.assert_array_equal(got[conv], want[conv], err_msg=f"{name} {conv}")
    elif name == "PointNet++":
        _pnpp_selections(x)
    else:
        _pnext_selections(name, x)


def _jax_value_and_grad(name, dtype, variables, batch, train, **kwargs):
    """(loss, logits, gradients in the port's layout) of the JAX model's
    forward in `dtype`, its BatchNorms on batch statistics if `train`."""
    jm = _jax_model(name, dtype, **kwargs)

    def loss_fn(params, x, y, lengths):
        call = {"params": params, "batch_stats": variables["batch_stats"]}
        if train:
            logits, _ = jm.apply(call, x, train=True, mutable=["batch_stats"])
        else:
            logits = jm.apply(call, x, train=False)
        return jax_ce(logits, y, lengths), logits

    (loss, logits), g = strict_jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], *(jnp.asarray(a) for a in batch))
    sd = from_jax_variables(name, {"params": jax.tree.map(np.asarray, g),
                                   "batch_stats": variables["batch_stats"]})
    return float(loss), np.asarray(logits), sd


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_bf16_eval_logits_and_gradients_match_jax(name):
    """The eval-mode forward (BatchNorm on running statistics): logits by
    `assert_close` and `assert_sharper`, the loss's gradient by
    `assert_gradients` at every leaf (`MODEL_GRADIENT`)."""
    batch, v = model_case(name)
    x = batch[0]
    _assert_same_model_selections(name, v, x, train=False)
    want = {dt: _jax_value_and_grad(name, dt, v, batch, train=False)
            for dt in (jnp.bfloat16, jnp.float32)}
    model = _port_model(name, v).eval()
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want[jnp.bfloat16][1].dtype == np.float32
    assert_close(got, want[jnp.bfloat16][1], f"{name} logits")
    assert_sharper(got, want[jnp.bfloat16][1], want[jnp.float32][1], f"{name} logits")
    masked_onehot_cross_entropy(got, *(torch.from_numpy(a) for a in batch[1:])).backward()
    mine = {k: p.grad for k, p in model.named_parameters()}
    assert_gradients(mine, want[jnp.bfloat16][2], want[jnp.float32][2], f"{name} gradient",
                     MODEL_GRADIENT)


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_bf16_train_step_matches_jax(name):
    """One train step: the loss, the dtypes of parameters, gradients and
    Adam's state, and the gradient by `assert_gradients` (`TRAIN_GRADIENT`):
    at this depth only the head's leaves carry their gradient in bf16
    (module docstring). The DGCNNs train on the static
    graph (the kNN of the bf16-rounded xyz, equal in both packages): in
    training, conv1's batch statistics differ between the packages by the
    JAX block's bf16 cancellation (`test_edgeconv_bf16_statistics_against_float64`),
    which moves a few percent of conv2's neighbour slots; the dynamic
    graphs are held equal in eval mode. The PointNet++ family's selections
    take coordinates only, the same in both modes: the eval-mode test
    holds them."""
    batch, v = model_case(name)
    static = {"static_graph": True} if name in DGCNNS else {}
    want = {dt: _jax_value_and_grad(name, dt, v, batch, train=True, **static)
            for dt in (jnp.bfloat16, jnp.float32)}

    model = _port_model(name, v, **static)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-3), generator=None)
    mine = {}
    state.optimizer.register_step_pre_hook(  # after backward, before Adam moves the weights
        lambda *_: mine.update({k: p.grad.clone() for k, p in model.named_parameters()}))
    metrics = train_step(state, *(torch.from_numpy(a) for a in batch))
    assert metrics["loss"].dtype == torch.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {g.dtype for g in mine.values()} == {torch.float32}
    assert {t.dtype for s in state.optimizer.state.values() for t in s.values()
            if t.is_floating_point()} == {torch.float32}
    loss_j = want[jnp.bfloat16][0]
    assert abs(float(metrics["loss"]) - loss_j) <= REL * loss_j
    assert_gradients(mine, want[jnp.bfloat16][2], want[jnp.float32][2], f"{name} gradient",
                     TRAIN_GRADIENT)


def test_bf16_train_forward_error_grows_through_batchnorms():
    """Why the PointNet++ family's train-step gradients are not compared
    (module docstring): the port's train-mode bf16 PointNet++ against its
    float32 twin, BatchNorm by BatchNorm (relative Euclidean distance of
    the outputs). Printed; held: the first within 1e-2, the last beyond 0.2."""
    (x, _, _), v = model_case("PointNet++")
    outs = {}
    for dtype in (torch.float32, BF16):
        model = create_model("PointNet++", dtype=dtype, **MODEL_CASES["PointNet++"][0])
        model.load_state_dict(from_jax_variables("PointNet++", v))
        acts = outs[dtype] = []
        for module in model.modules():
            if isinstance(module, BatchNorm):
                module.register_forward_hook(lambda m, i, out, a=acts: a.append(out.float()))
        with torch.no_grad():
            model.train()(torch.from_numpy(x))
    errs = [float((b - a).norm() / a.norm()) for a, b in zip(outs[torch.float32], outs[BF16])]
    print("bf16 train-mode BatchNorm outputs against float32: "
          + " ".join(f"{e:.3g}" for e in errs))
    assert len(errs) == 22 and errs[0] < 1e-2 and errs[-1] > 0.2, errs
