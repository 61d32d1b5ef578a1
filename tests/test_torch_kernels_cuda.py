"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so on a machine without it run it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The kernels compute distances with the plain versions' rounding, so
indices, `in_ball` and the 3-NN distances must be equal, not close.
"""

import numpy as np
import pytest
import torch

from pointseg_torch.models import create_model
from pointseg_torch.ops import _kernels
from pointseg_torch.ops.ballquery import ball_query_plain, ball_query_raw
from pointseg_torch.ops.fps import farthest_point_sampling, farthest_point_sampling_plain
from pointseg_torch.ops.interpolate import three_nn, three_nn_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cloud(seed, B, N, device, dup_from=None):
    rng = np.random.default_rng(seed)
    pts = (rng.random((B, N, 3)) * np.array([1.0, 1.0, 3.0])).astype(np.float32)
    if dup_from is not None:  # repeat-padding: the tail repeats the head
        pts[:, dup_from:] = pts[:, : N - dup_from]
    return torch.from_numpy(pts).to(device)


@pytest.mark.parametrize("B,N,C", [(8, 4096, 1024), (8, 64, 16), (3, 3000, 1000),
                                   (2, 16384, 1024)])
def test_fps_kernel_matches_plain(device, B, N, C):
    pts = _cloud(0, B, N, device, dup_from=N - N // 4)
    start = torch.arange(B, dtype=torch.int32, device=device) * 7
    before = _kernels.LAUNCHES["fps"]
    got = farthest_point_sampling(pts, C, start_indices=start)
    assert _kernels.LAUNCHES["fps"] == before + 1
    want = farthest_point_sampling_plain(pts, C, start)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fps_kernel_mask_matches_plain(device):
    pts = _cloud(1, 4, 500, device)
    mask = torch.rand((4, 500), generator=torch.Generator().manual_seed(2)).to(device) > 0.3
    start = mask.int().argmax(dim=1).to(torch.int32)
    got = farthest_point_sampling(pts, 100, mask=mask)
    torch.testing.assert_close(got, farthest_point_sampling_plain(pts, 100, start, mask),
                               rtol=0, atol=0)


@pytest.mark.parametrize("B,C,N,r,K", [(8, 1024, 4096, 0.1, 32), (8, 16, 64, 0.8, 32),
                                       (3, 1000, 3000, 0.2, 32), (2, 1024, 16384, 0.1, 32),
                                       (2, 100, 700, 0.3, 7)])
def test_ball_query_kernel_matches_plain(device, B, C, N, r, K):
    pts = _cloud(3, B, N, device, dup_from=N - N // 5)
    cents = pts[:, :C].contiguous()
    before = _kernels.LAUNCHES["ball_query"]
    idx, in_ball = ball_query_raw(cents, pts, r, K)
    assert _kernels.LAUNCHES["ball_query"] == before + 1
    want_idx, want_in = ball_query_plain(cents, pts, r, K)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(in_ball, want_in, rtol=0, atol=0)


def test_ball_query_kernel_mask_matches_plain(device):
    pts = _cloud(4, 2, 900, device)
    mask = torch.rand((2, 900), generator=torch.Generator().manual_seed(5)).to(device) > 0.5
    idx, in_ball = ball_query_raw(pts[:, :200], pts, 0.25, 16, mask=mask)
    want_idx, want_in = ball_query_plain(pts[:, :200], pts, 0.25, 16, mask=mask)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(in_ball, want_in, rtol=0, atol=0)


@pytest.mark.parametrize("B,N,M", [(8, 4096, 1024), (8, 64, 16), (3, 3000, 1000),
                                   (2, 5000, 3)])
def test_three_nn_kernel_matches_plain(device, B, N, M):
    tgt = _cloud(6, B, N, device)
    src = _cloud(7, B, M, device, dup_from=M - M // 3 if M > 3 else None)
    before = _kernels.LAUNCHES["three_nn"]
    d2, idx = three_nn(tgt, src)
    assert _kernels.LAUNCHES["three_nn"] == before + 1
    want_d2, want_idx = three_nn_plain(tgt, src)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(d2, want_d2, rtol=0, atol=0)


def test_three_nn_kernel_mask_matches_plain(device):
    tgt, src = _cloud(8, 2, 700, device), _cloud(9, 2, 90, device)
    mask = torch.rand((2, 90), generator=torch.Generator().manual_seed(10)).to(device) > 0.4
    d2, idx = three_nn(tgt, src, src_mask=mask)
    want_d2, want_idx = three_nn_plain(tgt, src, src_mask=mask)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(d2, want_d2, rtol=0, atol=0)


def test_model_on_the_card_matches_the_cpu(device):
    """Eval logits through the kernels match the plain versions' on the
    CPU with the same weights (matmul and reduction order differ)."""
    torch.manual_seed(0)
    model = create_model("PointNet++").eval()
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((2, 2048, 9)).astype(np.float32))
    with torch.no_grad():
        want = model(x)
        got = model.to(device)(x.to(device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
