"""The kNN kernel's plain twin (ops/cuda_knn.py) and the port's projection
against the JAX package: its Pallas kernel (interpret mode on the CPU) on
untied clouds at rtol 1e-6, and association.knn_median_depth on a heavily
tied cloud exactly (equal d2 resolves to the lowest point index; the Pallas
kernel's own tie rule differs and is not the reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.ops import association as jassoc
from grid_vision_tpu.ops.pallas_knn import knn_median_depth_pallas
from grid_vision_tpu.types import Boxes as JaxBoxes
from grid_vision_tpu.types import PointCloud as JaxCloud
from grid_vision_tpu_torch.ops import association, cuda_knn
from grid_vision_tpu_torch.types import Boxes, PointCloud

torch.set_num_threads(1)

K_NP = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]],
                np.float32)
BOXES = [(100, 100, 250, 280), (220, 90, 400, 300), (500, 350, 630, 470),
         (-50, -50, 30, 40)]


def both_boxes(capacity=16):
    xyxy = np.zeros((capacity, 4), np.float32)
    valid = np.zeros((capacity,), bool)
    xyxy[:len(BOXES)] = BOXES
    valid[:len(BOXES)] = True
    label = np.full((capacity,), 9, np.int32)
    conf = np.zeros((capacity,), np.float32)
    return (JaxBoxes(xyxy=jnp.asarray(xyxy), confidence=jnp.asarray(conf),
                     label=jnp.asarray(label), valid=jnp.asarray(valid)),
            Boxes(xyxy=torch.as_tensor(xyxy), confidence=torch.as_tensor(conf),
                  label=torch.as_tensor(label), valid=torch.as_tensor(valid)))


def both_projections(xyz, capacity):
    """The JAX package's uvd / valid of a cloud, as JAX arrays and as
    tensors (the kNN functions get identical inputs), after checking the
    port's own projection against it: validity exact, uvd to 1e-3 px /
    rtol 1e-5 (the 3x3 matmul accumulates in another order)."""
    jc = JaxCloud.from_numpy(xyz, None, capacity)
    tc = PointCloud.from_numpy(xyz, None, capacity)
    juvd, jvalid = jassoc.project_cloud_to_image(jc, jnp.asarray(K_NP))
    tuvd, tvalid = association.project_cloud_to_image(
        tc, torch.as_tensor(K_NP))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tuvd.numpy(), np.asarray(juvd), rtol=1e-5,
                               atol=1e-3)
    return (juvd, jvalid), (torch.tensor(np.asarray(juvd)),
                            torch.tensor(np.asarray(jvalid)))


def random_cloud(seed, n=700):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform([-10, -3, 0.5], [10, 3, 60], size=(n, 3))
    xyz[: n // 10, 2] = rng.uniform(-5, 0, n // 10)     # behind the camera
    rng.shuffle(xyz)
    return xyz.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_twin_matches_pallas_on_untied_cloud(seed):
    (juvd, jvalid), (tuvd, tvalid) = both_projections(random_cloud(seed),
                                                      1024)
    jb, tb = both_boxes()
    ref = np.asarray(knn_median_depth_pallas(juvd, jvalid, jb, 4))
    got = cuda_knn.knn_median_depth_cuda(tuvd, tvalid, tb, 4).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # the "xla" backend agrees too
    np.testing.assert_allclose(
        association.knn_median_depth(tuvd, tvalid, tb, 4).numpy(), ref,
        rtol=1e-6)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_plain_twin_matches_xla_on_tied_cloud(k):
    """The cloud of tests/test_association.py's tie-contract test:
    grid-quantized coordinates, many equal distances."""
    rng = np.random.default_rng(7)
    xyz = rng.integers(-4, 5, size=(600, 3)).astype(np.float32)
    xyz[:, 2] = np.abs(xyz[:, 2]) + 1.0 + 0.001 * np.arange(600)
    (juvd, jvalid), (tuvd, tvalid) = both_projections(xyz, 1024)
    jb, tb = both_boxes()
    ref = np.asarray(jassoc.knn_median_depth(juvd, jvalid, jb, k))
    got = cuda_knn.knn_median_depth_cuda(tuvd, tvalid, tb, k).numpy()
    np.testing.assert_array_equal(got, ref)


def test_empty_and_sparse_clouds():
    jb, tb = both_boxes()
    for xyz in (np.zeros((0, 3), np.float32),
                np.array([[0.0, 0.0, 5.0], [0.1, 0.0, 9.0]], np.float32)):
        (juvd, jvalid), (tuvd, tvalid) = both_projections(xyz, 64)
        ref = np.asarray(jassoc.knn_median_depth(juvd, jvalid, jb, 4))
        got = cuda_knn.knn_median_depth_cuda(tuvd, tvalid, tb, 4).numpy()
        np.testing.assert_array_equal(got, ref)



def test_batched_twin_matches_vmapped_pallas():
    """Three rigs' clouds and boxes in one call ((R, P, 3) points, (R, D)
    boxes) against the JAX Pallas kernel under vmap, as the JAX fleet path
    runs it, rtol 1e-6, and against the port's per-rig calls exactly."""
    projections = [both_projections(random_cloud(seed), 1024)
                   for seed in (3, 4, 5)]
    juvd = jnp.stack([p[0][0] for p in projections])
    jvalid = jnp.stack([p[0][1] for p in projections])
    tuvd = torch.stack([p[1][0] for p in projections])
    tvalid = torch.stack([p[1][1] for p in projections])
    jb, tb = both_boxes()
    jbb = jax.tree_util.tree_map(lambda a: jnp.stack([a] * 3), jb)
    shift = torch.tensor([0.0, 30.0, -20.0])[:, None, None]
    tbb = Boxes(xyxy=tb.xyxy[None] + shift,
                confidence=torch.stack([tb.confidence] * 3),
                label=torch.stack([tb.label] * 3),
                valid=torch.stack([tb.valid] * 3))
    jbb = jbb.__class__(xyxy=jnp.asarray(tbb.xyxy.numpy()),
                        confidence=jbb.confidence, label=jbb.label,
                        valid=jbb.valid)
    ref = np.asarray(jax.vmap(lambda u, v, b: knn_median_depth_pallas(
        u, v, b, 4))(juvd, jvalid, jbb))
    got = cuda_knn.knn_median_depth_cuda(tuvd, tvalid, tbb, 4)
    assert got.shape == (3, tb.capacity)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    for r in range(3):
        one = cuda_knn.knn_median_depth_cuda(tuvd[r], tvalid[r],
                                             tbb.select(r), 4)
        assert torch.equal(one, got[r])
