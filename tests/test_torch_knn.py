"""f3d_gaus_torch.ops.knn against f3d_gaus_tpu.ops.knn on the CPU: the
Morton codes and their sort order exactly; mean_dist3, its exact oracle
and initial_log_scales within rtol 1e-5 on uniform, clustered and
duplicate-point clouds (the f32 sums of three squares may round
differently), plus the windowed search against numpy's brute force."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.ops import knn as JK
from f3d_gaus_torch.ops import knn as TK

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)


def _cloud(kind, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pts = rng.uniform(size=(n, 3))
    elif kind == "clustered":
        centers = rng.uniform(-5, 5, size=(20, 3))
        pts = (centers[rng.integers(0, 20, n)]
               + rng.normal(scale=0.05, size=(n, 3)))
    else:                                   # every point three times
        pts = np.repeat(rng.normal(size=(n // 3, 3)), 3, 0)
    return pts.astype(np.float32)


def brute_force(points):
    d2 = ((points[:, None, :].astype(np.float64)
           - points[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sort(d2, axis=1)[:, :3].mean(1)


@pytest.mark.parametrize("kind", ["uniform", "clustered", "duplicates"])
@pytest.mark.parametrize("shift,scale", [(0.0, 1023.0), (0.0, 292.29),
                                         (365.36, 292.29)])
def test_morton_codes_and_order_match_jax(kind, shift, scale):
    pts = _cloud(kind)
    j = np.asarray(JK.morton_codes(jnp.asarray(pts), shift=shift,
                                   scale=scale)).astype(np.int64)
    t = TK.morton_codes(torch.from_numpy(pts), shift=shift, scale=scale)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), j)
    assert t.max() < (1 << 30) and len(np.unique(j)) > 50
    np.testing.assert_array_equal(
        torch.argsort(t, stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(j.astype(np.uint32)))))


def test_morton_codes_range():
    """tests/test_knn.py:TestMorton on the port."""
    pts = torch.tensor([[0, 0, 0], [1, 1, 1]], dtype=torch.float32)
    assert TK.morton_codes(pts).tolist() == [0, (1 << 30) - 1]
    line = torch.from_numpy(np.stack([np.linspace(0, 1, 64)] * 3, -1)
                            .astype(np.float32))
    assert (torch.diff(TK.morton_codes(line)) >= 0).all()


@pytest.mark.parametrize("kind", ["uniform", "clustered", "duplicates"])
def test_mean_dist3_matches_jax(kind):
    pts = _cloud(kind)
    j = np.asarray(JK.mean_dist3(jnp.asarray(pts)))
    t = TK.mean_dist3(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-12)
    # and the windowed search finds the true 3 neighbours nearly always
    ref = brute_force(pts)
    close = np.abs(t - ref) <= 1e-5 * np.maximum(ref, 1e-12) + 1e-12
    assert close.mean() > 0.99


@pytest.mark.parametrize("kind", ["uniform", "clustered", "duplicates"])
def test_exact_oracle_and_log_scales_match_jax(kind):
    pts = _cloud(kind, n=600)
    j = np.asarray(JK.mean_dist3_exact(jnp.asarray(pts), chunk=128))
    t = TK.mean_dist3_exact(torch.from_numpy(pts), chunk=128).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(t, brute_force(pts), rtol=1e-5, atol=1e-12)
    j = np.asarray(JK.initial_log_scales(jnp.asarray(pts)))
    t = TK.initial_log_scales(torch.from_numpy(pts))
    assert t.shape == (600, 3)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6)


def test_small_and_degenerate_sets():
    """A window wider than the cloud is exact; identical points clamp to
    log(sqrt(1e-7)) (tests/test_knn.py)."""
    pts = np.random.default_rng(1).uniform(size=(50, 3)).astype(np.float32)
    got = TK.mean_dist3(torch.from_numpy(pts), window=128).numpy()
    np.testing.assert_allclose(got, brute_force(pts), rtol=1e-4)
    s = TK.initial_log_scales(torch.zeros((16, 3)))
    np.testing.assert_allclose(s.numpy(), np.log(np.sqrt(1e-7)), rtol=1e-6)
