"""The band mode of the port's render (`render(tile_rows=(row_off,
n_rows))`, the plain versions on CPU tensors) against the JAX package's
render(tile_rows=..., backend="xla") on the cases of tests/test_sharded.py:
_setup (64x64 with 96 Gaussians, 64x128 with 64): the band's nine channels
at 1e-4 (the median depth, channel 6, a discrete choice, at 5e-3),
final_T at 1e-4, contributor positions and the band's binning integers
equal, and the gradients of the five Gaussian inputs and the
densification statistics at 5e-3 x max |g|.  The bands stacked are also
held against the full-frame render, values and summed gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.ops import rasterize as JR
from f3d_gaus_torch.ops import rasterize as TR
import torch_dist  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

KW = torch_dist.SHARDED_KW
BG = torch_dist.SHARDED_BG


def _case(name):
    return torch_dist.sharded_case(name)[:2]


def _w9(cam, tile_rows, seed=1):
    h = cam.height if tile_rows is None else tile_rows[1] * TR.BLOCK
    w9 = np.random.default_rng(seed).normal(
        size=(9, h, cam.width)).astype(np.float32)
    w9[7] = 0.0     # the alpha channel takes no gradient in the reference
    w9[6] = 0.0     # the median depth's contributor is a discrete choice
    return w9


def _torch(cam, cloud, tile_rows, w9=None):
    ts = [torch.from_numpy(a).requires_grad_() for a in cloud]
    ts.append(torch.zeros((cloud[0].shape[0], 3), requires_grad=True))
    out = TR.render(*ts[:5], cam, torch.from_numpy(BG), means2d_stats=ts[5],
                    tile_rows=tile_rows, **KW)
    grads = None
    if w9 is not None:
        (out["out9"] * torch.from_numpy(w9)).sum().backward()
        grads = [t.grad.numpy() for t in ts]
    return out, grads


def _jax(cam, cloud, tile_rows, w9=None):
    args = [jnp.asarray(a) for a in cloud]
    args.append(jnp.zeros((cloud[0].shape[0], 3), jnp.float32))

    def run(*a):
        return JR.render(*a[:5], cam, jnp.asarray(BG), means2d_stats=a[5],
                         tile_rows=tile_rows, backend="xla", **KW)
    out = run(*args)
    grads = None
    if w9 is not None:
        grads = [np.asarray(g) for g in jax.grad(
            lambda *a: jnp.sum(run(*a)["out9"] * w9),
            argnums=tuple(range(6)))(*args)]
    return out, grads


def _assert_values(got, want):
    g, w = got["out9"].detach().numpy(), np.asarray(want["out9"])
    assert g.shape == w.shape
    for c in list(range(6)) + [7, 8]:
        np.testing.assert_allclose(g[c], w[c], atol=1e-4,
                                   err_msg=f"channel {c}")
    np.testing.assert_allclose(g[6], w[6], atol=5e-3)


def _assert_grads(got, want):
    for name, a, b in zip(("means", "scales", "quats", "opacities", "shs",
                           "means2d_stats"), got, want):
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, atol=5e-3 * scale, err_msg=name)


@pytest.mark.parametrize("case,tile_rows", [
    ("64x64", (0, 1)), ("64x64", (1, 2)), ("64x64", (3, 1)),
    ("64x128", (2, 2)), ("64x128", (4, 4))])
def test_band_matches_jax(case, tile_rows):
    cam, cloud = _case(case)
    w9 = _w9(cam, tile_rows)
    got, g_grads = _torch(cam, cloud, tile_rows, w9)
    want, w_grads = _jax(cam, cloud, tile_rows, w9)
    assert got["out9"].shape[1] == tile_rows[1] * TR.BLOCK
    assert not bool(got["overflow"]) and not bool(want["overflow"])
    _assert_values(got, want)
    ga, wa = got["aux"], want["aux"]
    np.testing.assert_allclose(ga.final_T.numpy(), np.asarray(wa.final_T),
                               atol=1e-4)
    np.testing.assert_array_equal(ga.last_pos.numpy(), np.asarray(wa.last_pos))
    np.testing.assert_array_equal(ga.max_pos.numpy(), np.asarray(wa.max_pos))
    gb, wb = got["binning"], want["binning"]
    assert tuple(gb.grid) == tuple(wb.grid) == (cam.width // 16, tile_rows[1])
    for f in ("point_list", "tile_start", "tile_count", "num_pairs"):
        np.testing.assert_array_equal(getattr(gb, f).numpy(),
                                      np.asarray(getattr(wb, f)), err_msg=f)
    _assert_grads(g_grads, w_grads)


@pytest.mark.parametrize("case,n_bands", [("64x64", 4), ("64x128", 2),
                                          ("64x128", 8)])
def test_stacked_bands_match_full_frame(case, n_bands):
    """The bands concatenated are the frame; their summed gradients are
    the frame's (the sum a tile-sharded render all-reduces)."""
    cam, cloud = _case(case)
    w9 = _w9(cam, None)
    full, f_grads = _torch(cam, cloud, None, w9)
    rows = -(-cam.height // TR.BLOCK) // n_bands
    bands, sums = [], None
    for d in range(n_bands):
        sl = slice(d * rows * TR.BLOCK, (d + 1) * rows * TR.BLOCK)
        out, grads = _torch(cam, cloud, (d * rows, rows),
                            np.ascontiguousarray(w9[:, sl]))
        bands.append(out)
        sums = grads if sums is None else [a + b for a, b in zip(sums, grads)]
    stacked = {"out9": torch.cat([b["out9"] for b in bands], 1)}
    _assert_values(stacked, {"out9": full["out9"].detach().numpy()})
    _assert_grads(sums, f_grads)


def test_band_rows_are_checked():
    cam, cloud = _case("64x64")
    with pytest.raises(ValueError, match="not a band"):
        TR.render(*[torch.from_numpy(a) for a in cloud], cam,
                  tile_rows=(3, 2), **KW)
    with pytest.raises(ValueError, match="not a band"):
        TR.render(*[torch.from_numpy(a) for a in cloud], cam,
                  tile_rows=(-1, 1), **KW)
