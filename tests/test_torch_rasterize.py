"""The port's plain compositing forward (rasterize.render on CPU tensors)
against the JAX package's render(backend="xla") and
render(backend="pallas", interpret=True) on the cases of
tests/test_pallas_raster.py plus an empty scene: out9 and final_T at
atol 1e-4, last_pos / max_pos exactly equal.  The cases with windows past
256 Gaussians are in tests/test_torch_rasterize_deep.py, the kernel-vs-plain
cases that need the card in tests/test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from f3d_gaus_tpu.ops import rasterize as JR
from f3d_gaus_torch.ops import rasterize as TR
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

CASES = {name: (cam, cloud, bg, kw)
         for name, cam, cloud, bg, kw in torch_cases.small_cases()}


def _jax(cam, cloud, bg, backend, **kw):
    return JR.render(*[jnp.asarray(a) for a in cloud], cam, jnp.asarray(bg),
                     backend=backend, interpret=(backend == "pallas"), **kw)


def _torch(cam, cloud, bg, **kw):
    return TR.render(*[torch.from_numpy(a) for a in cloud], cam,
                     torch.from_numpy(bg), device="cpu", **kw)


def _assert_match(ref, out):
    np.testing.assert_allclose(out["out9"].numpy(), np.asarray(ref["out9"]),
                               atol=1e-4)
    ra, oa = ref["aux"], out["aux"]
    np.testing.assert_allclose(oa.final_T.numpy(), np.asarray(ra.final_T),
                               atol=1e-4)
    np.testing.assert_array_equal(oa.last_pos.numpy(), np.asarray(ra.last_pos))
    np.testing.assert_array_equal(oa.max_pos.numpy(), np.asarray(ra.max_pos))
    assert bool(out["overflow"]) == bool(ref["overflow"])


def check_case(case, backend):
    """The plain forward of small case `case` against JAX `backend`, and
    the case's claims (torch_cases.exercised) on its render."""
    cam, cloud, bg, kw = CASES[case]
    out = _torch(cam, cloud, bg, **kw)
    _assert_match(_jax(cam, cloud, bg, backend, **kw), out)
    claims = torch_cases.exercised(case, out["binning"].tile_count,
                                   out["aux"], kw["max_per_tile"])
    assert all(claims.values()), claims
    if case == "behind_camera":
        np.testing.assert_allclose(out["render"].numpy(),
                                   np.broadcast_to(bg[:, None, None],
                                                   (3, 32, 32)))


@pytest.mark.parametrize(
    "case", sorted(set(CASES) - set(torch_cases.DEEP_CASES)))
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_plain_forward_matches_jax(case, backend):
    check_case(case, backend)


def test_plan_caps_matches_jax():
    cam, cloud = torch_cases.setup(np.random.default_rng(5), n=300,
                                   width=64, height=64)
    cj = JR.plan_caps(*[jnp.asarray(a) for a in cloud[:4]], cam)
    ct = TR.plan_caps(*[torch.from_numpy(a) for a in cloud[:4]], cam,
                      device="cpu")
    assert ct == cj
