"""The port's plain compositing forward against the JAX package's
render(backend="xla") and render(backend="pallas", interpret=True) on the
32^2 cases whose tile windows run past 256 Gaussians (one cut at
max_per_tile 300, one held whole at 768), at the tolerances of
tests/test_torch_rasterize.py."""
import pytest

from test_torch_rasterize import check_case
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)


@pytest.mark.parametrize("case", torch_cases.DEEP_CASES)
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_plain_forward_matches_jax_deep_window(case, backend):
    check_case(case, backend)
