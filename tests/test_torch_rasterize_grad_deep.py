"""The render-gradient comparison of tests/test_torch_rasterize_grad.py on
the cases whose walk goes deep: the near-opaque stack, where the stop rule
fires and T is rebuilt from final_T by division through many near-opaque
contributors, and the 600-Gaussian windows past 256 Gaussians (one cut at
max_per_tile 300, one held whole at 768)."""
import pytest

from test_torch_rasterize_grad import DEEP, check_grads


@pytest.mark.parametrize("case", DEEP)
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_render_grads_match_jax_deep(case, backend):
    check_grads(case, backend)
