"""The port's VGG16 tower (f3d_gaus_torch/models/vgg.py) against the JAX
package's (f3d_gaus_tpu/models/vgg.py) on a synthetic torchvision-keyed
state_dict fed to both (JAX through convert_torch_vgg16 /
convert_torch_lpips_lin): the five taps at 1e-4 x max |tap|, LPIPS with
and without the learned heads and the perceptual loss at 1e-4 relative,
the perceptual loss's gradient to the image at 5e-3 x max |g|; the port's
loaders and the JAX -> torch converter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.models import vgg as JV
from f3d_gaus_torch.models import convert
from f3d_gaus_torch.models import vgg as TV

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def towers():
    net = TV.VGG16(torch.Generator().manual_seed(0))
    with torch.no_grad():    # nonzero biases, so the bias layout is held too
        for i in TV._CONV_IDX:
            net.features[i].bias.uniform_(-0.05, 0.05)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    rng = np.random.default_rng(3)
    lin_sd = {f"lin.{i}.1.weight": torch.from_numpy(
        rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(TV.N_CHANNELS)}
    jparams = JV.convert_torch_vgg16({k: v.numpy() for k, v in sd.items()})
    jlin = JV.convert_torch_lpips_lin({k: v.numpy() for k, v in lin_sd.items()})
    port = TV.VGG16(torch.Generator())
    port.load_state_dict(TV.convert_torch_vgg16(sd))
    return port.eval().requires_grad_(False), TV.convert_torch_lpips_lin(
        lin_sd), jparams, jlin, sd, lin_sd


def _images(seed, lo=0.0, hi=1.0, n=2, size=32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, (n, 3, size, size)).astype(np.float32)
            for _ in range(2)]


def test_taps_match_jax(towers):
    port, _, jparams, _, _, _ = towers
    x = np.random.default_rng(0).normal(size=(2, 3, 32, 32)).astype(np.float32)
    want = JV.features(jparams, jnp.asarray(x))
    got = TV.features(port, torch.from_numpy(x))
    assert len(got) == 5
    for j, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, TV.N_CHANNELS[j], 32 >> j, 32 >> j)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"tap {j}")


@pytest.mark.parametrize("heads", [True, False])
def test_lpips_matches_jax(towers, heads):
    port, lin, jparams, jlin, _, _ = towers
    x, y = _images(1, -1.0, 1.0)
    if heads:
        want = JV.lpips(jparams, jlin, jnp.asarray(x), jnp.asarray(y))
        got = TV.lpips(port, lin, torch.from_numpy(x), torch.from_numpy(y))
    else:
        # f3d_gaus_tpu/eval.py:40-43: uniform 1/C heads without the file
        uni = [jnp.full((c,), 1.0 / c) for c in JV.N_CHANNELS]
        want = JV.lpips(jparams, uni, jnp.asarray(x), jnp.asarray(y))
        got = TV.lpips(port, None, torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_perceptual_loss_and_gradient_match_jax(towers):
    port, _, jparams, _, _, _ = towers
    x, y = _images(2)
    val, gj = jax.value_and_grad(lambda a: JV.perceptual_loss(
        jparams, a, jnp.asarray(y)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = TV.perceptual_loss(port, xt, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(val), rtol=1e-4)
    gj = np.asarray(gj)
    np.testing.assert_allclose(xt.grad.numpy(), gj,
                               atol=5e-3 * np.abs(gj).max())


def test_vgg_from_jax_matches_jax():
    jparams = JV.init_params(jax.random.PRNGKey(1))
    port = TV.VGG16(torch.Generator())
    port.load_state_dict(convert.vgg_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams]))
    x = np.random.default_rng(4).normal(size=(1, 3, 32, 32)).astype(np.float32)
    for g, w in zip(TV.features(port, torch.from_numpy(x)),
                    JV.features(jparams, jnp.asarray(x))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w,
                                   atol=1e-4 * np.abs(w).max())
    lin = convert.lpips_lin_from_jax([np.full((c,), 0.5, np.float32)
                                      for c in JV.N_CHANNELS])
    assert [t.shape[0] for t in lin] == list(TV.N_CHANNELS)


@pytest.mark.parametrize("naming", ["torchvision", "lpips_upstream"])
def test_load_towers_from_files(towers, tmp_path, naming):
    port, lin, _, _, sd, lin_sd = towers
    if naming == "torchvision":
        full = {**sd, "classifier.0.weight": torch.zeros(4, 3),
                "classifier.0.bias": torch.zeros(4)}
        heads = lin_sd
    else:
        full = {f"net.layers.{k[len('features.'):]}": v for k, v in sd.items()}
        heads = {f"lin{i}.model.1.weight": lin_sd[f"lin.{i}.1.weight"]
                 for i in range(5)}
    torch.save(full, tmp_path / "vgg16.pt")
    torch.save(heads, tmp_path / "lin.pt")
    vgg, got_lin = TV.load_towers(tmp_path / "vgg16.pt", tmp_path / "lin.pt",
                                  device="cpu")
    assert not any(p.requires_grad for p in vgg.parameters())
    for k, v in port.state_dict().items():
        torch.testing.assert_close(vgg.state_dict()[k], v, rtol=0, atol=0)
    for a, b in zip(got_lin, lin):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    vgg_only, none = TV.load_towers(tmp_path / "vgg16.pt", device="cpu")
    assert none is None
    with pytest.raises(KeyError):
        TV.convert_torch_vgg16({"features.0.weight": torch.zeros(1)})
