"""The port's CLIP ViT-B/32 visual tower (f3d_gaus_torch/models/clip.py)
against the JAX package's (f3d_gaus_tpu/models/clip.py) on synthetic
OpenAI-keyed weights at a 64x64 input (grid 2), fed to JAX through
convert_torch_clip_visual: the embeddings at 1e-4, the antialiased
bilinear resize 256 -> 224 against jax.image.resize at 1e-5, and
clip_loss's value at 1e-4 relative and its gradient to the image at
5e-3 x max |g|; the loader and the JAX -> torch converter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.models import clip as JC
from f3d_gaus_torch.models import clip as TC
from f3d_gaus_torch.models import convert

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)


def _synth_state_dict(seed=0, grid=2):
    """tests/test_clip.py:_synth_state_dict, from a numpy seed."""
    rng = np.random.default_rng(seed)
    W, L = TC.WIDTH, TC.LAYERS

    def n(*shape, s=0.02):
        return torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))

    def ln():
        return (torch.from_numpy(1 + rng.normal(size=W).astype(np.float32)
                                 * 0.1), n(W, s=0.05))
    sd = {"visual.conv1.weight": n(W, 3, 32, 32),
          "visual.class_embedding": n(W),
          "visual.positional_embedding": n(grid * grid + 1, W),
          "visual.proj": n(W, TC.EMBED)}
    for name in ("ln_pre", "ln_post"):
        sd[f"visual.{name}.weight"], sd[f"visual.{name}.bias"] = ln()
    for i in range(L):
        p = f"visual.transformer.resblocks.{i}"
        sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"] = ln()
        sd[f"{p}.attn.in_proj_weight"] = n(3 * W, W)
        sd[f"{p}.attn.in_proj_bias"] = n(3 * W, s=0.01)
        sd[f"{p}.attn.out_proj.weight"] = n(W, W)
        sd[f"{p}.attn.out_proj.bias"] = n(W, s=0.01)
        sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"] = ln()
        sd[f"{p}.mlp.c_fc.weight"] = n(4 * W, W)
        sd[f"{p}.mlp.c_fc.bias"] = n(4 * W, s=0.01)
        sd[f"{p}.mlp.c_proj.weight"] = n(W, 4 * W)
        sd[f"{p}.mlp.c_proj.bias"] = n(W, s=0.01)
    return sd


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    sd = _synth_state_dict()
    # a full OpenAI model also holds a text tower under the same names
    # outside `visual.`; the loader must take the visual ones
    full = {**sd, "positional_embedding": torch.zeros(77, 512),
            "transformer.resblocks.0.ln_1.weight": torch.zeros(512),
            "logit_scale": torch.zeros(())}
    path = tmp_path_factory.mktemp("clip") / "clip.pt"
    torch.save(full, path)
    port = TC.load_tower(path, device="cpu")
    jparams = JC.convert_torch_clip_visual(
        {k: v.numpy() for k, v in sd.items()})
    return port, jparams


def _images(seed, size, n=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, 3, size, size)).astype(np.float32)


def test_load_tower_is_frozen(towers):
    port, _ = towers
    assert not port.training
    assert not any(p.requires_grad for p in port.parameters())
    assert port.positional_embedding.shape == (5, TC.WIDTH)


def test_encode_image_matches_jax(towers):
    port, jparams = towers
    x = _images(1, 64)
    want = np.asarray(JC.encode_image(jparams, jnp.asarray(x)))
    got = TC.encode_image(port, torch.from_numpy(x)).numpy()
    assert got.shape == (2, TC.EMBED)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("size,to", [(256, 224), (96, 64), (64, 64)])
def test_resize_matches_jax_image_resize(size, to):
    x = _images(2, size, n=1)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, to, to),
                                       "bilinear"))
    got = TC.resize(torch.from_numpy(x), to).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_clip_loss_and_gradient_match_jax(towers):
    port, jparams = towers
    x, y = _images(3, 96), _images(4, 96)
    val, gj = jax.value_and_grad(lambda a: JC.clip_loss(
        jparams, a, jnp.asarray(y), resize_to=64))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = TC.clip_loss(port, xt, torch.from_numpy(y), resize_to=64)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(val), rtol=1e-4)
    gj = np.asarray(gj)
    np.testing.assert_allclose(xt.grad.numpy(), gj,
                               atol=5e-3 * np.abs(gj).max())


def test_clip_from_jax_matches_jax():
    jparams = JC.init_params(jax.random.PRNGKey(2), grid=2)
    port = TC.CLIPVisual(2, torch.Generator())
    port.load_state_dict(convert.clip_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    x = _images(5, 64, n=1)
    np.testing.assert_allclose(
        TC.encode_image(port, torch.from_numpy(x)).detach().numpy(),
        np.asarray(JC.encode_image(jparams, jnp.asarray(x))), atol=1e-4)
