"""f3d_gaus_torch.models against f3d_gaus_tpu.models: the same parameters
(params_from_jax of the JAX tree) and inputs give every predictor output
key within 2e-4 x max |ref| (XLA and oneDNN sum convolutions in different
orders), and the parameter gradients of a scalar of the outputs within
5e-3 x max |g| per tensor.  The JAX parameters are perturbed with seeded noise first, so the
zero-gain heads (features_rest) carry signal too."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.models import layers as JL
from f3d_gaus_tpu.models import predictor as JP
from f3d_gaus_torch.models import convert as TC
from f3d_gaus_torch.models import layers as TL
from f3d_gaus_torch.models import predictor as TP

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

SMALL = dict(resolution=32, base_dim=32, num_blocks=1, attn_resolutions=(8,))


@functools.lru_cache(maxsize=None)
def _perturbed_params(seed=0, scale=0.02):
    """JAX init at SMALL plus seeded noise (cached: the eager init is the
    slowest step of this file)."""
    params = JP.init_params(jax.random.PRNGKey(seed),
                            JP.PredictorConfig(**SMALL))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32)
        * scale, params)


def _inputs(rng, B, N, r=32):
    img = rng.uniform(size=(B, N, r, r, 4)).astype(np.float32)
    v2w = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    v2w[..., 3, :3] = rng.normal(size=(B, N, 3)) * 0.1
    q = rng.normal(size=(B, N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    d = rng.uniform(6.6, 8.6, size=(B, N, r, r)).astype(np.float32)
    return img, v2w, q, d


@pytest.mark.parametrize("B,N", [(2, 1), (1, 2)])
def test_predictor_matches_jax(B, N):
    """N=2 exercises the cross-view fold before norm2."""
    jc, tc = JP.PredictorConfig(**SMALL), TP.PredictorConfig(**SMALL)
    tree = _perturbed_params()
    model = TP.GaussianPredictor(tc)
    model.load_state_dict(TC.params_from_jax(tree), strict=True)
    args = _inputs(np.random.default_rng(N), B, N)
    ref = jax.jit(JP.apply, static_argnums=1)(tree, jc,
                                              *map(jnp.asarray, args))
    with torch.no_grad():
        out = model(*map(torch.from_numpy, args))
    assert set(out) == set(ref)
    for k in ref:
        a, b = np.asarray(ref[k]), out[k].numpy()
        assert a.shape == b.shape, k
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, atol=2e-4 * scale, rtol=0, err_msg=k)


def test_state_dict_keys_are_reference_names():
    model = TP.GaussianPredictor(TP.PredictorConfig(**SMALL))
    keys = set(model.state_dict())
    assert "encoder.enc.32x32_conv.weight" in keys
    assert "encoder.dec.4x4_in0.norm2.weight" in keys
    assert "encoder.dec.32x32_aux_conv.bias" in keys
    assert "out.weight" in keys
    assert keys == set(TC.params_from_jax(_perturbed_params()))


def test_seeded_init_is_deterministic_and_edm_scaled():
    cfg = TP.PredictorConfig(**SMALL)
    a = TP.GaussianPredictor(cfg, torch.Generator().manual_seed(3))
    b = TP.GaussianPredictor(cfg, torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    w = a.encoder.enc["32x32_conv"].weight        # xavier, gain 1
    bound = (6.0 / (4 * 9 + 32 * 9)) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    # the head's per-group biases: opacity -3, scale log(0.01)
    assert torch.allclose(a.out.bias[3], torch.tensor(-3.0))
    assert torch.allclose(a.out.bias[4:7], torch.tensor(np.log(0.01)).float())


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 20, 8)).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(
        TL.attention(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(JL.attention(q, k, v)), atol=1e-5)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)   # NHWC
    p = {"weight": rng.normal(size=(16,)).astype(np.float32),
         "bias": rng.normal(size=(16,)).astype(np.float32)}
    gn = TL.GroupNorm(16)
    gn.load_state_dict({k_: torch.from_numpy(v_) for k_, v_ in p.items()})
    with torch.no_grad():
        got = gn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(JL.group_norm(p, x)),
                               atol=1e-5)
    for up, down in ((True, False), (False, True)):
        w = rng.normal(size=(3, 3, 16, 4)).astype(np.float32) * 0.1
        cp = {"weight": w, "bias": np.zeros(4, np.float32)}
        conv = TL.Conv2d(16, 4, 3, up=up, down=down)
        conv.load_state_dict({"weight": TC._leaf("weight", w)[1],
                              "bias": torch.zeros(4)})
        with torch.no_grad():
            got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(JL.conv2d(cp, x, up=up, down=down)),
            atol=1e-4)


@pytest.mark.parametrize("B,N", [(1, 1), (1, 2)])
def test_predictor_param_grads_match_jax(B, N):
    """Parameter gradients of a seeded weighted sum of every output key
    against jax.grad of predictor.apply on the same (perturbed) weights,
    at 5e-3 x max |g| per tensor; N = 2 runs the cross-view fold."""
    jc, tc = JP.PredictorConfig(**SMALL), TP.PredictorConfig(**SMALL)
    tree = _perturbed_params()
    model = TP.GaussianPredictor(tc)
    model.load_state_dict(TC.params_from_jax(tree), strict=True)
    args = _inputs(np.random.default_rng(10 + N), B, N)
    out = model(*map(torch.from_numpy, args))
    rng = np.random.default_rng(11)
    w = {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
         for k, v in out.items()}
    sum((v * torch.from_numpy(w[k])).sum() for k, v in out.items()).backward()

    def jloss(p):
        o = JP.apply(p, jc, *map(jnp.asarray, args))
        return sum(jnp.sum(o[k] * w[k]) for k in o)
    ref = TC.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(jloss))(tree)))
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=5e-3 * np.abs(r).max(), err_msg=name)
