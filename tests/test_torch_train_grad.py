"""The port's feed-forward loss_fn against jax.value_and_grad of the JAX
package's loss_fn on a two-image batch at the tiny config, on the same
weights (the port's seeded state_dict carried into JAX by the JAX
package's own converter): every weighted term within 1e-4 relative and
every parameter gradient within 5e-3 x max |g| per tensor.

The head's biases are set first so the Gaussians are opaque (0.73), 0.2
wide and 0.05 behind the input depth.  At the EDM init (opacity 0.047,
scale 0.01, offset 1e-6) both sides are chaotic in f32, not the port
alone: JAX's own jitted and eager renders of those Gaussians give
gradients that disagree beyond this test's tolerance, because the monomial-coefficient evaluation
of sub-pixel Gaussians flips pairs at alpha = 1/255, and the depth L1
takes the sign of (rendered - input) depth, which is f32 noise when the
Gaussians sit exactly on the input depth."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from f3d_gaus_tpu.core import cameras as Jcam
from f3d_gaus_tpu.models import convert as JConv
from f3d_gaus_tpu.models import predictor as JP
from f3d_gaus_tpu.pipeline import config as JC
from f3d_gaus_tpu.train import feedforward as JF
from f3d_gaus_torch.models import convert as TConv
from f3d_gaus_torch.pipeline import config as TC
from f3d_gaus_torch.pipeline import dataset as TD
from f3d_gaus_torch.train import feedforward as TF
from test_torch_train import TINY, batch

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)


def _setup():
    """(jcfg, tcfg, pcfg, port model, JAX params, JAX pack, port pack) on
    the same weights, the head's biases set as the module docstring says."""
    jcfg, tcfg = JC.PipelineConfig(**TINY), TC.PipelineConfig(**TINY)
    pcfg = jcfg.predictor_config()
    state = TF.init_state(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    model = state.model
    with torch.no_grad():
        model.out.bias[2] = 0.05                       # z offset
        model.out.bias[3] = 1.0                        # opacity logit
        model.out.bias[4:7] = float(np.log(0.2))       # log scale
    sd = {"gaussian_predictor.network_with_offset." + k: v
          for k, v in model.state_dict().items()}
    params = jax.tree_util.tree_map(
        jnp.asarray, JConv.convert_predictor(sd, JP.make_plan(pcfg)))

    class DS:
        camera_set, inverse_first_camera = Jcam.canonical_camera_set(
            jcfg.fov_deg, jcfg.radius, jcfg.look_at_z, jcfg.z_near, jcfg.z_far)
    jpack = JF.make_cameras_pack(jcfg, DS)
    tpack = TF.make_cameras_pack(tcfg, TD.canonical_cameras(tcfg))
    return jcfg, tcfg, pcfg, model, params, jpack, tpack


def test_loss_fn_terms_and_param_grads_match_jax():
    jcfg, tcfg, pcfg, model, params, jpack, tpack = _setup()
    b = batch(np.random.default_rng(0), 2)
    step = 3                       # a novel camera off the bank's first view

    vg = jax.jit(jax.value_and_grad(JF.loss_fn, has_aux=True),
                 static_argnums=(1, 2, 5))
    (lj, aux_j), gj = vg(params, jcfg, pcfg,
                         {k: jnp.asarray(v) for k, v in b.items()}, jpack,
                         JF.LossWeights(), step)
    lt, aux_t = TF.loss_fn(model, tcfg, b, tpack, TF.LossWeights(), step)
    lt.backward()
    assert not aux_t["overflow"].any()

    assert abs(lt.item() - float(lj)) <= 1e-4 * abs(float(lj))
    for k, v in aux_j.items():
        r = float(v)
        assert abs(aux_t[k].item() - r) <= 1e-4 * abs(r) + 1e-9, (k, r)
    ref = TConv.params_from_jax(jax.tree_util.tree_map(np.asarray, gj))
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=5e-3 * np.abs(r).max(), err_msg=name)


def test_tower_terms_match_jax():
    """With the VGG16 and CLIP towers given (random weights, the port's
    carried into JAX by the JAX package's converters), loss_fn at the
    reference yaml's w_perceptual 2 / w_clip 0.35 gives every term within
    1e-4 relative of JAX's, loss_perceptual and loss_clip included."""
    from f3d_gaus_tpu.models import clip as JCl
    from f3d_gaus_tpu.models import vgg as JV
    from f3d_gaus_torch.models import clip as TCl
    from f3d_gaus_torch.models import vgg as TV
    jcfg, tcfg, pcfg, model, params, jpack, tpack = _setup()
    gen = torch.Generator().manual_seed(2)
    vgg = TV.VGG16(gen).requires_grad_(False)
    clip = TCl.CLIPVisual(7, gen).requires_grad_(False)
    jtowers = {
        "vgg": JV.convert_torch_vgg16(
            {k: v.numpy() for k, v in vgg.state_dict().items()}),
        "clip": JCl.convert_torch_clip_visual(
            {f"visual.{k}": v.numpy() for k, v in clip.state_dict().items()})}
    w = TF.LossWeights(w_perceptual=2.0, w_clip=0.35)
    b = batch(np.random.default_rng(1), 1)
    step = 3
    lj, aux_j = jax.jit(JF.loss_fn, static_argnums=(1, 2, 5, 7))(
        params, jcfg, pcfg, {k: jnp.asarray(v) for k, v in b.items()}, jpack,
        JF.LossWeights(*w), step, JF.Curriculum(), jtowers)
    with torch.no_grad():
        lt, aux_t = TF.loss_fn(model, tcfg, b, tpack, w, step,
                               towers={"vgg": vgg, "clip": clip})
    assert not aux_t["overflow"].any()
    assert {"loss_perceptual", "loss_clip"} <= set(aux_j)
    assert abs(lt.item() - float(lj)) <= 1e-4 * abs(float(lj))
    for k, v in aux_j.items():
        r = float(v)
        assert abs(aux_t[k].item() - r) <= 1e-4 * abs(r) + 1e-9, (k, r)
