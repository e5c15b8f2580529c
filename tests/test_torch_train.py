"""f3d_gaus_torch.train against f3d_gaus_tpu.train: every loss primitive on
the same numpy inputs, one Adam step against optax.adam on the same
gradients, the curriculum's camera banks and picks, a checkpoint round
trip, and a few steps of the feed-forward trainer on the CPU at a tiny
size.  loss_fn term by term and its parameter gradients are held against
JAX in tests/test_torch_train_grad.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f3d_gaus_tpu.core import cameras as Jcam
from f3d_gaus_tpu.pipeline import config as JC
from f3d_gaus_tpu.train import feedforward as JF
from f3d_gaus_tpu.train import losses as JL
from f3d_gaus_torch.models import convert as TConv
from f3d_gaus_torch.pipeline import config as TC
from f3d_gaus_torch.pipeline import dataset as TD
from f3d_gaus_torch.pipeline import renderer as Trenderer
from f3d_gaus_torch.train import checkpoint as Tckpt
from f3d_gaus_torch.train import feedforward as TF
from f3d_gaus_torch.train import losses as TL

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

# the tiny config of tests/test_feedforward.py, with a window that holds
# every pair (the port refuses a truncated render)
TINY = dict(resolution=32, base_dim=32, num_blocks=1, attn_resolutions=(8,),
            model_channels=32, pair_cap=1 << 14, max_per_tile=2048, chunk=128)


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-12))


def batch(rng, B, res=32):
    return {"images": rng.uniform(size=(B, res, res, 3)).astype(np.float32),
            "depth": rng.uniform(6.8, 8.5, size=(B, res, res)).astype(np.float32)}


def test_loss_primitives_match_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(size=(2, 3, 24, 20)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(2, 1, 24, 20)) > 0.3
    ta, tb, tm = map(torch.from_numpy, (a, b, mask))
    n1 = rng.normal(size=(2, 3, 24, 20)).astype(np.float32)
    n2 = rng.normal(size=(2, 3, 24, 20)).astype(np.float32)
    pairs = [
        (JL.l1(a, b), TL.l1(ta, tb)),
        (JL.psnr(a, b), TL.psnr(ta, tb)),
        (JL.tv(a), TL.tv(ta)),
        (JL.masked_l1(a, b, mask), TL.masked_l1(ta, tb, tm)),
        (JL.normal_consistency(n1, n2), TL.normal_consistency(
            torch.from_numpy(n1), torch.from_numpy(n2))),
        (JL.normal_consistency(n1, n2, mask[:, 0]), TL.normal_consistency(
            torch.from_numpy(n1), torch.from_numpy(n2), tm[:, 0])),
        (JL.ssim(a, b), TL.ssim(ta, tb)),
    ]
    for i, (r, g) in enumerate(pairs):
        assert _rel(r, g.numpy()) <= 1e-5, i
    assert TL.tv(torch.ones(2, 1, 8, 8)).item() == 0.0


def test_ssim_grad_matches_jax():
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(size=(1, 3, 16, 16)).astype(np.float32) for _ in range(2))
    gj = jax.grad(lambda x: JL.ssim(x, b))(jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_()
    TL.ssim(ta, torch.from_numpy(b)).backward()
    assert _rel(gj, ta.grad.numpy()) <= 1e-4


@pytest.mark.parametrize("yaw", [0.0, 0.15])
def test_warp_from_view_matches_jax(yaw):
    """yaw 0: a view warped into itself (the identity resample of
    tests/test_feedforward.py); 0.15: into a novel view of the bank grid."""
    cfg = TC.PipelineConfig(**dict(TINY, resolution=16))
    cano = TD.canonical_cameras(cfg)
    dst = TF.make_cameras_pack(cfg, cano, n_banks=1, views_per_bank=1)
    if yaw:
        dst_wv = Jcam.build_camera_set(
            np.array([yaw], np.float32), np.array([0.05], np.float32),
            cfg.radius, cfg.look_at_z, cfg.fov_deg, cfg.z_near, cfg.z_far,
            rebase=cano.inverse_first_camera).world_view[0]
    else:
        dst_wv = dst.cano_wv
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(3, 16, 16)).astype(np.float32)
    depth = rng.uniform(7.4, 7.9, size=(1, 16, 16)).astype(np.float32)
    args = (dst.cano_wv, dst.cano_fp)
    wj, vj = JL.warp_from_view(jnp.asarray(img), *map(jnp.asarray, args),
                               jnp.asarray(depth), jnp.asarray(dst_wv), 16, 16,
                               cfg.tan_fov, cfg.tan_fov)
    wt, vt = TL.warp_from_view(torch.from_numpy(img), *args,
                               torch.from_numpy(depth), dst_wv, 16, 16,
                               cfg.tan_fov, cfg.tan_fov)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.float().mean() > 0.5
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    if not yaw:
        assert np.abs(wt.numpy() - img)[:, vt.numpy()].max() < 1e-4


def test_curriculum_and_banks_match_jax():
    jcfg, tcfg = JC.PipelineConfig(**TINY), TC.PipelineConfig(**TINY)
    for cur in (TF.Curriculum(), TF.Curriculum(start_diff=24, final_diff=6,
                                               start_iter=0, end_iter=100)):
        jcur = JF.Curriculum(*cur)
        for i in range(4):
            for r, g in zip(JF.bank_angles(jcur, i, 4, 5),
                            TF.bank_angles(cur, i, 4, 5)):
                np.testing.assert_array_equal(g, r)

        class DS:
            camera_set, inverse_first_camera = Jcam.canonical_camera_set(
                jcfg.fov_deg, jcfg.radius, jcfg.look_at_z, jcfg.z_near,
                jcfg.z_far)
        jp = JF.make_cameras_pack(jcfg, DS, jcur, n_banks=4, views_per_bank=4)
        tp = TF.make_cameras_pack(tcfg, TD.canonical_cameras(tcfg), cur,
                                  n_banks=4, views_per_bank=4)
        for r, g in zip(jp, tp):
            np.testing.assert_array_equal(g, np.asarray(r))
        for step in (0, 1, 7, 33, 50, 99, 100, 500):
            for r, g in zip(JF.select_novel_camera(jp, jnp.asarray(step), jcur),
                            TF.select_novel_camera(tp, step, cur)):
                np.testing.assert_array_equal(g, np.asarray(r))


def _state(lr=1e-4):
    cfg = TC.PipelineConfig(**TINY)
    return cfg, TF.init_state(torch.Generator().manual_seed(0), cfg, lr=lr,
                              device="cpu")


def test_train_step_is_one_optax_adam_update():
    """train_step's update equals optax.adam's on the gradients the step
    computed (left in .grad), from the same parameters, to one float32
    rounding of the parameter (the update itself is ~lr = 1e-3)."""
    cfg, state = _state(lr=1e-3)
    pack = TF.make_cameras_pack(cfg, TD.canonical_cameras(cfg), n_banks=1,
                                views_per_bank=1)
    p0 = {k: v.detach().clone().numpy()
          for k, v in state.model.named_parameters()}
    loss, aux = TF.train_step(state, cfg, batch(np.random.default_rng(3), 1),
                              pack)
    assert np.isfinite(loss.item()) and state.step == 1
    grads = {k: v.grad.numpy() for k, v in state.model.named_parameters()}
    opt = optax.adam(1e-3)
    updates, _ = opt.update(grads, opt.init(p0), p0)
    for k, v in state.model.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), p0[k] + updates[k],
                                   rtol=2.5e-7, atol=1e-8, err_msg=k)


def test_train_steps_decrease_the_loss():
    """Five applied steps on a fixed novel camera (tests/test_feedforward.py:
    64-95): every term finite, parameters moved, the last loss below the
    first."""
    cfg, state = _state()
    pack = TF.make_cameras_pack(cfg, TD.canonical_cameras(cfg), n_banks=1,
                                views_per_bank=1)
    b = batch(np.random.default_rng(4), 2)
    p0 = state.model.out.weight.detach().clone()
    seen, timings = [], {}
    for _ in range(5):
        loss, aux = TF.train_step(state, cfg, b, pack, timings=timings)
        seen.append(loss.item())
        assert not aux["overflow"].any()
        for k in ("loss_rgb", "loss_depth", "loss_normal", "loss_alpha",
                  "loss_tv", "loss_warping", "loss_cycle"):
            assert np.isfinite(aux[k].item()), k
    assert seen[-1] < seen[0], seen
    assert (state.model.out.weight - p0).abs().max() > 0
    assert set(timings) == {"forward", "backward", "optimizer"}


def test_train_step_refuses_truncated_renders():
    """A render over the caps raises RenderOverflow before any update."""
    cfg, state = _state()
    cfg = dataclasses.replace(cfg, max_per_tile=32)
    pack = TF.make_cameras_pack(cfg, TD.canonical_cameras(cfg), n_banks=1,
                                views_per_bank=1)
    p0 = state.model.out.bias.detach().clone()
    with pytest.raises(Trenderer.RenderOverflow):
        TF.train_step(state, cfg, batch(np.random.default_rng(5), 1), pack)
    assert state.step == 0 and torch.equal(state.model.out.bias, p0)
    assert state.model.out.bias.grad is None


def test_perceptual_and_clip_are_gated():
    """As in the JAX package: a nonzero w_perceptual / w_clip raises only
    without its tower; a tower that is not frozen is refused; with both
    towers the two terms are finite and the towers take no gradient."""
    from f3d_gaus_torch.models import clip as TCl
    from f3d_gaus_torch.models import vgg as TV
    cfg, state = _state()
    pack = TF.make_cameras_pack(cfg, TD.canonical_cameras(cfg))
    b = batch(np.random.default_rng(6), 1)
    for w in (TF.LossWeights(w_perceptual=1.0), TF.LossWeights(w_clip=0.3)):
        with pytest.raises(NotImplementedError):
            TF.loss_fn(state.model, cfg, b, pack, w)
    gen = torch.Generator().manual_seed(1)
    towers = {"vgg": TV.VGG16(gen), "clip": TCl.CLIPVisual(7, gen)}
    w = TF.LossWeights(w_perceptual=2.0, w_clip=0.35)
    with pytest.raises(ValueError, match="frozen"):
        TF.loss_fn(state.model, cfg, b, pack, w, towers=towers)
    for t in towers.values():
        t.requires_grad_(False)
    loss, aux = TF.loss_fn(state.model, cfg, b, pack, w, towers=towers)
    terms = [aux["loss_perceptual"].detach(), aux["loss_clip"].detach()]
    assert all(torch.isfinite(t) and float(t) > 0 for t in terms)
    loss.backward()
    assert state.model.out.weight.grad is not None
    assert all(p.grad is None for t in towers.values()
               for p in t.parameters())


def test_checkpoint_round_trip(tmp_path):
    cfg, state = _state()
    pack = TF.make_cameras_pack(cfg, TD.canonical_cameras(cfg), n_banks=1,
                                views_per_bank=1)
    TF.train_step(state, cfg, batch(np.random.default_rng(7), 1), pack)
    Tckpt.save(str(tmp_path / "step_1"), state)
    (tmp_path / "step_10").mkdir()
    (tmp_path / "other").mkdir()
    assert Tckpt.latest_step_dir(str(tmp_path)) == str(tmp_path / "step_10")
    assert Tckpt.latest_step_dir(str(tmp_path / "missing")) is None
    _, fresh = _state()
    assert Tckpt.restore(str(tmp_path / "step_1"), fresh) is fresh
    assert fresh.step == 1
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for pid, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][pid][k]), (pid, k)
    # the restored state keeps training exactly as the original does
    b = batch(np.random.default_rng(8), 1)
    la, _ = TF.train_step(state, cfg, b, pack)
    lb, _ = TF.train_step(fresh, cfg, b, pack)
    assert la.item() == lb.item()
