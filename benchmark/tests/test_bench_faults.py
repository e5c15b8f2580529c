"""A run with the timed path broken underneath must come out not correct:
one case for each fault a cell can have (on one chip there is no
exchange between chips to leave out).  The program runs its plain
versions here at the tiny sizes; the fault is planted in the program's
module, never in the reference."""
import pytest
import torch

from runs import run_cell


def _answer_altered_nvs(mp):
    from f3d_gaus_torch.pipeline import renderer
    orig = renderer.render_views_batched

    def altered(*a, **k):
        out = orig(*a, **k)
        out["render"] = out["render"].clone()
        out["render"][:, 0] += 0.05          # one view's image, every call
        return out
    mp.setattr(renderer, "render_views_batched", altered)


def _scene_state_unchanged(mp):
    from f3d_gaus_torch.train import per_scene as PS
    orig = PS.train_step

    def unchanged(scene, *a, **k):
        _, opt, stats, aux = orig(scene, *a, **k)
        return scene, opt, stats, aux
    mp.setattr(PS, "train_step", unchanged)


def _scene_answer_altered(mp):
    from f3d_gaus_torch.train import per_scene as PS
    orig = PS.train_step

    def altered(*a, **k):
        scene, opt, stats, aux = orig(*a, **k)
        return scene._replace(xyz=scene.xyz + 1e-3), opt, stats, aux
    mp.setattr(PS, "train_step", altered)


def _train_state_unchanged(mp):
    from f3d_gaus_torch.train import feedforward as F
    orig = F.train_step

    def unchanged(state, *a, **k):
        before = [p.detach().clone() for p in state.model.parameters()]
        out = orig(state, *a, **k)
        with torch.no_grad():
            for p, b in zip(state.model.parameters(), before):
                p.copy_(b)
        return out
    mp.setattr(F, "train_step", unchanged)


def _train_half_batch(mp):
    from f3d_gaus_torch.train import feedforward as F
    orig = F.loss_fn

    def half(model, cfg, batch, *a, **k):
        n = batch["images"].shape[0] // 2
        return orig(model, cfg, {k2: v[:n] for k2, v in batch.items()},
                    *a, **k)
    mp.setattr(F, "loss_fn", half)


def _train_answer_altered(mp):
    from f3d_gaus_torch.train import feedforward as F
    orig = F.loss_fn

    def altered(*a, **k):
        loss, aux = orig(*a, **k)
        return loss * 1.01, aux
    mp.setattr(F, "loss_fn", altered)


def _after_setup(fault):
    """`fault` on the window's steps only (set-up's steps run sound)."""
    from tiny import TINY_TRAFFIC
    first_steps = TINY_TRAFFIC["train_b6"]["first_steps"]

    def plant(mp):
        from f3d_gaus_torch.train import feedforward as F
        sound = F.train_step
        fault(mp)
        broken = F.train_step

        def step(state, *a, **k):
            fn = broken if state.step >= first_steps else sound
            return fn(state, *a, **k)
        mp.setattr(F, "train_step", step)
    return plant


def _train_half_batch_step(mp):
    from f3d_gaus_torch.train import feedforward as F
    orig = F.train_step

    def half(state, cfg, batch, *a, **k):
        n = batch["images"].shape[0] // 2
        return orig(state, cfg, {k2: v[:n] for k2, v in batch.items()},
                    *a, **k)
    mp.setattr(F, "train_step", half)


FAULTS = {
    "nvs_answer_altered": ("imagenetgs_256.nvs_b1", _answer_altered_nvs),
    "fit_state_unchanged": ("gof_nerf_synthetic_800.fit",
                            _scene_state_unchanged),
    "fit_answer_altered": ("gof_nerf_synthetic_800.fit",
                           _scene_answer_altered),
    "train_state_unchanged": ("imagenetgs_256.train_b6",
                              _train_state_unchanged),
    "train_half_batch": ("imagenetgs_256.train_b6", _train_half_batch),
    "train_answer_altered": ("imagenetgs_256.train_b6",
                             _train_answer_altered),
    "train_state_unchanged_in_window": (
        "imagenetgs_256.train_b6", _after_setup(_train_state_unchanged)),
    "train_half_batch_in_window": (
        "imagenetgs_256.train_b6", _after_setup(_train_half_batch_step)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    cell, plant = FAULTS[fault]
    plant(monkeypatch)
    rc, res, err = run_cell(tmp_path, cell)
    assert rc == 0, err
    assert res["correct"] is False, err
    assert any(v["value"] > v["limit"] for v in res["checks"].values())
