"""f3d_gaus_torch.eval and full_eval on the CPU: evaluate_dirs against
f3d_gaus_tpu.eval on the same PNGs, LPIPS from given weights, a run_scene /
full_eval layout smoke on a tiny Blender scene (device="cpu"), and the
copied utilities (the viewer socket's round trip, the logging sinks)."""
import json
import os
import socket

import numpy as np
import pytest
import torch

from f3d_gaus_tpu import eval as JE
from f3d_gaus_torch import eval as TE
from f3d_gaus_torch import full_eval as TFE
from f3d_gaus_torch.ops import rasterize as TR
from f3d_gaus_torch.pipeline import scene_io as TS
from f3d_gaus_torch.train import per_scene as TP
from f3d_gaus_torch.utils import logging as Tlog
from f3d_gaus_torch.utils.network_gui import NetworkGUI
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)


def _write_pngs(root, rng, n=3, size=(24, 40)):
    from PIL import Image
    rd, gd = root / "renders", root / "gt"
    rd.mkdir(), gd.mkdir()
    for i in range(n):
        img = rng.uniform(size=size + (3,))
        noisy = np.clip(img + rng.normal(scale=0.05 * (i + 1),
                                         size=img.shape), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(gd / f"{i}.png")
        Image.fromarray((noisy * 255).astype(np.uint8)).save(rd / f"{i}.png")
    Image.fromarray(np.zeros(size + (3,), np.uint8)).save(rd / "alone.png")
    return str(rd), str(gd)


def test_evaluate_dirs_matches_jax(tmp_path):
    rd, gd = _write_pngs(tmp_path, np.random.default_rng(0))
    j = JE.evaluate_dirs(rd, gd)
    out = str(tmp_path / "m.json")
    t = TE.evaluate_dirs(rd, gd, out_json=out, device="cpu")
    assert set(t["per_image"]) == set(j["per_image"]) == {"0.png", "1.png",
                                                          "2.png"}
    for name, vals in j["per_image"].items():
        for k, v in vals.items():
            np.testing.assert_allclose(t["per_image"][name][k], v, rtol=1e-5)
    for k, v in j["mean"].items():
        np.testing.assert_allclose(t["mean"][k], v, rtol=1e-5)
    assert json.load(open(out)) == t


def _vgg_files(root, seed=0):
    """A seeded torchvision-keyed vgg16 state_dict and LPIPS heads as .pt
    files (no pretrained file is in the repository)."""
    from f3d_gaus_torch.models import vgg as TV
    net = TV.VGG16(torch.Generator().manual_seed(seed))
    torch.save(net.state_dict(), root / "vgg16.pt")
    rng = np.random.default_rng(seed)
    torch.save({f"lin.{i}.1.weight": torch.from_numpy(
        rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(TV.N_CHANNELS)}, root / "lin.pt")
    return str(root / "vgg16.pt"), str(root / "lin.pt")


def test_lpips_is_gated(tmp_path):
    """As in the JAX package: lpips=True raises only without weights; with
    them, LPIPS (with and without the learned heads) equals JAX's."""
    with pytest.raises(NotImplementedError, match="VGG16 tower"):
        TE.evaluate_dirs(str(tmp_path), str(tmp_path), lpips=True,
                         device="cpu")
    rd, gd = _write_pngs(tmp_path, np.random.default_rng(1))
    vgg_pt, lin_pt = _vgg_files(tmp_path)
    for lin in (None, lin_pt):
        j = JE.evaluate_dirs(rd, gd, lpips=True, lpips_weights=vgg_pt,
                             lpips_lin_weights=lin)
        t = TE.evaluate_dirs(rd, gd, lpips=True, lpips_weights=vgg_pt,
                             lpips_lin_weights=lin, device="cpu")
        assert set(t["mean"]) == set(j["mean"]) == {"psnr", "ssim", "lpips"}
        for name, vals in j["per_image"].items():
            for k, v in vals.items():
                np.testing.assert_allclose(t["per_image"][name][k], v,
                                           rtol=1e-4)


def _write_blender_scene(root, rng, n_views=9, res=32):
    """tests/test_full_eval.py:_write_blender_scene on the port: lookat
    cameras on a ring around the origin written as Blender transforms, and
    a 48-Gaussian cloud rendered through the PARSED cameras."""
    from PIL import Image
    frames = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        p = np.array([3.0 * np.sin(ang), 0.6, 3.0 * np.cos(ang)], np.float32)
        f = -p / np.linalg.norm(p)
        r = np.cross(f, np.array([0.0, 1.0, 0.0], np.float32))
        r /= np.linalg.norm(r)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.stack([r, np.cross(r, f), -f], axis=1)
        c2w[:3, 3] = p
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    with open(os.path.join(root, "transforms_train.json"), "w") as f_:
        json.dump({"camera_angle_x": 0.6911, "frames": frames}, f_)
    data = TS.read_blender_scene(root, n_init_points=100)
    cloud = torch_cases.make_gaussian_cloud(
        rng, 48, center=(0.0, 0.0, 0.0), spread=0.35,
        scale_range=(0.06, 0.14))
    cloud[3][:] = 0.9
    for i, sc in enumerate(data.cameras):
        cam = sc.camera._replace(width=res, height=res)
        with torch.no_grad():
            img = TR.render(*[torch.from_numpy(a) for a in cloud], cam,
                            torch.zeros(3), pair_cap=1 << 12,
                            max_per_tile=128, chunk=32)["render"].numpy()
        arr = (np.clip(np.transpose(img, (1, 2, 0)), 0, 1)
               * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"train/r_{i}.png"))


def test_run_scene_reports_lpips(tmp_path):
    """run_scene with `lpips_weights` reports each split's LPIPS beside
    PSNR/SSIM, as the JAX package's does."""
    scene_dir = tmp_path / "scene1"
    _write_blender_scene(str(scene_dir), np.random.default_rng(0))
    cfg = TP.PerSceneConfig(
        iterations=4, densify_until_iter=0, opacity_reset_interval=1000,
        sh_degree=1, pair_cap=1 << 12, max_per_tile=512, chunk=64,
        cap_bucket=128)
    vgg_pt, _ = _vgg_files(tmp_path)
    summary = TFE.run_scene(str(scene_dir), str(tmp_path / "out"), cfg=cfg,
                            lpips_weights=vgg_pt, n_init_points=200,
                            device="cpu")
    assert np.isfinite(summary["test_lpips"]) and summary["test_lpips"] > 0
    res = json.load(open(tmp_path / "out" / "test" / "results.json"))
    assert set(res["mean"]) == {"psnr", "ssim", "lpips"}


def test_full_eval_layout_on_cpu(tmp_path):
    """full_eval -> run_scene -> fit_scene -> renders -> metrics on the
    CPU: the JAX package's layout (<out>/<scene>/<split>/{renders,gt}/*.png,
    per-split and per-scene results.json, full_eval.json), the llffhold-8
    split (9 views: 7 train, 2 test) and JAX's summary keys plus the
    overflowed-step count."""
    scene_dir = tmp_path / "scene1"
    _write_blender_scene(str(scene_dir), np.random.default_rng(0))
    cfg = TP.PerSceneConfig(
        iterations=12, densification_interval=5, densify_from_iter=4,
        densify_until_iter=11, opacity_reset_interval=1000, sh_degree=1,
        sh_degree_interval=5, pair_cap=1 << 12, max_per_tile=512, chunk=64,
        cap_bucket=128)
    out_root = tmp_path / "out"
    agg = TFE.full_eval([str(scene_dir)], str(out_root), cfg=cfg,
                        render_train=True, n_init_points=200, device="cpu")
    base = out_root / "scene1"
    for split, n in (("test", 2), ("train", 7)):
        for kind in ("renders", "gt"):
            assert sorted(os.listdir(base / split / kind)) == sorted(
                f"r_{i}.png" for i in range(9)
                if (i % 8 == 0) == (split == "test"))
        res = json.load(open(base / split / "results.json"))
        assert len(res["per_image"]) == n
    res = json.load(open(base / "results.json"))
    summary = res["summary"]
    assert set(summary) == {"scene", "iterations", "final_gaussians",
                            "overflow_steps", "overflow_test_renders",
                            "overflow_train_renders", "plan_s", "test_psnr",
                            "test_ssim", "train_psnr", "train_ssim"}
    assert summary["iterations"] == 12 and summary["final_gaussians"] > 0
    assert summary["overflow_steps"] == 0
    assert summary["overflow_test_renders"] == 0
    assert summary["overflow_train_renders"] == 0
    assert summary["plan_s"] > 0
    assert set(res["splits"]) == {"test", "train"}
    full = json.load(open(out_root / "full_eval.json"))
    assert full == json.loads(json.dumps(agg))
    assert set(full["mean"]) == {"test_psnr", "test_ssim", "train_psnr",
                                 "train_ssim"}
    assert all(np.isfinite(v) for v in full["mean"].values())


@pytest.mark.parametrize("caps", ["fixed", "plan"])
def test_truncated_renders_are_counted(tmp_path, caps):
    """At a max_per_tile too small for the scene, the JAX package's fixed
    caps truncate every step and both test renders, and the summary counts
    them; planned caps (run_scene's default) truncate none."""
    scene_dir = tmp_path / "scene1"
    _write_blender_scene(str(scene_dir), np.random.default_rng(0))
    cfg = TP.PerSceneConfig(
        iterations=4, densify_from_iter=100, sh_degree=1, pair_cap=1 << 12,
        max_per_tile=16, chunk=16, cap_bucket=128)
    summary = TFE.run_scene(str(scene_dir), str(tmp_path / "out"), cfg=cfg,
                            n_init_points=200, device="cpu", caps=caps)
    n = {"fixed": (4, 2), "plan": (0, 0)}[caps]
    assert (summary["overflow_steps"],
            summary["overflow_test_renders"]) == n
    assert (summary["plan_s"] > 0) == (caps == "plan")
    assert np.isfinite(summary["test_psnr"])


def _request(width=8, height=6):
    eye = np.eye(4, dtype=np.float32).reshape(-1).tolist()
    return {"resolution_x": width, "resolution_y": height, "train": True,
            "fov_x": 0.6, "fov_y": 0.6, "z_near": 0.2, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False,
            "keep_alive": True, "scaling_modifier": 1.0,
            "view_matrix": eye, "view_projection_matrix": eye}


def _send_msg(sock, obj):
    payload = json.dumps(obj).encode("utf-8")
    sock.sendall(len(payload).to_bytes(4, "little") + payload)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        buf += sock.recv(n - len(buf))
    return buf


def test_gui_socket_round_trip():
    """tests/test_network_gui.py on the port's copy: a request renders
    (with the viewer's column flips), the reply is RGB bytes + the verify
    string; a 0x0 ping gets no image."""
    gui = NetworkGUI(port=0)
    client = socket.create_connection(("127.0.0.1", gui.port))
    try:
        gui.poll(lambda cam: None)
        served = {}

        def render(cam):
            served.update(cam)
            img = np.zeros((3, cam["height"], cam["width"]), np.float32)
            img[0] = 1.0
            return img

        _send_msg(client, _request(8, 6))
        assert gui.poll(render, verify="path/to/model", timeout=5.0) is True
        np.testing.assert_array_equal(served["world_view"][:, 1],
                                      [0, -1, 0, 0])
        img = np.frombuffer(_recv_exact(client, 8 * 6 * 3),
                            np.uint8).reshape(6, 8, 3)
        assert (img[..., 0] == 255).all() and (img[..., 1:] == 0).all()
        n = int.from_bytes(_recv_exact(client, 4), "little")
        assert _recv_exact(client, n) == b"path/to/model"
        _send_msg(client, _request(0, 0))
        assert gui.poll(render, verify="ok", timeout=5.0) is True
        n = int.from_bytes(_recv_exact(client, 4), "little")
        assert _recv_exact(client, n) == b"ok"
    finally:
        client.close()
        gui.close()


def test_logging_sinks(tmp_path, capsys):
    with Tlog.Tee(str(tmp_path / "log.txt")):
        print("hello")
    assert open(tmp_path / "log.txt").read() == "hello\n"
    assert capsys.readouterr().out == "hello\n"
    log = Tlog.ScalarLog(str(tmp_path / "s.jsonl"))
    log.log(3, loss=0.5)
    rec = json.loads(open(tmp_path / "s.jsonl").read())
    assert rec["step"] == 3 and rec["loss"] == 0.5
