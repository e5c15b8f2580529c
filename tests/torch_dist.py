"""A multi-process harness for the port's torch.distributed code on the
CPU (gloo), and the rank bodies the parallel tests run in it.

numpy, torch and f3d_gaus_torch only (no JAX): each rank is a `spawn`ed
process that imports this module.  The ranks meet through a file store in
the test's tmp_path, so no port can collide between concurrent test
workers, and `run_ranks` fails the test, killing the ranks, when they do
not finish within its timeout instead of hanging the suite.
"""
from __future__ import annotations

import multiprocessing as mp
import time
from pathlib import Path

import numpy as np
import torch

import torch_cases


def run_ranks(target, world: int, tmp_path, *args, timeout: float = 240.0):
    """Run target(rank, world, store_url, out_dir, *args) in `world`
    spawned processes and return what each rank saved with `save`."""
    ctx = mp.get_context("spawn")
    out = Path(tmp_path)
    store = f"file://{out / 'store'}"
    procs = [ctx.Process(target=target, args=(r, world, store, str(out),
                                              *args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish within {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def save(out_dir, rank, obj):
    torch.save(obj, Path(out_dir) / f"rank{rank}.pt")


def _init(rank, world, store):
    from f3d_gaus_torch.parallel import mesh
    torch.set_num_threads(1)
    assert mesh.distributed_init(init_method=store, world_size=world,
                                 rank=rank, device="cpu")


def _finish():
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# parallel/sharded.py
# ---------------------------------------------------------------------------

SHARDED_KW = dict(pair_cap=1 << 13, max_per_tile=256, chunk=32)
SHARDED_SETUPS = {"64x64": dict(n=96, width=64, height=64),
                  "64x128": dict(n=64, width=64, height=128)}
SHARDED_BG = np.array([0.1, 0.2, 0.3], np.float32)


def sharded_case(name):
    """tests/test_sharded.py:_setup's case `name` and a cotangent of out9
    with the alpha and median-depth channels zeroed."""
    cam, cloud = torch_cases.setup(np.random.default_rng(0),
                                   **SHARDED_SETUPS[name])
    w9 = np.random.default_rng(1).normal(
        size=(9, cam.height, cam.width)).astype(np.float32)
    w9[6] = w9[7] = 0.0
    return cam, cloud, w9


def render_and_grad(fn, cloud, w9):
    """fn(*five tensors) -> out dict; returns (out9, overflow, the five
    gradients of sum(out9 * w9))."""
    ts = [torch.from_numpy(a).requires_grad_() for a in cloud]
    out = fn(*ts)
    (out["out9"] * torch.from_numpy(w9)).sum().backward()
    return (out["out9"].detach().numpy(), bool(out["overflow"]),
            [t.grad.numpy() for t in ts])


def sharded_render_rank(rank, world, store, out_dir, case, gaussian_shard):
    from f3d_gaus_torch.parallel import sharded
    _init(rank, world, store)
    cam, cloud, w9 = sharded_case(case)
    got = render_and_grad(lambda *t: sharded.render_tile_sharded(
        None, *t, cam, torch.from_numpy(SHARDED_BG),
        gaussian_shard=gaussian_shard, **SHARDED_KW), cloud, w9)
    save(out_dir, rank, got)
    _finish()


# ---------------------------------------------------------------------------
# parallel/mesh.py
# ---------------------------------------------------------------------------

TRAIN_TINY = dict(resolution=32, base_dim=32, num_blocks=1,
                  attn_resolutions=(8,), model_channels=32, pair_cap=1 << 14,
                  max_per_tile=2048, chunk=128)


def train_setup(lr=1e-3):
    """The tiny config's seeded state with the head's biases set as in
    tests/test_torch_train_grad.py (opaque, 0.2 wide Gaussians 0.05 behind
    the input depth, out of the EDM init's f32 chaos), its cameras pack
    and a two-image batch.  The state's optimizer is plain SGD: a step's
    change is then -lr times the averaged gradient, where Adam's first
    step, g / (|g| + 1e-8) per element, would turn gradients that agree
    to 1e-4 x max |g| into changes a hundred times further apart wherever
    |g| is near 1e-6 (Adam itself is held in tests/test_torch_train.py)."""
    from f3d_gaus_torch.pipeline import config as TC
    from f3d_gaus_torch.pipeline import dataset as TD
    from f3d_gaus_torch.train import feedforward as TF
    cfg = TC.PipelineConfig(**TRAIN_TINY)
    state = TF.init_state(torch.Generator().manual_seed(0), cfg, lr=lr,
                          device="cpu")
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=lr)
    with torch.no_grad():
        state.model.out.bias[2] = 0.05
        state.model.out.bias[3] = 1.0
        state.model.out.bias[4:7] = float(np.log(0.2))
    pack = TF.make_cameras_pack(cfg, TD.canonical_cameras(cfg), n_banks=1,
                                views_per_bank=1)
    rng = np.random.default_rng(0)
    batch = {"images": rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
             "depth": rng.uniform(6.8, 8.5, size=(2, 32, 32)).astype(
                 np.float32)}
    return cfg, state, pack, batch


def params_of(state):
    return {k: v.detach().clone() for k, v in
            state.model.named_parameters()}


def train_rank(rank, world, store, out_dir, overflow_rank):
    """One sharded_train_step at B = 2 over `world` data ranks; with
    overflow_rank >= 0, that rank's renders report an overflow."""
    from f3d_gaus_torch.parallel import mesh
    from f3d_gaus_torch.pipeline import renderer
    from f3d_gaus_torch.train import feedforward as TF
    _init(rank, world, store)
    cfg, state, pack, batch = train_setup()
    if rank == overflow_rank:
        render = TF.renderer.render_views_batched

        def overflowing(*a, **k):
            out = render(*a, **k)
            return {**out, "overflow": torch.ones_like(out["overflow"])}
        TF.renderer.render_views_batched = overflowing
    m = mesh.make_mesh(data=world)
    step = mesh.sharded_train_step(m, cfg)
    before = params_of(state)
    result = {"names": m.mesh_dim_names, "shape": tuple(m.shape),
              "batch_rows": mesh.shard_batch(m, batch)["images"].shape[0]}
    try:
        loss, _ = step(state, batch, pack)
        result["loss"] = float(loss)
    except renderer.RenderOverflow as e:
        result["raised"] = str(e)
    result["step"] = state.step
    result["grads"] = {k: p.grad for k, p in state.model.named_parameters()}
    result["delta"] = {k: v - before[k] for k, v in params_of(state).items()}
    save(out_dir, rank, result)
    _finish()


def mesh_rank(rank, world, store, out_dir):
    """make_mesh / make_global_mesh / shard_state / shard_batch /
    replicate on `world` ranks."""
    from f3d_gaus_torch.parallel import mesh
    _init(rank, world, store)
    cfg, state, _, batch = train_setup()
    tp = mesh.make_mesh(world, data=1, tile=1, model=world)
    glob = mesh.make_global_mesh(tile=world)
    placements = mesh.shard_state(tp, state.model)
    rep = mesh.replicate(glob, {"x": torch.full((3,), float(rank + 1))})
    result = {
        "tp": (tp.mesh_dim_names, tuple(tp.shape)),
        "global": (glob.mesh_dim_names, tuple(glob.shape)),
        "placements": {k: [repr(p) for p in v] for k, v in placements.items()},
        "no_model_axis": {repr(p) for v in mesh.shard_state(
            glob, state.model).values() for p in v},
        "replicated": rep["x"].tolist(),
        "batch": mesh.shard_batch(mesh.make_mesh(data=world), batch)[
            "depth"][:, 0, 0].tolist(),
    }
    save(out_dir, rank, result)
    _finish()
