"""The port's parallel/mesh.py against the JAX package's (tests/
test_parallel.py): distributed_init's single-process no-op, its
environment forwarding and idempotence (init_process_group monkeypatched);
the meshes, shard_batch, replicate and shard_state's placements on 2 gloo
processes, the placements held against JAX's shard_state on the same
weights through the converters; sharded_train_step on 2 gloo processes at
B = 2 against one process's train_step at the tiny 32x32 config (the
averaged gradients within 5e-3 x max |g| and the parameters after one SGD
step within 5e-3 x max |delta| per tensor); and a
rank whose render overflows makes every rank raise, with no hang."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist
from f3d_gaus_tpu.models import convert as JConv
from f3d_gaus_tpu.models import predictor as JP
from f3d_gaus_tpu.parallel import mesh as JM
from f3d_gaus_tpu.pipeline import config as JC
from f3d_gaus_torch.parallel import mesh as TM
from f3d_gaus_torch.train import feedforward as TF

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def test_distributed_init_single_process_noop(monkeypatch):
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: called.append((a, k)))
    assert TM.distributed_init() is False
    assert TM.distributed_init(device="cpu") is False
    assert called == []


def test_distributed_init_env_forwarding_and_idempotence(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    called = []
    up = [False]

    def init(backend, **kw):
        called.append((backend, kw))
        up[0] = True
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "is_initialized", lambda: up[0])
    assert TM.distributed_init(device="cpu") is True
    assert called == [("gloo", {"init_method": "env://", "world_size": 4,
                                "rank": 2})]
    assert TM.distributed_init(device="cpu") is True      # idempotent
    assert len(called) == 1


def test_distributed_init_never_falls_back_to_gloo(monkeypatch):
    """Without a card the default (cuda) raises; gloo only when the CPU is
    asked for."""
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: pytest.fail("must not start"))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.distributed_init(init_method="file:///nowhere", world_size=2,
                            rank=0)


def _jax_sharded_names(cfg):
    """The port's parameter names whose JAX leaf shard_state shards over
    "model" on a model axis of 2 (the leaves named as models/convert.py:
    params_from_jax names them)."""
    _, state, _, _ = torch_dist.train_setup()
    sd = {"gaussian_predictor.network_with_offset." + k: v
          for k, v in state.model.state_dict().items()}
    tree = JConv.convert_predictor(sd, JP.make_plan(cfg.predictor_config()))
    out = JM.shard_state(JM.make_mesh(8, data=2, tile=2, model=2),
                         jax.tree_util.tree_map(jnp.asarray, tree))

    def sharded(x):
        return "model" in [a for a in (x.sharding.spec or ()) if a]
    names = set()
    for name, p in out["encoder"].items():
        for key, v in p.items():
            leaves = v.items() if isinstance(v, dict) else [(None, v)]
            for leaf, x in leaves:
                n = f"encoder.{name}.{key}" + (f".{leaf}" if leaf else "")
                if sharded(x):
                    names.add(n)
    names |= {f"out.{leaf}" for leaf, x in out["out"].items() if sharded(x)}
    return names


def test_meshes_and_shard_state_match_jax(tmp_path):
    ranks = torch_dist.run_ranks(torch_dist.mesh_rank, 2, tmp_path)
    want = _jax_sharded_names(JC.PipelineConfig(**torch_dist.TRAIN_TINY))
    assert want, "the tiny predictor has channel axes JAX shards"
    _, state, _, batch = torch_dist.train_setup()
    for rank, r in enumerate(ranks):
        assert r["tp"] == (("data", "tile", "model"), (1, 1, 2))
        assert r["global"] == (("data", "tile"), (1, 2))
        assert r["replicated"] == [1.0, 1.0, 1.0]
        assert r["batch"] == [float(batch["depth"][rank, 0, 0])]
        assert r["no_model_axis"] == {"Replicate()"}
        got = {k for k, v in r["placements"].items() if v != ["Replicate()"]
               * 3}
        assert got == want
        for k in got:
            x = state.model.state_dict()[k]
            dim = 0 if x.dim() == 4 else x.dim() - 1
            assert r["placements"][k] == ["Replicate()", "Replicate()",
                                          f"Shard(dim={dim})"]


def test_sharded_train_step_matches_one_process(tmp_path):
    ranks = torch_dist.run_ranks(torch_dist.train_rank, 2, tmp_path, -1)
    cfg, state, pack, batch = torch_dist.train_setup()
    before = torch_dist.params_of(state)
    TF.train_step(state, cfg, batch, pack)
    want = {k: v - before[k] for k, v in
            torch_dist.params_of(state).items()}
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    for r in ranks:
        for k, g in grads.items():
            np.testing.assert_allclose(
                r["grads"][k].numpy(), g.numpy(),
                atol=5e-3 * float(g.abs().max()) + 1e-12, err_msg=k)
        assert r["names"] == ("data", "tile") and r["shape"] == (2, 1)
        assert r["batch_rows"] == 1 and r["step"] == 1
        assert np.isfinite(r["loss"])
        for k, d in want.items():
            np.testing.assert_allclose(
                r["delta"][k].numpy(), d.numpy(),
                atol=5e-3 * float(d.abs().max()) + 1e-12, err_msg=k)
    for k in want:                     # the ranks hold one model
        torch.testing.assert_close(ranks[0]["delta"][k], ranks[1]["delta"][k],
                                   rtol=0, atol=0)


def test_an_overflow_on_one_rank_raises_on_every_rank(tmp_path):
    ranks = torch_dist.run_ranks(torch_dist.train_rank, 2, tmp_path, 1,
                                 timeout=120)
    for r in ranks:
        assert "exceeded the static caps" in r["raised"]
        # 3 renders an image (canonical, novel, cycle), rank 1's flagged
        assert r["raised"].startswith("3 of 6 renders")
        assert r["step"] == 0
        assert all(float(d.abs().max()) == 0 for d in r["delta"].values())
