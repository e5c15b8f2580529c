"""The device mesh and data-parallel training on torch.distributed
(counterpart of f3d_gaus_tpu/parallel/mesh.py).

The reference is strictly single-GPU; the JAX package lays its devices out
as a named mesh:

  * "data"  — batch data-parallelism: each rank takes its slice of the
    batch and the parameter gradients are averaged over the ranks;
  * "tile"  — spatial parallelism inside one render: the frame's tile
    rows are split over the ranks (parallel/sharded.py);
  * "model" — tensor-parallel placement of the UNet's channel axes
    (`shard_state`; the placements only, as in the JAX package's tests).

Here the mesh is a torch.distributed.device_mesh.DeviceMesh over the ranks
of the default process group, which `distributed_init` starts (NCCL for
the card, gloo only when the CPU is asked for).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..core.device import resolve_device


def distributed_init(backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, device=None) -> bool:
    """Start the default process group so a mesh can span every rank.

    Environment-driven when the arguments are omitted (torch's launcher
    contract: MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK).  Returns
    False, touching nothing, for one process (no world size given or in
    the environment); True once the group is up.  Idempotent: a second
    call does nothing.  The backend follows `device` (default `cuda`,
    which raises without a card): 'nccl' for the card, 'gloo' only when
    the CPU is asked for; it never falls back on its own."""
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if world_size is None:
        return False                       # one process: nothing to do
    if dist.is_initialized():
        return True
    if rank is None:
        rank = int(os.environ["RANK"])
    if init_method is None:
        if not os.environ.get("MASTER_ADDR"):
            raise ValueError("distributed_init needs init_method or "
                             "MASTER_ADDR / MASTER_PORT in the environment")
        init_method = "env://"
    if backend is None:
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count()
                                  if dev.index is None else dev.index)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call distributed_init first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_global_mesh(data: int | None = None, tile: int = 1) -> DeviceMesh:
    """A (data, tile) mesh over every rank of the default group; ranks in
    order, so the "tile" axis keeps neighbouring ranks together."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = n // tile
    if data * tile != n:
        raise ValueError(f"data {data} x tile {tile} != {n} ranks")
    return DeviceMesh(_device_type(), np.arange(n).reshape(data, tile),
                      mesh_dim_names=("data", "tile"))


def make_mesh(n_devices: int | None = None, data: int | None = None,
              tile: int | None = None, model: int = 1) -> DeviceMesh:
    """A (data, tile[, model]) mesh over the first n_devices ranks (default
    all).  Default factorisation: every rank on "data"; tile > 1 splits a
    render's tile rows, model > 1 adds the tensor-parallel axis."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        tile = tile or 1
        data = n_devices // (tile * model)
    tile = tile or (n_devices // (data * model))
    if data * tile * model != n_devices:
        raise ValueError(f"data {data} x tile {tile} x model {model} != "
                         f"{n_devices} ranks")
    shape = (data, tile, model) if model > 1 else (data, tile)
    names = ("data", "tile", "model")[:len(shape)]
    return DeviceMesh(_device_type(), np.arange(n_devices).reshape(shape),
                      mesh_dim_names=names)


def shard_batch(mesh: DeviceMesh, batch: dict) -> dict:
    """This rank's slice of the batch's leading axis over "data"."""
    n = mesh["data"].size()
    i = mesh["data"].get_local_rank()

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} not divisible by the "
                             f"{n} data ranks")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]
    return {name: take(x) for name, x in batch.items()}


def replicate(mesh: DeviceMesh, tree: dict) -> dict:
    """Every tensor of `tree` broadcast from the mesh's first rank (new
    tensors on the mesh's device)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    src = int(mesh.mesh.flatten()[0])
    out = {}
    for name, x in tree.items():
        t = torch.as_tensor(x).to(dev).clone().contiguous()
        dist.broadcast(t, src=src)
        out[name] = t
    return out


def shard_state(mesh: DeviceMesh, state, axis: str = "model",
                min_channels: int = 64) -> dict:
    """Tensor-parallel placements of the predictor's parameters: for each
    name of `state` (a state_dict or a module), one DTensor placement per
    mesh dimension.  JAX's rule: a channel axis of at least `min_channels`
    that divides by the `axis` dimension's size is sharded over it, the
    rest replicate, and everything replicates on a mesh without `axis`.
    JAX shards the trailing axis of its layouts; here that axis is the one
    it becomes under models/convert.py:params_from_jax: dim 0 (the output
    channels, OIHW) of a 4-D convolution, the last dim otherwise."""
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    names = mesh.mesh_dim_names
    rep = tuple(Replicate() for _ in names)
    if axis not in names:
        return {k: rep for k in state}
    D = mesh[axis].size()
    out = {}
    for k, x in state.items():
        dim = 0 if x.dim() == 4 else x.dim() - 1
        if D > 1 and x.dim() >= 1 and x.shape[dim] >= min_channels \
                and x.shape[dim] % D == 0:
            out[k] = tuple(Shard(dim) if n == axis else Replicate()
                           for n in names)
        else:
            out[k] = rep
    return out


def sharded_train_step(mesh: DeviceMesh, cfg, lr: float | None = None):
    """The feed-forward train step data-parallel over the mesh's "data"
    ranks: returns step(state, batch, cameras_pack, weights=, cur=,
    timings=, towers=), which takes this rank's slice of the (full, host)
    batch and runs feedforward.train_step on it with the gradients
    averaged over the data ranks (DistributedDataParallel's semantics).
    The parameters are broadcast from the first data rank at a state's
    first step.  If a render of any rank's slice exceeds the caps, every
    rank raises RenderOverflow together before its backward.  `lr`, when
    given, is set on the state's optimizer."""
    from ..train import feedforward as F
    group = mesh.get_group("data")
    src = dist.get_global_rank(group, 0)
    synced = set()

    def step(state, batch, cameras_pack, weights=F.LossWeights(),
             cur=F.Curriculum(), timings=None, towers=None):
        if id(state) not in synced:
            for p in state.model.parameters():
                dist.broadcast(p.data, src=src, group=group)
            synced.add(id(state))
        if lr is not None:
            for g in state.optimizer.param_groups:
                g["lr"] = lr
        return F.train_step(state, cfg, shard_batch(mesh, batch),
                            cameras_pack, weights, cur, timings, towers,
                            group=group)
    return step
