"""Training launcher: any architecture of the pool, on one device or a mesh
(the JAX package's `launch/train.py`).

The training path: arch config -> seeded parameters (bfloat16, float32
with --reduced) and AdamW state (float32 moments) -> the train step
(`value_and_grad` of `Model.loss`, K9 and K8 in their `autograd.Function`s
on the card, then `adamw.update`) -> the fault-tolerant `TrainRunner`
(checkpoints, resume, retry, preemption) over the deterministic
`TokenDataset`.  Runs on the card unless ``--device`` names another.

``--mesh DxM`` lays the state out on a ("data", "model") mesh of D*M ranks
by JAX's rules (`models/sharding`): TP over "model" when the mesh has it,
FSDP over "data" when there is more than one rank, the moments on the
parameters' placements, and each batch by `sharding.batch_pspecs` over the
data-parallel axes.  Every leaf is a DTensor and every rank runs the same
step; the attention and WKV cores launch K9 / K8 on the rank's own heads.
Without an initialized process group `main` starts the D*M ranks itself
(`distributed.spawn.run`: gloo processes on the CPU, or processes that
share the card over the staged gloo group) and returns rank 0's losses.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
      --steps 50 --batch 8 --seq 128 --device cpu [--mesh 2x2]
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_arch, reduce_arch
from ..configs.base import ShapeSpec
from ..data.pipeline import TokenDataset
from ..models import sharding
from ..models.model import Model, count_params, value_and_grad
from ..optim import adamw
from ..runtime.fault_tolerance import RunnerConfig, TrainRunner
from .mesh import MeshSpec, axis_names, dp_axes, make_mesh

MESH_TIMEOUT_S = 24 * 3600.0    # the deadline of a run that --mesh spawns


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    inplace: bool = False):
    """JAX's `train_step`: state (params, opt), batch -> (state, loss).
    ``inplace``: `adamw.update` writes into the state's tensors (one copy of
    the model state; see `optim/adamw.py`)."""
    def train_step(state, batch):
        params, opt = state
        loss, grads = value_and_grad(model.loss, params, batch)
        params, opt = adamw.update(grads, opt, params, opt_cfg, inplace=inplace)
        return (params, opt), loss
    return train_step


def parse_mesh(text: str) -> tuple:
    """"2x4" -> (2, 4)."""
    return tuple(int(x) for x in text.split("x"))


def mesh_layout(model: Model, mesh, world: int):
    """JAX's launcher rules on ``mesh``: the parameter specs (TP over
    "model" when the mesh has it, FSDP over "data" when ``world`` > 1)."""
    tp = "model" if "model" in axis_names(mesh) else None
    return sharding.param_pspecs(model, mesh, tp=tp,
                                 fsdp="data" if world > 1 else None)


class MeshBatches:
    """A dataset's batches laid out on a mesh by `sharding.batch_pspecs`
    over the mesh's data-parallel axes (every rank draws the same global
    batch and keeps its rows)."""

    def __init__(self, ds, model: Model, mesh):
        self.ds, self.mesh = ds, mesh
        shape = ShapeSpec("train", "train", ds.seq_len, ds.global_batch)
        self.specs = sharding.batch_pspecs(model, shape, mesh,
                                           dp=dp_axes(mesh))

    def batch_at(self, step: int) -> dict:
        batch = self.ds.batch_at(step)
        return sharding.distribute(batch, {k: self.specs[k] for k in batch},
                                   self.mesh)


def _mesh_rank(rank: int, n_ranks: int, argv) -> list:
    return main(argv)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x4 => ('data','model'); default: one device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    mesh = None
    rank = 0
    if args.mesh:
        import torch.distributed as dist
        shp = parse_mesh(args.mesh)
        world = 1
        for n in shp:
            world *= n
        device = torch.device("cuda" if args.device is None else args.device)
        if not dist.is_initialized():
            from ..distributed import spawn
            return spawn.run(_mesh_rank, world, args=(argv,),
                             timeout_s=MESH_TIMEOUT_S, device=device.type)[0]
        mesh = make_mesh(MeshSpec(shp, ("data", "model")[:len(shp)]),
                         device.type)
        rank = dist.get_rank()

    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduce_arch(arch)
    model = Model(arch, dtype=torch.float32 if args.reduced else torch.bfloat16,
                  device=args.device)
    total, active = count_params(model)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"arch={arch.name} params={total / 1e6:.1f}M "
        f"(active {active / 1e6:.1f}M)")

    params = model.init(0)
    ds = TokenDataset(vocab=arch.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=0, device=model.device)
    if mesh is not None:
        params = sharding.distribute(params, mesh_layout(model, mesh, world),
                                     mesh)
        ds = MeshBatches(ds, model, mesh)
        say(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
            f"{mesh.device_type}")
    opt = adamw.init(params)
    train_step = make_train_step(model, adamw.AdamWConfig(lr=args.lr))
    losses = []

    def step_fn(state, batch):
        state, loss = train_step(state, batch)
        losses.append(float(loss))
        if len(losses) % 10 == 0:
            say(f"step {len(losses)} loss {losses[-1]:.4f}", flush=True)
        return state, {"loss": loss}

    runner = TrainRunner(step_fn, ds, RunnerConfig(
        checkpoint_dir=args.ckpt, checkpoint_every=args.ckpt_every))
    runner.run((params, opt), n_steps=args.steps)
    say(f"done; stats={runner.stats}")
    return losses


if __name__ == "__main__":
    main()
