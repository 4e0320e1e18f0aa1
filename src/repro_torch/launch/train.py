"""Training launcher: any architecture of the pool on one device (the JAX
package's `launch/train.py`).

The training path: arch config -> seeded parameters (bfloat16, float32
with --reduced) and AdamW state (float32 moments) -> the train step
(`value_and_grad` of `Model.loss`, K9 and K8 in their `autograd.Function`s
on the card, then `adamw.update`) -> the fault-tolerant `TrainRunner`
(checkpoints, resume, retry, preemption) over the deterministic
`TokenDataset`.  Runs on the card unless ``--device`` names another.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
      --steps 50 --batch 8 --seq 128 --device cpu

Not ported yet: ``--mesh`` (JAX's TP / FSDP mesh over `models/sharding.py`),
which is refused.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_arch, reduce_arch
from ..data.pipeline import TokenDataset
from ..models.model import Model, count_params, value_and_grad
from ..optim import adamw
from ..runtime.fault_tolerance import RunnerConfig, TrainRunner


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
                    help="not ported yet: the TP / FSDP mesh path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh: the TP / FSDP mesh path (models/sharding.py, "
                         "launch/mesh.py) is not ported yet; run without it")

    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduce_arch(arch)
    model = Model(arch, dtype=torch.float32 if args.reduced else torch.bfloat16,
                  device=args.device)
    total, active = count_params(model)
    print(f"arch={arch.name} params={total / 1e6:.1f}M "
          f"(active {active / 1e6:.1f}M)")

    params = model.init(0)
    opt = adamw.init(params)
    train_step = make_train_step(model, adamw.AdamWConfig(lr=args.lr))
    ds = TokenDataset(vocab=arch.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=0, device=model.device)
    losses = []

    def step_fn(state, batch):
        state, loss = train_step(state, batch)
        losses.append(float(loss))
        if len(losses) % 10 == 0:
            print(f"step {len(losses)} loss {losses[-1]:.4f}", flush=True)
        return state, {"loss": loss}

    runner = TrainRunner(step_fn, ds, RunnerConfig(
        checkpoint_dir=args.ckpt, checkpoint_every=args.ckpt_every))
    runner.run((params, opt), n_steps=args.steps)
    print(f"done; stats={runner.stats}")
    return losses


if __name__ == "__main__":
    main()
