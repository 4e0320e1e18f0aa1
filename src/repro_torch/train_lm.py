"""End-to-end LM training script (the JAX package's `examples/train_lm.py`):
the training stack on one device.

Trains a reduced-width OLMo-family model (default ~20M params; --full_100m
for ~100M) on a synthetic token stream through the real runtime: AdamW,
the fault-tolerant runner (checkpoints, resume, retry, preemption) and the
deterministic data pipeline.  The loss must decrease: the end-to-end check
of the training substrate.  Runs on the card unless ``--device`` names
another.

    PYTHONPATH=src python -m repro_torch.train_lm --steps 200
    PYTHONPATH=src python -m repro_torch.train_lm --steps 20 --batch 2 \\
        --seq 64 --device cpu
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from .configs import get_arch
from .data.pipeline import TokenDataset
from .launch.train import make_train_step
from .models.model import Model, count_params
from .optim import adamw
from .runtime.fault_tolerance import RunnerConfig, TrainRunner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full_100m", action="store_true")
    ap.add_argument("--ckpt_dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_lm_ckpt"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    base = get_arch("olmo-1b")
    if args.full_100m:
        arch = dataclasses.replace(base, n_layers=8, d_model=768,
                                   n_heads=12, n_kv=12, d_ff=3072,
                                   vocab=32768, remat=False)
    else:
        arch = dataclasses.replace(base, n_layers=4, d_model=384,
                                   n_heads=6, n_kv=6, d_ff=1536,
                                   vocab=8192, remat=False)
    model = Model(arch, dtype=torch.float32, device=args.device)
    total, _ = count_params(model)
    print(f"model: {arch.n_layers}L d={arch.d_model} "
          f"({total / 1e6:.1f}M params)")

    params = model.init(0)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, weight_decay=0.01)
    opt = adamw.init(params)
    ds = TokenDataset(vocab=arch.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=0, device=model.device)
    train_step = make_train_step(model, opt_cfg)

    losses = []

    def step_fn(state, batch):
        state, loss = train_step(state, batch)
        losses.append(float(loss))
        if len(losses) % 20 == 0:
            print(f"step {len(losses):4d} loss {losses[-1]:.4f} "
                  f"(avg20 {sum(losses[-20:]) / 20:.4f})", flush=True)
        return state, {"loss": loss}

    runner = TrainRunner(
        step_fn, ds,
        RunnerConfig(checkpoint_dir=args.ckpt_dir, checkpoint_every=50))
    t0 = time.time()
    runner.run((params, opt), n_steps=args.steps, resume=True)
    wall = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / max(wall, 1e-9)
    print(f"\n{args.steps} steps in {wall:.1f}s ({tok_s:.0f} tok/s); "
          f"runner stats: {runner.stats}")
    first = sum(losses[:10]) / max(len(losses[:10]), 1)
    last = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    print(f"loss: first10 {first:.4f} -> last10 {last:.4f}")
    assert last < first, "loss did not decrease"
    print("OK: loss decreased; checkpoints in", args.ckpt_dir)
    return losses


if __name__ == "__main__":
    main()
