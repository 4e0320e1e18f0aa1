"""Serving launcher: prefill + batched greedy decode for any decoder
architecture (the JAX package's `launch/serve.py`).

The inference path end to end: cache init, the prompt stepped through
`decode_step` (state-correct for every family, rwkv and mamba included),
then greedy single-token decode steps.  Runs on the card unless
``--device`` names another; the reduced config in float32, the full one
in bfloat16.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --reduced \\
      --prompt-len 32 --gen 16 --batch 4 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_arch, reduce_arch
from ..models.model import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, params, tokens: torch.Tensor, gen: int) -> dict:
    """Step ``tokens`` (B, P) through `decode_step`, then decode ``gen``
    tokens greedily.  Returns ``logits`` (the last prompt step's, (B, V)),
    ``last_logits`` (the last decode step's), ``ids`` (B, gen), and the
    host seconds ``prefill_s``, ``decode_s`` and ``step_s`` (one a decode
    step), each ending in a device synchronise."""
    B, P = tokens.shape
    dev = tokens.device
    cache = model.init_cache(B, P + gen)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits = None
        for t in range(P):
            logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1], t)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        prompt_logits = logits
        out, steps = [], []
        cur = torch.argmax(logits, dim=-1)[:, None]
        t0 = time.perf_counter()
        for t in range(P, P + gen):
            out.append(cur)
            ts = time.perf_counter()
            logits, cache = model.decode_step(params, cache, cur, t)
            cur = torch.argmax(logits, dim=-1)[:, None]
            _sync(dev)
            steps.append(time.perf_counter() - ts)
        decode_s = time.perf_counter() - t0
    return dict(logits=prompt_logits, last_logits=logits,
                ids=torch.cat(out, dim=1), prefill_s=prefill_s,
                decode_s=decode_s, step_s=steps)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if arch.encoder_only:
        raise SystemExit(f"{arch.name} is encoder-only: no decode path")
    if args.reduced:
        arch = reduce_arch(arch)
    model = Model(arch, dtype=torch.float32 if args.reduced else torch.bfloat16,
                  device=args.device)
    params = model.init(0)
    g = torch.Generator(device=model.device).manual_seed(1)
    toks = torch.randint(0, arch.vocab, (args.batch, args.prompt_len),
                         generator=g, device=model.device)
    res = generate(model, params, toks, args.gen)
    t_gen = res["decode_s"]
    print(f"arch={arch.name} batch={args.batch}")
    print(f"prefill {args.prompt_len} tok: {res['prefill_s']:.2f}s; "
          f"decode {args.gen} tok: {t_gen:.2f}s "
          f"({args.gen * args.batch / max(t_gen, 1e-9):.1f} tok/s)")
    print("sample token ids:", [int(x) for x in res["ids"][0][:10]])
    if not bool(torch.isfinite(res["last_logits"]).all()):
        raise SystemExit("non-finite logits")
    print("OK")


if __name__ == "__main__":
    main()
