"""Run one cell of the benchmark once on this machine's card and print its
result as the last line of standard output.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy time.  The
numbers compared with the plain reference, each beside its limit, end
standard error and end the result line (``checks``).  A cell of one chip
runs in this process on cuda:0 (`harness.run_cell`); a cell of P chips as
P ranks, one a card over NCCL (`ranks.run_cell`), whose set-up time counts
from this process's start.  Exits non-zero and prints no result without
the cards the cell asks for, when a rank fails or the ranks outlast their
deadline, or when the run cannot be judged.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own kernel library builds into build/kernels/ there by itself)
CACHE = ROOT / "build" / "bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench import harness, spec

    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    if chips == 1:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0),
                               T_START)
    else:
        from bench import ranks
        try:
            out = ranks.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), chips, T_START)
        except ranks.RankFailure as exc:
            print(exc, file=sys.stderr)
            return 1
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']:.6e} (limit {c['limit']:.6e})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
