"""The benchmark of the ocean step of `repro_torch` on one NVIDIA card.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: `configs/<config>.json` (the case
and its source), `traffic/<traffic>.json` (depth and split ratio),
`cells/<workload>.json` (the step's counted flops and the limits of the
comparison) and `metrics/<metric>.py` (one reader a per-layer metric).
`reference/` is the plain PyTorch step the program is held to.
"""
