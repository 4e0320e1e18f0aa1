#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: 160,000 triangles x 16 layers
    python3 chip_smoke.py --k7-only [--src DIR]   # K7 at (16, 160000) only
    python3 chip_smoke.py --k7-depths             # K7's variants over depths
    python3 chip_smoke.py --campaign-only         # the build and phase 7
    python3 chip_smoke.py --distributed-only      # the build and phase 8
    python3 chip_smoke.py --serve-only            # the build and phase 9
    python3 chip_smoke.py --train-only            # the build and phase 10
    python3 chip_smoke.py --mesh-only             # the build and phase 11
    python3 chip_smoke.py --dryrun-only           # the build and phase 12
    python3 chip_smoke.py --lm-dryrun-only        # the build and phase 13

With --k7-only, K7 through the default call of the repro_torch found in
DIR (an earlier checkout's, to time two kernels in one run), by the three
methods of phase 3; with --k7-depths, both of K7's variants at depths
around the plan's switch to global (the source of tridiag.MIN_BLOCKS);
with --campaign-only, the build and phase 7 (phase 4's bare step is not
run, so the runner's overhead over it is not printed); with
--distributed-only, the build and phase 8; with --serve-only, the build
and phase 9; with --train-only, the build and phase 10; with --mesh-only,
the build and phase 11; with --dryrun-only, the build and phase 12; with
--lm-dryrun-only, the build and phase 13.  Each prints its
lines, a JSON line and the card's name and power limit.
Phases of the run with no arguments:

(each prints its own lines; any failure raises and exits non-zero):

  1. device   — the card's name and power limit;
  2. build    — compiles every source under src/repro_torch/csrc/
                (ocean_kernels.cu: K1-K7, model_kernels.cu: K8,
                flash_attention.cu: K9) with one nvcc each, all at once,
                links them into one library and prints the registers /
                spills `-Xptxas -v` reports (K3 by instantiation,
                block_thomas_<dtype>_k<k>_tc<tile>_<variant>); then counts,
                in each K9 variant's SASS (`cuobjdump -sass`), the wgmma (HGMMA), TMA
                load (UTMALDG), cp.async (LDGSTS) and FFMA instructions, and
                in each K5/K6 variant's the global loads and stores (LDG,
                STG) and those 128 bits wide, in each K8 instantiation
                (wkv6_<dtype>_k<K>_r<R>c<C>) the shuffles (SHFL), async
                copies (LDGSTS, UTMALDG) and packed bf16 multiplies (HMUL2),
                and in each K7 instantiation (tridiag_<dtype>_<variant>,
                onchip or global) the global loads and stores, cp.async
                copies, shared and local accesses (LDG, STG, LDGSTS, STS,
                LDS, STL, LDL) and the global loads that come after a
                global store in the code;
                and fails unless every bf16 K9 variant has HGMMA and
                UTMALDG, every float32 one LDGSTS, every vector K5/K6
                variant 128-bit loads and stores, every K8 instantiation
                SHFL and LDGSTS or UTMALDG (and HMUL2 in bf16), every K7
                onchip instantiation stores to device memory only x,
                after its last load (no STL or LDL, no LDG after an STG),
                and no K8 or K7 instantiation spills;
  3. kernels  — each CUDA kernel (K1 solve_r, K2 solve_w, K3 block_thomas,
                K4 lateral_flux, K5 soa_to_cell, K6 cell_to_soa, K7 tridiag)
                against its plain PyTorch version at the main path's shapes,
                in float32 and float64, from seeded inputs, with
                CUDA-event times against the memory bound (K3 through its
                launch plan's onchip tile, then every narrower onchip tile
                and the global variant, each forced by a lower smem_limit,
                timed in two rounds, each with its
                shared bytes, tiles per SM and ptxas registers, the global
                variant with its scratch traffic; then the shallowest depth
                the plan sends to the global variant, at the same 160,000
                columns; K3's bound counts only the blocks its solve reads,
                not lo[0] and up[nl-1]; K5/K6 must equal their plain versions bitwise, at nt = 160,000 through the
                vector variant, at a ragged nt and with inputs that are not
                16-byte aligned through the scalar one, each case's variant
                checked and logged; their one-call PyTorch permutation is
                timed beside them, and both also by torch.profiler's device
                time per kernel, by events with the device kept busy while
                the host enqueues, and in one CUDA graph of 20 calls, with
                the wrapper's host time per call); K7 bitwise, at
                (16, 160,000) through both variants (the plan's onchip,
                then global, forced through plan=), at nt = 159,963
                through the plan, at the first depth the plan gives to
                global through both and at the first depth past shared
                memory, each timed in two rounds by CUDA events as the
                other kernels are (the table's ms) and by primed events,
                then by the profiler's device time, with its host time a
                call, registers and SASS counts; at (16, 160,000) its
                time before the redesign (K7_BEFORE_MS) and the 0.70
                share of the bound are checked by each of the three
                times, in the log lines only;
  4. main path — 3 steps of the quickstart's baroclinic-front case widened to
                rect_mesh(400, 200) (~333 m cells, 160,000 triangles, 16
                layers; 20 external sub-steps, which the setup picks for
                this mesh's thinnest triangle) through the cuda backend,
                with the launch counters read just after (K1, K2, K3 twice
                a step, K4 and K7, the GLS diffusion, four times); then the
                step boundary: state_to_cell -> state_from_cell of the
                stepped state (bitwise round trip, 4 launches each of K5
                and K6) and the state's GLS diffusion systems through
                ops.tridiag (K7, bitwise to thomas_solve); every cuda
                dispatch in the metrics registry must match one kernel
                launch.  Then the same 3 steps through the plain backend on
                the card, counted the same way, which must agree; then 10
                more cuda steps, timed for the steady ms/step.  Run in
                float32 and again in float64;
  5. observed step — 3 steps of the same case in float64 through
                obs.diagnostics.step_with_diagnostics, writing metrics JSONL
                into chiprun_out/, held by a halting MonitorPolicy (non-finite
                values, volume and T/S mass drift); then
                `python -m repro_torch.obs_smoke --device cuda`, which must
                exit 0;
  5b. GBR     — the paper's §5 case (`repro_torch.gbr_reef`: reef
                bathymetry from 12 to 120 m, Jackett EOS, GLS, Coriolis, an
                M2 tide on the open boundary at x = lx, trade wind,
                open-boundary T/S) at the resolution of the reference's
                `gbr` dry-run cell, on rect_mesh(400, 200) of 625 x 403.1 km:
                160,000 triangles x 20 layers, dt 45 s, float64, m_2d the
                larger of 20 and `quickstart.external_substeps` at the
                deepest point (logged).  3 cuda steps, each with its
                forcing at its time, counted (K1, K2, K3 twice a step, K4
                and K7 four times; the dispatch registry must agree); the
                same 3 steps through the plain backend, held to TOL_PATH;
                10 more cuda steps timed (ms/step, physical/wall, peak
                memory, |surface vorticity| p50/p99); then, from the state
                after the counted steps, one per-call step
                (fused_horizontal=False, which must launch no lateral_flux)
                and one fused step on each backend, with the time and
                working memory of each: per-call against fused is held to
                PER_CALL_TOL of max(|x|, 1) per field on plain, and to
                TOL_PATH of each field's maximum on cuda, where K4 rounds
                otherwise than lat_scatter and the step amplifies kernel
                rounding as it does for cuda against plain (all four
                pairs' differences are logged);
  6. model kernels — ops.wkv6 (K8) and ops.attention (K9) through `auto`
                on CUDA tensors at the full widths of the repo's LM configs
                (rwkv6-3b, olmo-1b, gemma2-9b local layer, hubert-xlarge),
                in float32 and bfloat16 from seeded numpy inputs: one
                counted call each (its launch read just after), held
                against the kernel's plain version on the card (bfloat16:
                each output row within 2e-2 of its own largest value), then
                timed against its bound (and, for olmo-1b and hubert-xlarge,
                against scaled_dot_product_attention, a yardstick that the
                port never calls); K9's lines add the SFU's exp floor (one
                exp per unmasked pair) and its time before the redesign
                for the tensor cores; K8's add every launch plan the
                launcher takes for the shape (wkv6.alternatives: each block
                width of the dtype's thread tile, forced through plan=),
                each held against the plain version and timed in two rounds
                with its blocks per SM and registers, its time before the
                redesign (K8_BEFORE_MS) and the bound under the unfactored
                count of 7 flops an element beside this one.  The times
                before the redesigns and the 7-flop bound are printed in
                these lines only, not in the JSON kernel table;
  7. campaign — `repro_torch.launch.sim_campaign` through SimulationRunner
                (step_with_diagnostics, a halting MonitorPolicy, a
                checkpoint every 2 steps, 2 kept, under a temp dir deleted
                as it goes) on phase 4's case in float64 at full width,
                CAMPAIGN_STEPS steps a leg, every leg on the card counted
                (K1, K2, K3 twice for each step it ran, retried ones
                included, K4 and K7 four times; the registry must agree):
                two fault-free legs, which must end bitwise equal (the
                step is deterministic on the card); then nan-poison,
                corrupt checkpoint, preemption with a resumed leg, and a
                failed async save, each bitwise equal to them; the last
                checkpoint restored onto the CPU and, saved from there,
                back onto the card, bitwise; the checkpoint's bytes, a
                save's caller-side copy and worker ms, a restore's ms with
                its crc32 verification, each leg's ms a step and the
                runner's step time beside phase 4's bare float64 step;
                then, on the small case of the JAX dt-ladder test
                (rect_mesh(4, 3), dt 80 s), blind retry exhausting 4
                retries and the dt ladder ending at rung 1 at t = 160 s,
                and a recovery resharded cuda -> CPU and CPU -> cuda
                (`reshard` at `runner.restore_shardings`), each bitwise
                equal to a leg resumed on that device; then
                `python -m repro_torch.chaos_smoke` and `python -m
                repro_torch.launch.sim_campaign` with a poisoned step,
                with no --device (the card), which must exit 0;
  8. distributed — `repro_torch.distributed` on ranks that share the card
                (one process each on cuda:0, started by
                `distributed.spawn.run` with a deadline; the transport is
                gloo-staged, since NCCL refuses two ranks on one device):
                phase 4's case in float64 at full width, 3 steps on 4 ranks
                per stage (halo_exchange_period 0, 1-deep halo), then 3 on
                2 ranks comm-avoiding (period 2, 6-deep halo), each rank
                through the CUDA kernels (backend auto); rank 0 reads the
                initial state from a global checkpoint and scatters it,
                and the gathered state is saved by rank 0; that state must
                be within 1e-10 of each field's max (eta 1e-12) of the
                single-device cuda step on the card with identity hooks
                and the same period, and within TOL_PATH of the
                single-device ref step; every rank's tensors on the card,
                its cuda launches PER_STEP a step (equal to the registry's
                kernel_dispatch counts), and halo.ppermute a step equal to
                the closed form of distributed/halo.py.  Prints per
                rank n_own, n_loc, halo slots, offsets, exchanges and bytes
                a step, step times and peak memory; ms a step of steps 2-3
                (the slowest rank's, between barriers) beside the
                single-device cuda and ref steps'.  These ranks time-share
                one card and stage every exchange through the host: their
                ms is a record of this path, not a scaling figure;
  9. serve    — the LM serving path (`repro_torch.models`,
                `repro_torch.launch.serve`) at the full width and depth of
                olmo-1b (16 layers, d 2048, K9 at d 128, causal) and
                rwkv6-3b (32 layers, d 2560, 40 heads of 64, K8), with the
                port's seeded parameters, in float32 and then bfloat16,
                under `torch.inference_mode()`: `Model.prefill` of 4 x 512
                seeded tokens through `auto` (K9 once an attention layer,
                K8 once an RWKV layer, counted, the registry's cuda
                dispatches equal), against `plain` on the card; then
                `serve.generate` (the 512 prompt tokens stepped through
                `decode_step`, then 32 greedy tokens), which must launch
                neither kernel, its last prompt-step logits against the
                prefill's; both held to SERVE_TOL of max |logit| (1e-3 in
                float32, 5e-2 in bfloat16); then 3 timed prefills.  Prints
                prefill ms and tokens/s, decode ms a token and tokens/s at
                batch 4 (min and max over the 32 steps), peak memory, the
                phase's seconds and the card's name and power limit;
 10. train    — the LM training path (`models.model.value_and_grad`, K9
                and K8 in their `autograd.Function`s, `optim.adamw`,
                `launch.train`, `TrainRunner`): (a) K9's row statistics m
                and l against the plain version's at phase 6's attention
                shapes (STATS_TOL; the output with them bitwise the output
                without) and K9's time with and without them at olmo-1b's;
                each Function's gradients (kernel forward, plain backward)
                against autograd through the plain version at KGRAD_CASES
                (olmo-1b's heads at T 2048; gemma2-9b's local layer, window
                4096 and soft-cap 50, at T 6144; rwkv6-3b's heads at T
                512), f32 and bf16, within KGRAD_TOL of max |g|; the plain
                backwards' ms a layer at (c)'s shapes; (b) olmo-1b and
                rwkv6-3b at 2 layers, full width, f32, B 2 x T 512: every
                gradient leaf on cuda within 1e-4 of its max |g| on plain,
                the loss within 1e-5; (c) both at full depth, bf16
                parameters, f32 moments, remat on, B 4 (rwkv6-3b 2) x T
                1024, 10 in-place AdamW steps through TrainRunner on one
                repeated batch: every step's launches (K9 32, K8 64) as
                predicted, the loss falling, ms a step and tok/s over steps
                3-5, peak memory; (d) `python -m repro_torch.launch.train
                --arch olmo-1b --reduced --steps 20` on the card, exit 0;
 11. mesh     — the LM mesh path (`launch.mesh`, `models.sharding`,
                DTensor leaves, K9 and K8 under `local_map`, `adamw` on
                shards, the staged gloo group of `distributed.staged`):
                olmo-1b and rwkv6-3b at full width and depth, bfloat16
                parameters, float32 moments, remat, phase 10's B x T and
                repeated batch, on a 2 x 2 ("data", "model") mesh of 4
                ranks that share the card (one process each on cuda:0,
                `distributed.spawn.run(device="cuda")`), laid out by
                `launch.train`'s rules (TP over "model", FSDP over
                "data"), MESH_STEPS in-place AdamW steps (olmo-1b 3,
                rwkv6-3b 2) from the parameters of phase 10's seed,
                against the same steps on one device (its leaves kept on
                the card, which the ranks read through CUDA IPC): the
                losses, each leaf's float32 m and v after the first and the
                last step (of its max, each rank its own shards) and its
                parameters (error norm over the change), as MESH_HELD says,
                each within its limit or twice the model's own floor (the
                single-device steps again with the kernels' outputs
                perturbed by half a bfloat16 ulp); every rank's
                launches a step as one device's (K9 32, K8 64), each call
                on the rank's B / 2 rows of H / 2 heads, the first step's
                calls held against plain on their inputs; prints per rank
                the step times between barriers, the staged collectives and
                their bytes a step, peak memory; ms a step on the slowest
                rank, tokens/s, and the card's name and power limit.  The
                ranks time-share one card: not a scaling figure;
 12. dry run  — the ocean dry run (`launch/ocean_dryrun.trace_ocean`):
                rank 0 of the `benchmark` and `benchmark-ca2` cells traced
                on fake groups of the two production meshes, (16, 16) = 256
                and (2, 16, 16) = 512 ranks, on the card through the CUDA
                kernels, and `benchmark` at 256 ranks once more on the CPU
                (plain); each record must hold: its exchanges and bytes a
                step equal to the closed forms of distributed/halo.py, the
                five step kernels' launches a step equal to PER_STEP (the
                CUDA wrappers' own counts on the card), and n_own / n_loc
                equal to DRYRUN_SIZES; the card's `hlo.bytes` and
                `hlo.flops` of `benchmark` at 256 ranks must equal the
                CPU's.  Every kernel call of each card trace's warm-up
                step (f32, nl 32, n_loc 913 / 1,399 / 493 / 881 columns)
                is run again, not counted, on its own operands
                and with its data replaced by seeded normals (DRYRUN_FREE):
                K7 bitwise equal to plain, K3 within TOL in backward error
                (`block_residual`), K1, K2, K4 against plain as `held` on
                their own operands, within TOL of max |plain| on seeded
                ones (`hold_ocean_calls`); the card's state after the
                counted step of `benchmark` at 256 ranks must be finite,
                and its distance to the CPU's is printed beside the CPU's
                own between the plain and ref backends (in f32, with the
                exchanges faked, the state does not reproduce across
                summation orders, so it is not held to a tolerance).
                Prints each record's roofline summary (on the H100
                model), its memory and traffic, and the rank step's ms over
                DRYRUN_TIMED steps on the card with the exchanges faked
                ("one rank, no communication": not a scaling figure)
                beside its roofline memory_s and its count of eager ops.
 13. LM dry run — `launch/lm_dryrun.trace_cell` on a fake group of the
                (16, 16) production mesh, traced on fake CUDA tensors:
                olmo-1b train_4k and prefill_32k, rwkv6-3b prefill_32k and
                decode_32k (LMDRY_CELLS); olmo-1b train_4k's record must
                equal a CPU trace of the same cell (LMDRY_HELD; started in
                a subprocess after the build, so it runs beside phases
                3-12) in hlo.bytes, hlo.flops and argument bytes.  Each
                distinct K9 / K8 call the traces record (the rank's local
                shapes, dtype and options) is run once through `ops`
                on `auto` on seeded operands of that shape (counted: the
                kernels line's `launches_lm_dryrun`; both must launch),
                held against plain as phase 6 holds it (`model_held`), and
                timed beside its bound from `roofline/kernels.py` and its
                share of the bound.  Prints each record's roofline summary,
                its bytes, flops, collectives by kind and peak.

The line before the last is the card's `nvidia-smi` name and power limit;
the line before that is the JSON kernel table (K8's and K9's `launches`
are one training step's of phase 10, their prefills' under
`launches_serve`, phase 11's ranks' under `launches_mesh`, phase 12's
traced steps' under `launches_dryrun`, phase 13's calls at the dry run's
shapes under `launches_lm_dryrun`); the last line is {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# cycles of the sleep kernel that primes an event timing: ~10 ms at the
# H100's 1,980 MHz, longer than the host takes to enqueue 20 calls
PRIME_CYCLES = 20_000_000
TOL = {torch.float32: 1e-5, torch.float64: 1e-12,
       # model kernels against their plain versions, each output row (one
       # query or token of one head) against its own largest |plain|: bf16
       # rounds q * scale, p, k v^T, u k v^T and the output at other places
       # than the plain version does (see model_held)
       torch.bfloat16: 2e-2}
# cuda vs plain backend after the main path's 3 steps; the two differ only
# in summation order.  float64: every field within 1e-8 of its own maximum.
# float32: the temperature and salinity within 1e-4 * max(|x|_inf, 1); the
# other fields are printed, not held to a tolerance, because in float32
# this case does not reproduce across summation orders, in the JAX
# reference as in the port (tests/test_torch_f32_spread.py): rho' = rho -
# rho0 is formed in float32, N^2 is its difference across a 1.25 m layer,
# and the GLS closure turns that noise into differences of several percent
# in eps and nu_t within one step, which reach the velocities through nu_t.
TOL_PATH = {torch.float32: 1e-4, torch.float64: 1e-8}
HELD_F32 = ("T", "S")
SOURCE = "src/repro_torch/csrc/ocean_kernels.cu"
MODEL_SOURCE = {"wkv6": "src/repro_torch/csrc/model_kernels.cu",
                "flash_attention": "src/repro_torch/csrc/flash_attention.cu"}
REPLACES = {
    "wkv6": "src/repro/kernels/wkv6.py:28",
    "flash_attention": "src/repro/kernels/flash_attention.py:70",
    "solve_r": "src/repro/kernels/matrix_free.py:103",
    "solve_w": "src/repro/kernels/matrix_free.py:114",
    "block_thomas": "src/repro/kernels/column_solve.py:90",
    "lateral_flux": "src/repro/kernels/horizontal_flux.py:96",
    "soa_to_cell": "src/repro/kernels/cell_transpose.py:41",
    "cell_to_soa": "src/repro/kernels/cell_transpose.py:61",
    "tridiag": "src/repro/kernels/tridiag.py:51",
}
PER_STEP = {"solve_r": 2, "solve_w": 2, "block_thomas": 2, "lateral_flux": 4,
            "tridiag": 4}
# launches of the step boundary: state_to_cell + state_from_cell of the 4
# 3D fields, and the GLS k and eps diffusion systems through ops.tridiag
BOUNDARY = {"soa_to_cell": 4, "cell_to_soa": 4, "tridiag": 2}
# the case of each kernel that goes into the JSON table
TABLE_CASE = {"solve_r": "K=2", "solve_w": "K=1", "block_thomas": "k=2",
              "lateral_flux": "k=4", "soa_to_cell": "nt=160000",
              "cell_to_soa": "nt=160000", "tridiag": "nt=160000"}
# phase 6: the model kernels at the widths of configs/archs.py (name: op,
# batch, heads, sequence, head dim, options); BH = batch * heads
MODEL_CASES = {
    "rwkv6-3b": dict(op="wkv6", B=8, H=40, T=4096, d=64),          # RWKV6_3B
    "olmo-1b": dict(op="attention", B=8, H=16, T=4096, d=128,       # OLMO_1B
                    causal=True),
    "gemma2-9b-local": dict(op="attention", B=1, H=16, T=8192,     # GEMMA2_9B
                            d=256, causal=True, window=4096, softcap=50.0),
    "hubert-xlarge": dict(op="attention", B=8, H=16, T=4096, d=80,  # HUBERT_XLARGE
                          causal=False),
}
MODEL_TABLE_CASE = {"wkv6": "rwkv6-3b", "flash_attention": "olmo-1b"}
# K9's times before its redesign for the tensor cores (the FP32-pipe kernel,
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md's K9 rows), printed beside this run's
K9_BEFORE_MS = {("olmo-1b", "f32"): 22.5265, ("olmo-1b", "bf16"): 22.3221,
                ("gemma2-9b-local", "f32"): 20.4772,
                ("gemma2-9b-local", "bf16"): 20.3391,
                ("hubert-xlarge", "f32"): 31.2539,
                ("hubert-xlarge", "bf16"): 31.4286}
# K8's times before its redesign (the kernel that held one column a thread;
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md's K8 row), printed beside this run's
K8_BEFORE_MS = {("rwkv6-3b", "f32"): 4.2210, ("rwkv6-3b", "bf16"): 7.2299}
# K7's times before its redesign (the kernel with a global cp scratch, at
# (16, 160000); NVIDIA H100 80GB HBM3 at 700 W, PERF.md's K7 row), printed
# beside this run's
K7_BEFORE_MS = {"f32": 0.0369, "f64": 0.0724}
SFU_EX2_PER_CLOCK = 16 * 132   # MUFU.EX2 results per clock: 16 per SM, 132 SMs
RAGGED_NT = 159963    # a column count that is not a multiple of the cell
OBS_DRIFT_MAX = 1e-10  # volume and T/S mass drift over the observed steps
NX, NL = 400, 16      # rect_mesh(400, 200): 160,000 triangles x 16 layers
STEPS = 3             # counted steps of the main path, compared with plain
TIMED_STEPS = 10      # further steps, timed for the steady ms/step
SEED = 0              # kernel-phase inputs
CAMPAIGN_STEPS = 6    # phase 7: steps a campaign leg
# per-call vs fused step on the plain backend, of max(|x|_inf, 1) per field
PER_CALL_TOL = 1e-11
ROOT = Path(__file__).resolve().parent


def log(*a):
    print(*a, flush=True)


def sm_clock_mhz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def module_env() -> dict:
    """The environment in which `python -m repro_torch...` finds this
    checkout's package."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: build report
# ---------------------------------------------------------------------------
def kernel_variant(name: str):
    """'solve_r_f32', 'block_thomas_f64_k2_tc16_onchip',
    'flash_attention_bf16_d128', 'soa_to_cell_f32_v4', 'wkv6_bf16_k64_r8c4',
    'tridiag_f32_onchip' from a mangled entry name, or None (K8's kernels
    are wkv6_kernel<T, K, R, C>, K7's tridiag_kernel<T, ONCHIP>,
    K3's block_thomas_kernel<T, K, TC, ONCHIP>,
    K9's flash_bf16_kernel<D> and flash_f32_kernel<D>, K5/K6's
    soa_to_cell_kernel<T, VEC, N> and cell_to_soa_kernel<T, VEC, N>).  The
    kernel's identifier is found by its length prefix, since the
    (anonymous) namespace's mangled name before it may end in digits."""
    wk = re.search(r"wkv6_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E",
                   name)
    if wk:     # K8: head dimension, rows and columns of S a thread holds
        dt = "f32" if wk.group(1) == "f" else "bf16"
        return f"wkv6_{dt}_k{wk.group(2)}_r{wk.group(3)}c{wk.group(4)}"
    fa = re.search(r"flash_(bf16|f32)_kernelILi(\d+)E", name)
    if fa:
        return f"flash_attention_{fa.group(1)}_d{fa.group(2)}"
    bt = re.search(r"block_thomas_kernelI(f|d)Li(\d+)ELi(\d+)ELb([01])E", name)
    if bt:     # K3: k, tile width, variant
        dt = {"f": "f32", "d": "f64"}[bt.group(1)]
        var = "onchip" if bt.group(4) == "1" else "global"
        return f"block_thomas_{dt}_k{bt.group(2)}_tc{bt.group(3)}_{var}"
    tr = re.search(r"tridiag_kernelI(f|d)Lb([01])E", name)
    if tr:     # K7: variant
        dt = {"f": "f32", "d": "f64"}[tr.group(1)]
        return f"tridiag_{dt}_{'onchip' if tr.group(2) == '1' else 'global'}"
    ct = re.search(r"(soa_to_cell|cell_to_soa)_kernelI(f|d)Li(\d+)E", name)
    if ct:     # K5 / K6: v = elements per access, 1 in the scalar variant
        dt = {"f": "f32", "d": "f64"}[ct.group(2)]
        return f"{ct.group(1)}_{dt}_v{ct.group(3)}"
    k = re.search(r"_kernelI(f|d|13__nv_bfloat16)(?:Li(\d+)E)?", name)
    if not k:
        return None
    head = name[:k.start() + len("_kernel")]
    for n in range(len("_kernel") + 1, len(head)):
        if head[-n].isalpha() and head[:-n].endswith(str(n)):
            kernel = head[-n:-len("_kernel")]
            break
    else:
        return None
    var = f"{kernel}_{ {'f': 'f32', 'd': 'f64'}.get(k.group(1), 'bf16')}"
    if k.group(2):
        var += f"_k{k.group(2)}"
    return var


def ptxas_summary(report: str) -> dict:
    """{kernel variant: {registers, spill_stores, spill_loads}} from the
    `-Xptxas -v` report."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            var = kernel_variant(m.group(1))
            if var:
                cur = var
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "FFMA")
# K5/K6: global loads and stores, and those 128 bits wide (`.128`)
COPY_OPS = ("LDG", "STG", "LDG.128", "STG.128")
COPY_KERNELS = ("soa_to_cell", "cell_to_soa")
# K8: warp shuffles (the lanes' partial sums, sum r u k), cp.async (the
# tiles), packed bfloat16 multiplies (k v rounded to bfloat16), FMAs
WKV_OPS = ("SHFL", "LDGSTS", "UTMALDG", "HMUL2", "FFMA")
# K7: global loads and stores, cp.async, shared and local (spill) accesses;
# LDG_after_STG counts the global loads that come after the first global
# store in the code
TRI_OPS = ("LDG", "STG", "LDGSTS", "STS", "LDS", "STL", "LDL", "LDG_after_STG")


def disassembler() -> str:
    """Path of a `cuobjdump` that can read the library: the toolkit's, else
    the copy Triton ships."""
    from repro_torch.kernels import cuda_lib
    cands = [Path(cuda_lib.nvcc()).parent / "cuobjdump"]
    try:
        import triton
        cands.append(Path(triton.__file__).parent / "backends" / "nvidia"
                     / "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in cands:
        if c.exists():
            return str(c)
    raise RuntimeError(f"no cuobjdump found (looked at {[str(c) for c in cands]})")


def sass_counts(so: Path) -> tuple:
    """({variant: {op: count}}, the tool used) from `cuobjdump -sass` of the
    built library: the ops of SASS_OPS in each K9 variant, those of
    COPY_OPS in each K5/K6 variant (an opcode with a `.128` modifier, as
    in `LDG.E.EF.128`, counts under its op and under op.128), WKV_OPS in
    each K8 instantiation and TRI_OPS in each K7 one."""
    tool = disassembler()
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            var = kernel_variant(m.group(1)) or ""
            cur = None
            if var.startswith("flash_attention"):
                cur, ops = var, SASS_OPS
            elif var.startswith(COPY_KERNELS):
                cur, ops = var, COPY_OPS
            elif var.startswith("wkv6"):
                cur, ops = var, WKV_OPS
            elif var.startswith("tridiag"):
                cur, ops = var, TRI_OPS
            if cur:
                out[cur] = dict.fromkeys(ops, 0)
            continue
        if cur:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9]*)((?:\.[A-Z0-9_]+)*)", line)
            if not m:
                continue
            op, mods = m.group(1), m.group(2).split(".")[1:]
            if op in out[cur]:
                out[cur][op] += 1
            if op == "LDG" and "LDG_after_STG" in out[cur] and out[cur]["STG"]:
                out[cur]["LDG_after_STG"] += 1
            if "128" in mods and f"{op}.128" in out[cur]:
                out[cur][f"{op}.128"] += 1
    return out, tool


def check_sass(counts: dict) -> None:
    """Every bf16 K9 variant issues wgmma (HGMMA) and TMA loads (UTMALDG);
    every float32 one cp.async (LDGSTS); every vector K5/K6 variant
    (float4, double2) 128-bit global loads and stores; every K8
    instantiation warp shuffles (SHFL) and async copies (LDGSTS or
    UTMALDG: each plan with an access width of 4 bytes or more copies its
    tiles by cp.async), and each bfloat16 one the packed multiply (HMUL2)
    that rounds k v; every K7 onchip instantiation stores nothing to device
    memory but x, and only after its last load: no local access and no LDG
    after an STG in its code."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    for var in tridiag_instantiations():
        c = counts.get(var, {})
        if not c.get("LDG") or not c.get("STG"):
            raise AssertionError(f"{var}: no global loads or stores in its "
                                 f"SASS ({c})")
        if var.endswith("onchip") and (c["STL"] or c["LDL"]
                                       or c["LDG_after_STG"]):
            raise AssertionError(f"{var}: stores before its backward sweep's "
                                 f"x, or spills ({c})")
    for var in wkv6_instantiations():
        c = counts.get(var, {})
        if not c.get("SHFL") or not (c.get("LDGSTS") or c.get("UTMALDG")):
            raise AssertionError(f"{var}: no SHFL or no LDGSTS / UTMALDG in "
                                 f"its SASS ({c})")
        if "bf16" in var and not c.get("HMUL2"):
            raise AssertionError(f"{var}: no HMUL2 in its SASS ({c})")
    for kernel in COPY_KERNELS:
        for var in (f"{kernel}_f32_v4", f"{kernel}_f64_v2"):
            c = counts.get(var, {})
            if not c.get("LDG.128") or not c.get("STG.128"):
                raise AssertionError(f"{var}: no 128-bit global loads or "
                                     f"stores in its SASS ({c})")
    for d in HEAD_DIMS:
        bf, f32 = (counts.get(f"flash_attention_{dt}_d{d}", {})
                   for dt in ("bf16", "f32"))
        if not bf.get("HGMMA") or not bf.get("UTMALDG"):
            raise AssertionError(f"flash_attention_bf16_d{d}: no HGMMA or "
                                 f"UTMALDG in its SASS ({bf})")
        if not f32.get("LDGSTS"):
            raise AssertionError(f"flash_attention_f32_d{d}: no LDGSTS in "
                                 f"its SASS ({f32})")


def wkv6_instantiations() -> list:
    """Every K8 instantiation the launcher builds, the dtype's thread tile at
    each K: 'wkv6_<dt>_k<K>_r<R>c<C>'."""
    from repro_torch.kernels import wkv6
    return [f"wkv6_{dt}_k{K}_r{wkv6.TILES[dtype][0]}c{wkv6.TILES[dtype][1]}"
            for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
            for K in wkv6.HEAD_DIMS]


def tridiag_instantiations() -> list:
    """Every K7 instantiation the launcher builds: 'tridiag_<dt>_<variant>'."""
    return [f"tridiag_{dt}_{v}" for dt in ("f32", "f64")
            for v in ("onchip", "global")]


def check_ptxas(ptxas: dict) -> None:
    """Every K8 and K7 instantiation is in the ptxas report and spills
    nothing."""
    for var in wkv6_instantiations() + tridiag_instantiations():
        info = ptxas.get(var)
        if not info or "registers" not in info:
            raise AssertionError(f"{var}: not in the ptxas report")
        if info.get("spill_stores", 0) or info.get("spill_loads", 0):
            raise AssertionError(f"{var} spills: {info}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def time_ms(fn, reps: int, warmup: int = 2, primed: bool = False) -> float:
    """Mean ms per call of ``fn``, by CUDA events around ``reps`` calls.
    ``primed``: a sleep kernel holds the device while the host enqueues the
    calls, so that no call finds the device idle, waiting for the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if primed:
        torch.cuda._sleep(PRIME_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn``, with ``reps`` calls captured in one CUDA
    graph and the graph replayed, primed, between CUDA events: no host work
    lies between two kernels."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    ms = time_ms(g.replay, reps=1, warmup=1, primed=True) / reps
    del g
    return ms


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def held(out, ref, dtype, what: str) -> tuple:
    """(max |out - ref|, max(|ref|, 1)), raising when the first exceeds
    TOL[dtype] times the second."""
    err = float((out - ref).abs().max())
    scale = max(float(ref.abs().max()), 1.0)
    if not err <= TOL[dtype] * scale:
        raise AssertionError(f"{what}: max_abs_err {err:.3e} > "
                             f"{TOL[dtype]:.0e} * {scale:.3e}")
    return err, scale


def h100():
    """The H100 SXM machine model (`repro_torch.roofline.analysis`): the
    HBM rate and the peaks by dtype behind every bound here and the dry
    run's roofline."""
    from repro_torch.roofline.analysis import H100_SXM
    return H100_SXM


def bound_of(moved: int, flops: int, dtype) -> tuple:
    """(the least ms the card could take, "bytes" or "operations")."""
    t_bytes = moved / h100().hbm_bytes_per_s * 1e3
    t_ops = flops / h100().peak(dtype) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_cases(nt: int, nl: int, seed: int):
    """One dict per case: name, label, kernel fn, plain fn, inputs builder
    (dtype -> the inputs on the card), cost (the inputs -> the bytes and
    operations of `repro_torch.roofline.kernels`); `exact` cases must equal
    their plain version bitwise; `library` is one PyTorch call computing
    the same function, timed as a yardstick, or None."""
    from repro_torch.kernels import cell_transpose, horizontal_flux, matrix_free
    from repro_torch.roofline import kernels as rk
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s, dtype=np.float32)
    F2, bc2 = r(2, nl, 6, nt), r(2, 3, nt)
    F1 = r(1, nl, 6, nt)
    area = (0.5 + rng.random(nt, dtype=np.float32)) * 1e5
    f4, fext4 = r(4, nl, 6, nt), r(4, nl, 3, 2, 2, nt)
    speed = r(nl, 2, 3, 2, nt)
    elen = (0.5 + rng.random((3, nt), dtype=np.float32)) * 300.0
    field = r(nl, 6, nt)
    nc = -(-nt // 128)
    cells = r(nc, nl * 6, 128)
    rag = RAGGED_NT

    def on(dtype, *arrs):
        return [torch.as_tensor(a).to(device="cuda", dtype=dtype) for a in arrs]

    def unaligned(dtype, a):
        """``a`` on the card, contiguous, with its data one element past a
        16-byte boundary: the view [1:] of a buffer one element longer."""
        buf = torch.empty(a.size + 1, dtype=dtype, device="cuda")
        t = buf[1:].view(a.shape)
        t.copy_(torch.as_tensor(a))
        return [t]

    def case(name, label, kern, plain, inputs, cost, exact=False,
             library=None, variant=None):
        return dict(name=name, label=label, kern=kern, plain=plain,
                    inputs=inputs, cost=cost, exact=exact, library=library,
                    variant=variant)

    to_cells = lambda x: x.view(nl * 6, nc, 128).transpose(0, 1).contiguous()
    to_soa = lambda c: c.transpose(0, 1).contiguous()
    k5 = lambda ins: rk.soa_to_cell(*ins)
    k6 = lambda n: lambda ins: rk.cell_to_soa(*ins, n)

    return [
        case("solve_r", "K=2", matrix_free.solve_r, matrix_free.solve_r_plain,
             lambda d: on(d, F2, area, bc2), lambda ins: rk.solve_r(*ins)),
        case("solve_w", "K=1", lambda F, a: matrix_free.solve_w(F, a),
             lambda F, a: matrix_free.solve_w_plain(F, a),
             lambda d: on(d, F1, area), lambda ins: rk.solve_w(*ins)),
        case("lateral_flux", "k=2", horizontal_flux.lateral_flux,
             horizontal_flux.lateral_flux_plain,
             lambda d: on(d, f4[:2], fext4[:2], speed, elen),
             lambda ins: rk.lateral_flux(*ins)),
        case("lateral_flux", "k=4", horizontal_flux.lateral_flux,
             horizontal_flux.lateral_flux_plain,
             lambda d: on(d, f4, fext4, speed, elen),
             lambda ins: rk.lateral_flux(*ins)),
        case("soa_to_cell", f"nt={nt}", cell_transpose.soa_to_cell,
             cell_transpose.soa_to_cell_plain, lambda d: on(d, field), k5,
             exact=True, library=to_cells, variant="vector"),
        case("soa_to_cell", f"nt={rag}", cell_transpose.soa_to_cell,
             cell_transpose.soa_to_cell_plain,
             lambda d: on(d, field[..., :rag]), k5, exact=True,
             variant="scalar"),
        case("soa_to_cell", f"nt={nt} unaligned", cell_transpose.soa_to_cell,
             cell_transpose.soa_to_cell_plain,
             lambda d: unaligned(d, field), k5, exact=True, library=to_cells,
             variant="scalar"),
        case("cell_to_soa", f"nt={nt}",
             lambda c: cell_transpose.cell_to_soa(c, nt),
             lambda c: cell_transpose.cell_to_soa_plain(c, nt),
             lambda d: on(d, cells), k6(nt), exact=True, library=to_soa,
             variant="vector"),
        case("cell_to_soa", f"nt={rag}",
             lambda c: cell_transpose.cell_to_soa(c, rag),
             lambda c: cell_transpose.cell_to_soa_plain(c, rag),
             lambda d: on(d, cells[:-(-rag // 128)]), k6(rag), exact=True,
             variant="scalar"),
        case("cell_to_soa", f"nt={nt} unaligned",
             lambda c: cell_transpose.cell_to_soa(c, nt),
             lambda c: cell_transpose.cell_to_soa_plain(c, nt),
             lambda d: unaligned(d, cells), k6(nt), exact=True, library=to_soa,
             variant="scalar"),
    ]


def device_ms(fn, reps: int) -> tuple:
    """(device ms per kernel, kernels per call) from torch.profiler over
    ``reps`` calls of ``fn`` (each launches one kernel; a trace that drops
    an event shows fewer); (None, 0) if the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    us = sum(e.time_range.elapsed_us() for e in kernels)
    if not us:
        return None, 0
    return us / 1e3 / len(kernels), len(kernels) / reps


def copy_plan(name: str, ins, out) -> dict:
    """The launch plan K5 / K6 took for ``ins`` -> ``out``."""
    from repro_torch.kernels import cell_transpose
    soa = ins[0] if name == "soa_to_cell" else out
    return cell_transpose.launch_plan(soa.shape[0] * 6, soa.shape[2],
                                      soa.dtype, ins[0].data_ptr(),
                                      out.data_ptr())


def host_us(fn, reps: int = 20) -> float:
    """Host time per call of ``fn`` in µs, enqueued back to back without a
    synchronise (the launch queue does not fill at this depth): when it
    exceeds the kernel's device time, event times measure the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def phase_kernels(nt: int, nl: int, seed: int) -> dict:
    """Phase 3: every case of ``kernel_cases`` in float32 and float64."""
    results = {}
    for c in kernel_cases(nt, nl, seed):
        name, label, kern, plain = c["name"], c["label"], c["kern"], c["plain"]
        for dtype in (torch.float32, torch.float64):
            ins = c["inputs"](dtype)
            out = kern(*ins)
            torch.cuda.synchronize()
            ref = plain(*ins)
            torch.cuda.synchronize()
            if c["exact"]:
                err = float((out - ref).abs().max())
                if out.shape != ref.shape or not torch.equal(out, ref):
                    raise AssertionError(f"{name} {label} {dtype}: not bitwise "
                                         f"equal to its plain version "
                                         f"(max_abs_err {err:.3e})")
                tol_txt = "bitwise"
            else:
                err, scale = held(out, ref, dtype, f"{name} {label} {dtype}")
                tol_txt = f"tol {TOL[dtype]:.0e} x {scale:.3e}"
            plan = extra = None
            if c["variant"] is not None:
                plan = copy_plan(name, ins, out)
                if plan["variant"] != c["variant"]:
                    raise AssertionError(f"{name} {label} {dtype}: took the "
                                         f"{plan['variant']} variant, not "
                                         f"{c['variant']}")
            ms = time_ms(lambda: kern(*ins), reps=20)
            plain_ms = time_ms(lambda: plain(*ins), reps=3, warmup=1)
            library_ms = None
            if c["library"] is not None:
                lib_out = c["library"](*ins)
                if not torch.equal(lib_out.reshape(out.shape), out):
                    raise AssertionError(f"{name} {label} {dtype}: the library "
                                         "call computes another function")
                del lib_out
                library_ms = time_ms(lambda: c["library"](*ins), reps=20)
            if plan is not None:
                prof_ms, per_call = device_ms(lambda: kern(*ins), reps=20)
                lib_prof_ms = lib_per_call = lib_primed = lib_graph = None
                if c["library"] is not None:
                    lib_prof_ms, lib_per_call = device_ms(
                        lambda: c["library"](*ins), reps=20)
                    lib_primed = time_ms(lambda: c["library"](*ins), reps=20,
                                         primed=True)
                    lib_graph = graph_ms(lambda: c["library"](*ins), reps=20)
                extra = dict(variant=plan["variant"], vec=plan["vec"],
                             per_thread=plan["per_thread"], grid=plan["grid"],
                             prof_ms=prof_ms, library_prof_ms=lib_prof_ms,
                             primed_ms=time_ms(lambda: kern(*ins), reps=20,
                                               primed=True),
                             graph_ms=graph_ms(lambda: kern(*ins), reps=20),
                             library_primed_ms=lib_primed,
                             library_graph_ms=lib_graph,
                             host_us=host_us(lambda: kern(*ins)))
            moved, flops = c["cost"](ins)
            bound, by = bound_of(moved, flops, dtype)
            dt = "f32" if dtype == torch.float32 else "f64"
            lib_txt = "" if library_ms is None else f" library_ms={library_ms:.4f}"
            if extra is not None:
                fmt = lambda t: "not measured" if t is None else f"{t:.4f}"
                share = lambda t: "" if t is None else f", {bound / t:.3f} of bound"
                lib_txt += (f" variant={extra['variant']} (vec {extra['vec']}, "
                            f"{extra['per_thread']} per thread, grid "
                            f"{extra['grid']}) profiler device ms per kernel: "
                            f"kernel {fmt(extra['prof_ms'])} ({per_call:g} "
                            f"kernels a call{share(extra['prof_ms'])}; host "
                            f"{extra['host_us']:.1f} us a call)")
                if c["library"] is not None:
                    lib_txt += (f", library {fmt(extra['library_prof_ms'])} "
                                f"({lib_per_call:g} kernels a call"
                                f"{share(extra['library_prof_ms'])})")
                lib_txt += (f"; events primed ms: kernel "
                            f"{extra['primed_ms']:.4f}, library "
                            f"{fmt(extra['library_primed_ms'])}; CUDA graph "
                            f"ms: kernel {extra['graph_ms']:.4f}, library "
                            f"{fmt(extra['library_graph_ms'])}")
            log(f"kernel {name} {label} {dt}: shape={tuple(ins[0].shape)} "
                f"max_abs_err={err:.3e} ({tol_txt}) "
                f"ms={ms:.4f} plain_ms={plain_ms:.3f}{lib_txt} bytes={moved} "
                f"flops={flops} bound_ms={bound:.4f} ({by}) "
                f"share_of_bound={bound / ms:.3f}")
            results[(name, label, dt)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=by, bytes=moved, flops=flops, shape=list(ins[0].shape),
                **(extra or {}))
            del ins, out, ref
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 3, K3: the plan's variant and the global variant
# ---------------------------------------------------------------------------
K3_K = 2                    # right-hand sides of the step's two solves


def thomas_inputs(nl: int, k: int, nt: int, seed: int, dtype) -> list:
    """lo, dg, up (nl, 6, 6, nt) and rhs (k, nl, 6, nt) on the card in
    ``dtype``, drawn in float32 from ``seed`` (the same draws in either
    dtype): diagonally dominant blocks shaped like the step's, lo[0] =
    up[-1] = 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    lo, dg, up = (r(nl, 6, 6, nt).mul_(0.1) for _ in range(3))
    lo[0] = 0.0
    up[-1] = 0.0
    dg += 2.0 * torch.eye(6, dtype=dtype, device="cuda")[None, :, :, None]
    return [lo, dg, up, r(k, nl, 6, nt)]


def thomas_scratch_bytes(plan, nl: int, k: int, itemsize: int) -> int:
    """Bytes the global variant moves through its scratch beyond the
    compulsory ones if L2 keeps none of it: forward, [C_l | y_l] written and
    read back by the next layer; backward, C_l and y_l read, x_l written
    over y_l and read back by the layer below; per column of its grid."""
    w = 6 * (6 + k)
    values = nl * w + (nl - 1) * w + (nl - 1) * (36 + 18 * k)
    return values * plan["grid"] * plan["tc"] * itemsize


def phase_block_thomas(nt: int, nl: int, seed: int, ptxas: dict) -> dict:
    """Phase 3, K3, in float32 and float64: at the main path's shape through
    the plan (onchip), then through each narrower onchip tile and the
    global variant that a lower smem_limit makes the plan take, each held
    against the plain version and then timed in two rounds, the second in
    reverse order; then the shallowest depth the plan sends to the global
    variant, at the same nt, held and timed."""
    from repro_torch.kernels import column_solve as cs
    from repro_torch.roofline import kernels as rk
    results = {}
    for dtype in (torch.float32, torch.float64):
        dt = "f32" if dtype == torch.float32 else "f64"
        ins = thomas_inputs(nl, K3_K, nt, seed, dtype)
        # each limit just below the last plan's shared bytes: every
        # narrower onchip tile the plan takes, then the global variant
        runs, limit = {}, cs.MAX_SMEM
        while True:
            p = cs.launch_plan(nl, K3_K, nt, dtype, limit)
            runs[f"{p['variant']} tc={p['tc']}"] = (p, lambda limit=limit: (
                cs.block_thomas(*ins, smem_limit=limit)))
            if p["variant"] == "global":
                break
            limit = p["smem"] - 1
        plan, forced = next(iter(runs.values()))[0], p
        main, glob = list(runs)[0], list(runs)[-1]
        if plan["variant"] != "onchip" or len(runs) < 2:
            raise AssertionError(f"block_thomas {dt}: plans {list(runs)}")
        ref = cs.block_thomas_plain(*ins)
        torch.cuda.synchronize()
        errs = {}
        for label, (p, fn) in runs.items():
            out = fn()
            torch.cuda.synchronize()
            errs[label], _ = held(out, ref, dtype, f"block_thomas {label} {dt}")
            del out
        times = {label: [] for label in runs}
        for order in (list(runs), list(runs)[::-1]):
            for label in order:
                times[label].append(time_ms(runs[label][1], reps=20))
        plain_ms = time_ms(lambda: cs.block_thomas_plain(*ins), reps=3, warmup=1)
        moved, flops = rk.block_thomas(*ins)
        bound, by = bound_of(moved, flops, dtype)
        tiles = {}
        for label, (p, _) in runs.items():
            ms = float(np.mean(times[label]))
            regs = ptxas.get(f"block_thomas_{dt}_k{K3_K}_tc{p['tc']}_{p['variant']}")
            scratch = (thomas_scratch_bytes(p, nl, K3_K, dtype.itemsize)
                       if p["variant"] == "global" else 0)
            per_sm = cs.tiles_per_sm(p, K3_K, dtype)
            tiles[label] = dict(ms=ms, ms_rounds=times[label], share=bound / ms,
                                smem=p["smem"], grid=p["grid"], ptxas=regs,
                                tiles_per_sm=per_sm,
                                warps_per_sm=per_sm * p["threads"] / 32,
                                max_abs_err=errs[label], scratch_bytes=scratch)
            extra = (f" scratch bytes moved {scratch} (if none stays in L2; "
                     f"{moved + scratch} in all, bound at that traffic "
                     f"{(moved + scratch) / h100().hbm_bytes_per_s * 1e3:.4f} ms)"
                     if scratch else "")
            log(f"kernel block_thomas k={K3_K} {dt} {label}: shape="
                f"{tuple(ins[0].shape)} smem={p['smem']} grid={p['grid']} "
                f"threads={p['threads']} tiles/SM={per_sm} ptxas={regs} "
                f"max_abs_err={errs[label]:.3e} (tol {TOL[dtype]:.0e}) ms={ms:.4f} "
                f"(rounds {', '.join(f'{t:.4f}' for t in times[label])}) "
                f"bytes={moved} flops={flops} bound_ms={bound:.4f} ({by}) "
                f"share_of_bound={bound / ms:.3f}{extra}")
        log(f"kernel block_thomas k={K3_K} {dt}: plan {main} "
            f"{tiles[main]['ms']:.4f} ms against global "
            f"{tiles[glob]['ms']:.4f} ms "
            f"({tiles[glob]['ms'] / tiles[main]['ms']:.3f}x); plain_ms={plain_ms:.3f}")
        del ins, ref
        torch.cuda.empty_cache()

        deep_nl = nl
        while cs.launch_plan(deep_nl, K3_K, nt, dtype)["variant"] == "onchip":
            deep_nl += 1
        deep_plan = cs.launch_plan(deep_nl, K3_K, nt, dtype)
        dins = thomas_inputs(deep_nl, K3_K, nt, seed + 1, dtype)
        out = cs.block_thomas(*dins)
        torch.cuda.synchronize()
        dref = cs.block_thomas_plain(*dins)
        torch.cuda.synchronize()
        derr, _ = held(out, dref, dtype, f"block_thomas nl={deep_nl} {dt}")
        del dref
        dms = time_ms(lambda: cs.block_thomas(*dins), reps=20)
        dplain = time_ms(lambda: cs.block_thomas_plain(*dins), reps=1, warmup=1)
        dmoved, dflops = rk.block_thomas(*dins)
        dbound, dby = bound_of(dmoved, dflops, dtype)
        dscratch = thomas_scratch_bytes(deep_plan, deep_nl, K3_K, dtype.itemsize)
        deep = dict(nl=deep_nl, nt=nt, variant=deep_plan["variant"],
                    tc=deep_plan["tc"], smem=deep_plan["smem"], ms=dms,
                    plain_ms=dplain, bound_ms=dbound, bound_by=dby,
                    share=dbound / dms, max_abs_err=derr, bytes=dmoved,
                    scratch_bytes=dscratch)
        log(f"kernel block_thomas deep k={K3_K} {dt}: nl={deep_nl} "
            f"nt={nt} {deep_plan['variant']} tc={deep_plan['tc']} "
            f"smem={deep_plan['smem']} max_abs_err={derr:.3e} ms={dms:.4f} "
            f"plain_ms={dplain:.3f} bytes={dmoved} bound_ms={dbound:.4f} "
            f"({dby}) share_of_bound={dbound / dms:.3f} scratch bytes moved "
            f"{dscratch} (if none stays in L2)")
        del dins, out
        torch.cuda.empty_cache()

        results[("block_thomas", f"k={K3_K}", dt)] = dict(
            max_abs_err=errs[main], ms=tiles[main]["ms"], plain_ms=plain_ms,
            library_ms=None, bound_ms=bound, bound_by=by, bytes=moved,
            flops=flops, shape=[nl, 6, 6, nt], variant="onchip",
            tc=plan["tc"], smem=plan["smem"], ptxas=tiles[main]["ptxas"],
            tiles_per_sm=tiles[main]["tiles_per_sm"],
            ms_global=tiles[glob]["ms"], tiles=tiles, deep=deep)
    return results


# ---------------------------------------------------------------------------
# phase 3, K7: every variant, the ragged nt and the deep columns, bitwise
# ---------------------------------------------------------------------------
# depths of the sweep (--k7-depths) around the plan's switch to global and
# the shared-memory limit (kernels/tridiag.py: MIN_BLOCKS, MAX_SMEM)
K7_DEPTHS = {torch.float32: (16, 24, 32, 40, 48, 56, 57, 64, 72, 80, 96, 113,
                             128, 160, 200, 227),
             torch.float64: (16, 20, 24, 28, 32, 36, 37, 38, 40, 48, 56, 64,
                             80, 96, 113)}


def tridiag_inputs(nl: int, nt: int, dtype, seed: int) -> list:
    """dl, d, du, b (nl, nt) on the card: diagonally dominant systems shaped
    like GLS's implicit diffusion, lo, up <= 0, d = 1 - lo - up."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo, up = (-5.0 * torch.rand((nl, nt), generator=g, device="cuda")
              for _ in range(2))
    lo[0] = 0.0
    up[-1] = 0.0
    b = torch.randn((nl, nt), generator=g, device="cuda")
    return [t.to(dtype) for t in (lo, 1.0 - lo - up, up, b)]


def tridiag_round(fn) -> tuple:
    """One timed round of a K7 call ``fn``: (ms by CUDA events around 20
    calls, as every other kernel row is timed, ms by events with the calls
    queued behind a sleep kernel).  Where the wrapper's host time a call
    exceeds the kernel's, the first measures the host."""
    return time_ms(fn, reps=20), time_ms(fn, reps=20, primed=True)


def tridiag_timed(rows: dict, fns: dict) -> None:
    """Time each K7 call of ``fns`` ({label: fn}) in two rounds, the second
    in reverse order, then by the profiler's device time and its host time,
    into ``rows[label]``: ms and primed_ms (the rounds' means, rounds in
    ms_rounds / primed_rounds), prof_ms, host_us."""
    for label in fns:
        rows[label].update(ms_rounds=[], primed_rounds=[])
    for order in (list(fns), list(fns)[::-1]):
        for label in order:
            ms, primed = tridiag_round(fns[label])
            rows[label]["ms_rounds"].append(ms)
            rows[label]["primed_rounds"].append(primed)
    for label, fn in fns.items():
        r = rows[label]
        r["ms"] = float(np.mean(r["ms_rounds"]))
        r["primed_ms"] = float(np.mean(r["primed_rounds"]))
        r["prof_ms"], r["prof_per_call"] = device_ms(fn, reps=20)
        r["host_us"] = host_us(fn)


def tridiag_times_txt(r: dict) -> str:
    """The three times of a K7 row, each with its share of the bound."""
    fmt = lambda t: "not measured" if t is None else (
        f"{t:.4f} ({r['bound_ms'] / t:.3f} of bound)")
    return (f"events ms={fmt(r['ms'])} (rounds "
            f"{', '.join(f'{t:.4f}' for t in r['ms_rounds'])}); primed events "
            f"{fmt(r['primed_ms'])} (rounds "
            f"{', '.join(f'{t:.4f}' for t in r['primed_rounds'])}); profiler "
            f"device {fmt(r['prof_ms'])} ({r['prof_per_call']:g} kernels a "
            f"call); host {r['host_us']:.1f} us a call")


def tridiag_cases(nt: int, nl: int, seed: int, dtype) -> dict:
    """{label: (inputs, plan)}: at (nl, nt) both plans the launcher takes
    (the plan's own, onchip, first), at the ragged nt the plan, at the first
    depth the plan gives to global both, and at the first depth past shared
    memory the one plan (global)."""
    from repro_torch.kernels import tridiag as tri
    first = next(n for n in range(nl, 10_000)
                 if tri.launch_plan(n, nt, dtype)["variant"] == "global")
    past = next(n for n in range(first, 10_000)
                if len(tri.alternatives(n, nt, dtype)) == 1)
    ins = tridiag_inputs(nl, nt, dtype, seed)
    deep = tridiag_inputs(first, nt, dtype, seed + 1)
    cases = {f"nt={nt} {p['variant']}": (ins, p)
             for p in tri.alternatives(nl, nt, dtype)}
    cases[f"nt={RAGGED_NT} onchip"] = (
        [a[:, :RAGGED_NT].contiguous() for a in ins],
        tri.launch_plan(nl, RAGGED_NT, dtype))
    cases.update({f"nl={first} {p['variant']}": (deep, p)
                  for p in tri.alternatives(first, nt, dtype)})
    cases[f"nl={past} global"] = (tridiag_inputs(past, nt, dtype, seed + 2),
                                  tri.launch_plan(past, nt, dtype))
    for label, (_, p) in cases.items():
        if not label.endswith(p["variant"]):
            raise AssertionError(f"tridiag {label}: the plan is {dict(p)}")
    return cases


def tridiag_bound(ins) -> tuple:
    """(bytes, flops, bound ms, bound_by) of a K7 solve of ``ins``
    (`repro_torch.roofline.kernels.tridiag`)."""
    from repro_torch.roofline import kernels as rk
    moved, flops = rk.tridiag(*ins)
    return (moved, flops, *bound_of(moved, flops, ins[0].dtype))


def tridiag_targets(r: dict, dt: str) -> str:
    """ISSUE's two targets for K7 at (16, 160000) by each time of ``r``:
    faster than the kernel before the redesign (K7_BEFORE_MS, events), and
    at least 0.70 of the bound."""
    out = []
    for key in ("ms", "primed_ms", "prof_ms"):
        t = r[key]
        if t is None:
            out.append(f"{key} not measured")
            continue
        out.append(f"{key} {t:.4f}: faster than {K7_BEFORE_MS[dt]:.4f} "
                   f"{'yes' if t < K7_BEFORE_MS[dt] else 'NO'}, 0.70 of bound "
                   f"{'yes' if r['bound_ms'] / t >= 0.70 else 'NO'}")
    return "; ".join(out)


def phase_tridiag(nt: int, nl: int, seed: int, ptxas: dict, sass: dict) -> dict:
    """Phase 3, K7, in float32 and float64: each case of `tridiag_cases`
    must equal the plain version bitwise; then every case is timed
    (`tridiag_timed`): by CUDA events as the other kernels are (``ms``,
    which the kernel table reports), by events primed with a sleep kernel,
    so that the host's time a call does not show in a ~20 µs kernel, and by
    the profiler's device time."""
    from repro_torch.kernels import tridiag as tri
    results = {}
    for dtype in (torch.float32, torch.float64):
        dt = "f32" if dtype == torch.float32 else "f64"
        cases = tridiag_cases(nt, nl, seed, dtype)
        rows = {}
        for label, (ins, p) in cases.items():
            out = tri.tridiag(*ins, plan=p)
            torch.cuda.synchronize()
            ref = tri.tridiag_plain(*ins)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not torch.equal(out, ref):
                raise AssertionError(f"tridiag {label} {dt}: not bitwise equal "
                                     f"to its plain version (max_abs_err {err:.3e})")
            var = f"tridiag_{dt}_{p['variant']}"
            moved, flops, bound, by = tridiag_bound(ins)
            rows[label] = dict(
                plan=dict(p), instantiation=var, ptxas=ptxas.get(var, {}),
                sass=sass.get(var, {}), max_abs_err=err, shape=list(ins[0].shape),
                bytes=moved, flops=flops, bound_ms=bound, bound_by=by,
                plain_ms=time_ms(lambda: tri.tridiag_plain(*ins), reps=3, warmup=1))
            del out, ref
        tridiag_timed(rows, {
            label: (lambda ins=ins, p=p: tri.tridiag(*ins, plan=p))
            for label, (ins, p) in cases.items()})
        for label, r in rows.items():
            before = (f" before_ms={K7_BEFORE_MS[dt]:.4f} (global cp scratch, "
                      f"events)" if label.startswith(f"nt={nt} ") else "")
            log(f"kernel tridiag {dt} {label}: shape={tuple(r['shape'])} plan "
                f"{r['plan']} bitwise (max_abs_err {r['max_abs_err']:.1e}) "
                f"{tridiag_times_txt(r)}; plain_ms={r['plain_ms']:.3f} "
                f"bytes={r['bytes']} flops={r['flops']} bound_ms="
                f"{r['bound_ms']:.4f} ({r['bound_by']}){before}; ptxas "
                f"{r['instantiation']} {r['ptxas']}; sass {r['sass']}")
        del cases
        torch.cuda.empty_cache()
        main = rows[f"nt={nt} onchip"]
        log(f"K7 targets {dt} at {tuple(main['shape'])}: "
            f"{tridiag_targets(main, dt)}")
        results[("tridiag", f"nt={nt}", dt)] = dict(
            {k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "bytes", "flops", "shape", "ptxas",
                                  "sass", "prof_ms", "primed_ms", "host_us",
                                  "plan")},
            library_ms=None, cases=rows)
    return results


def k7_only(nt: int, nl: int, seed: int) -> dict:
    """--k7-only: K7 at (nl, nt) through the default call of the package on
    sys.path, `tridiag(dl, d, du, b)`, in float32 and float64, held to TOL
    against its plain version and timed as phase 3 times it; the package
    may be an earlier checkout's (--src), to time two kernels alike."""
    from repro_torch.kernels import tridiag as tri
    rows = {}
    for dtype in (torch.float32, torch.float64):
        dt = "f32" if dtype == torch.float32 else "f64"
        ins = tridiag_inputs(nl, nt, dtype, seed)
        err, _ = held(tri.tridiag(*ins), tri.tridiag_plain(*ins), dtype,
                      f"tridiag {dt}")
        moved, flops, bound, by = tridiag_bound(ins)
        rows[dt] = dict(shape=[nl, nt], max_abs_err=err, bytes=moved,
                        bound_ms=bound, bound_by=by)
        tridiag_timed(rows, {dt: lambda ins=ins: tri.tridiag(*ins)})
        log(f"k7-only {tri.__file__} {dt} ({nl}, {nt}): max_abs_err {err:.1e} "
            f"{tridiag_times_txt(rows[dt])}; bound_ms {bound:.4f} ({by}); "
            f"{tridiag_targets(rows[dt], dt)}")
        del ins
        torch.cuda.empty_cache()
    return rows


def k7_depths(nt: int, seed: int) -> dict:
    """--k7-depths: both variants the launcher takes at each depth of
    K7_DEPTHS over nt columns, held bitwise and timed as phase 3 times K7,
    with the onchip variant's shared bytes and blocks a SM: where the plan's
    switch to global (kernels/tridiag.py: MIN_BLOCKS) comes from."""
    from repro_torch.kernels import tridiag as tri
    rows = {}
    for dtype, depths in K7_DEPTHS.items():
        dt = "f32" if dtype == torch.float32 else "f64"
        for nl in depths:
            ins = tridiag_inputs(nl, nt, dtype, seed + nl)
            ref = tri.tridiag_plain(*ins)
            moved, flops, bound, by = tridiag_bound(ins)
            fns = {}
            for p in tri.alternatives(nl, nt, dtype):
                if not torch.equal(tri.tridiag(*ins, plan=p), ref):
                    raise AssertionError(f"tridiag ({nl}, {nt}) {dt} "
                                         f"{p['variant']}: not bitwise equal "
                                         "to its plain version")
                label = f"{dt} nl={nl} {p['variant']}"
                rows[label] = dict(plan=dict(p), bound_ms=bound, bound_by=by,
                                   onchip_blocks_per_sm=tri.blocks_per_sm(
                                       dict(smem=2 * nl * tri.THREADS * dtype.itemsize)))
                fns[label] = lambda ins=ins, p=p: tri.tridiag(*ins, plan=p)
            tridiag_timed(rows, fns)
            for label in fns:
                r = rows[label]
                log(f"k7-depths {label} (plan "
                    f"{tri.launch_plan(nl, nt, dtype)['variant']}; onchip "
                    f"{r['onchip_blocks_per_sm']} blocks a SM): "
                    f"{tridiag_times_txt(r)}")
            del ins, ref, fns
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def run_steps(geom, vg, cfg, st, steps, forcing_at=None):
    """`steps` steps, each timed on the host clock between synchronizations;
    forcing_at(time), if given, supplies each step's forcing."""
    from repro_torch.core import stepper
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forcing = () if forcing_at is None else (forcing_at(st.time),)
        st = stepper.step(geom, vg, cfg, st, *forcing)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return st, times


FIELDS = {"ux": lambda s: s.ux, "uy": lambda s: s.uy, "T": lambda s: s.T,
          "S": lambda s: s.S, "eta": lambda s: s.ext.eta,
          "qx": lambda s: s.ext.qx, "qy": lambda s: s.ext.qy,
          "turb_k": lambda s: s.turb_k, "turb_eps": lambda s: s.turb_eps,
          "nu_t": lambda s: s.nu_t, "kappa_t": lambda s: s.kappa_t}


def compare_states(st_cuda, st_plain, dtype) -> dict:
    """cuda-vs-plain difference of every prognostic field, relative to the
    scale its tolerance uses (see TOL_PATH); raises on a non-finite value
    or a held field above its tolerance."""
    diffs = {}
    for name, get in FIELDS.items():
        a, b = get(st_cuda), get(st_plain)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite values on the cuda path")
        amax = float(a.abs().max())
        if dtype == torch.float64:
            scale = amax if amax > 0.0 else 1.0
        else:
            scale = max(amax, 1.0)
        rel = float((a - b).abs().max()) / scale
        diffs[name] = rel
        held = dtype == torch.float64 or name in HELD_F32
        if held and not rel <= TOL_PATH[dtype]:
            raise AssertionError(f"{name} ({dtype}): cuda vs plain {rel:.3e} "
                                 f"> {TOL_PATH[dtype]}")
    return diffs


def check_dispatches(launches: dict) -> None:
    """Every cuda dispatch the metrics registry counted launched exactly one
    kernel: the registry's kernel_dispatch counts, summed by the kernel each
    op runs, equal the wrappers' cuda launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics
    got = {}
    for key, v in metrics.default().snapshot()["counter"].items():
        m = re.fullmatch(r"kernel_dispatch\{backend=(\w+),op=(\w+)\}", key)
        if m and m.group(1) == "cuda":
            k = (ops.KERNEL[m.group(2)], "cuda")
            got[k] = got.get(k, 0) + int(v)
    cuda = {k: n for k, n in launches.items() if k[1] == "cuda"}
    if got != cuda:
        raise AssertionError(f"kernel_dispatch {got} != cuda launches {cuda}")


def phase_boundary(geom, vg, cfg, st, dtype) -> dict:
    """The step boundary of a stepped state on the cuda backend:
    state_to_cell -> state_from_cell must give the state back bitwise (and
    the cells must equal the plain layout transform), and the state's GLS k
    and eps diffusion systems go through ops.tridiag (K7), which must equal
    turbulence.thomas_solve bitwise."""
    from repro_torch.core import layout, stepper, turbulence
    from repro_torch.core.extrusion import layer_geometry
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics

    metrics.reset()
    ops.reset_launches()
    cells = stepper.state_to_cell(st, backend="cuda")
    back = stepper.state_from_cell(st, cells, geom.nt, backend="cuda")
    vge = layer_geometry(vg, st.ext.eta, cfg.h_min)
    dz = torch.clamp(vge.H.mean(dim=0, keepdim=True), min=cfg.h_min) / cfg.nl
    p = turbulence.GLSParams()
    solved = []
    for f, sigma in ((st.turb_k, p.sigma_k), (st.turb_eps, p.sigma_e)):
        lo, d, up = turbulence.diffusion_system(st.nu_t, dz, cfg.dt, sigma)
        solved.append((ops.tridiag(lo, d, up, f, backend="cuda"),
                       turbulence.thomas_solve(lo, d, up, f)))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    expect = {(k, "cuda"): n for k, n in BOUNDARY.items()}
    if launches != expect:
        raise AssertionError(f"step boundary launches {launches} != {expect}")
    check_dispatches(launches)
    for name in ("ux", "uy", "T", "S"):
        x = getattr(st, name)
        if not torch.equal(getattr(back, name), x):
            raise AssertionError(f"{name}: cell round trip is not bitwise")
        if not torch.equal(cells[name], layout.soa_to_cell(x)):
            raise AssertionError(f"{name}: cells differ from layout.soa_to_cell")
    for x, ref in solved:
        if not torch.equal(x, ref):
            raise AssertionError(f"tridiag on the GLS system: not bitwise equal "
                                 f"to thomas_solve (max_abs_err "
                                 f"{float((x - ref).abs().max()):.3e})")
    log(f"step boundary {dtype}: cell round trip bitwise, cells "
        f"{tuple(cells['T'].shape)}; GLS k/eps systems through ops.tridiag "
        f"bitwise; launches {sorted(launches.items())}")
    return dict(launches=launches)


def phase_main_path(dtype) -> dict:
    """STEPS steps of the quickstart case through the cuda backend (counted),
    then through the plain backend from the same state, which must agree;
    then TIMED_STEPS more cuda steps for the steady step time."""
    import dataclasses
    from repro_torch import quickstart
    from repro_torch.kernels import dispatch, ops
    from repro_torch.obs import metrics

    t0 = time.perf_counter()
    geom, vg, cfg, st0 = quickstart.setup(nx=NX, nl=NL, dtype=dtype,
                                          device="cuda")
    torch.cuda.synchronize()
    log(f"main path: {geom.nt} triangles x {NL} layers "
        f"({geom.nt * NL} prisms), {dtype}, dt={cfg.dt}s, m_2d={cfg.m_2d}; "
        f"setup {time.perf_counter() - t0:.1f}s")
    if dispatch.resolve(cfg.backend, geom.area.device) is not dispatch.Backend.CUDA:
        raise AssertionError("backend auto did not resolve to cuda")
    heat0 = quickstart.heat_content(geom, vg, st0, cfg)
    torch.cuda.reset_peak_memory_stats()

    metrics.reset()
    ops.reset_launches()
    st_cuda, times = run_steps(geom, vg, cfg, st0, STEPS)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expect = {(op, "cuda"): STEPS * n for op, n in PER_STEP.items()}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    check_dispatches(launches)
    log(f"main path cuda: launches {sorted(launches.items())}")
    boundary = phase_boundary(geom, vg, cfg, st_cuda, dtype)

    cfg_plain = dataclasses.replace(cfg, backend="plain")
    ops.reset_launches()
    st_plain, times_plain = run_steps(geom, vg, cfg_plain, st0, STEPS)
    expect = {(op, "plain"): STEPS * n for op, n in PER_STEP.items()}
    if dict(ops.LAUNCHES) != expect:
        raise AssertionError(f"plain launch counts {dict(ops.LAUNCHES)} != {expect}")
    diffs = compare_states(st_cuda, st_plain, dtype)
    heat = quickstart.heat_content(geom, vg, st_cuda, cfg)
    drift = abs(heat - heat0) / abs(heat0)
    if not drift <= 1e-5:
        raise AssertionError(f"heat drift {drift:.3e} > 1e-5")
    if not float(st_cuda.ux.abs().max()) > 0.0:
        raise AssertionError("no flow developed")
    st_end, steady = run_steps(geom, vg, cfg, st_cuda, TIMED_STEPS)
    if not bool(torch.isfinite(st_end.ux).all()):
        raise AssertionError(f"non-finite ux after {STEPS + TIMED_STEPS} steps")
    ms = float(np.mean(steady)) * 1e3
    res = dict(ms_per_step=ms, ms_min=min(steady) * 1e3,
               ms_max=max(steady) * 1e3, first_step_ms=times[0] * 1e3,
               physical_over_wall=cfg.dt / (ms / 1e3), peak_bytes=peak,
               rel_diff_vs_plain=diffs, heat_drift=drift,
               launches={**boundary["launches"], **launches})
    log(f"main path cuda {dtype}: counted steps "
        f"{[round(t * 1e3, 2) for t in times]} ms; {TIMED_STEPS} steady steps "
        f"{[round(t * 1e3, 2) for t in steady]} ms: mean {ms:.2f} "
        f"(min {res['ms_min']:.2f}, max {res['ms_max']:.2f}) ms/step; "
        f"physical/wall {res['physical_over_wall']:.1f}; peak memory "
        f"{peak / 2**30:.3f} GiB ({peak} bytes)")
    log(f"main path plain {dtype}: step times "
        f"{[round(t * 1e3, 2) for t in times_plain]} ms; cuda vs plain "
        f"{ {k: float(f'{v:.3e}') for k, v in diffs.items()} }; heat drift "
        f"{drift:.3e}; max|u| {float(st_cuda.ux.abs().max()):.4e}")
    del geom, vg, st0, st_cuda, st_plain, st_end
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 5: the observed step
# ---------------------------------------------------------------------------
def phase_observed() -> dict:
    """STEPS steps of the main-path case in float64 with the flight recorder
    on, held by a halting monitor; then the obs smoke as a subprocess."""
    from repro_torch import obs_smoke, quickstart
    from repro_torch.obs import diagnostics, metrics

    out_dir = ROOT / "chiprun_out" / "chip_smoke_obs"
    jsonl = out_dir / "metrics.jsonl"
    jsonl.unlink(missing_ok=True)
    geom, vg, cfg, st = quickstart.setup(nx=NX, nl=NL, dtype=torch.float64,
                                         device="cuda")
    metrics.reset()
    reg = metrics.configure(str(jsonl))
    policy = diagnostics.MonitorPolicy(
        cfl_max=None, volume_drift_max=OBS_DRIFT_MAX,
        mass_drift_max=OBS_DRIFT_MAX, on_violation="halt")
    d0 = diagnostics.to_dict(diagnostics.compute(geom, vg, cfg, st))
    policy.check(d0, step=0, registry=reg)
    per_step = []
    for k in range(1, STEPS + 1):
        with reg.timer("stage_time_us", stage="step"):
            st, diag = diagnostics.step_with_diagnostics(geom, vg, cfg, st)
            torch.cuda.synchronize()
        d = diagnostics.to_dict(diag)
        drift = {key: abs(d[key] - d0[key]) / abs(d0[key])
                 for key in ("volume", "mass_T", "mass_S")}
        log(f"observed step {k}: cfl_2d={d['cfl_2d']!r} (printed, not held) "
            f"drift volume={drift['volume']:.3e} mass_T={drift['mass_T']:.3e} "
            f"mass_S={drift['mass_S']:.3e} (held to {OBS_DRIFT_MAX:.0e}); "
            f"speed_max={d['speed_max']:.4e} eta_max={d['eta_max']:.4e} "
            f"nonfinite={d['nonfinite']}")
        policy.check(d, step=k, registry=reg)
        per_step.append(dict(cfl_2d=d["cfl_2d"], **drift))
    reg.flush(step=STEPS)
    metrics.configure(None)
    problems = obs_smoke.check_jsonl(str(jsonl), STEPS)
    if problems:
        raise AssertionError(f"observed-step JSONL {jsonl}: {problems}")
    log(f"observed step: {jsonl.relative_to(ROOT)} is schema-valid with "
        "stage timings, physics diagnostics and kernel dispatch counters")

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs_smoke", "--device", "cuda",
         "--run-dir", str(ROOT / "chiprun_out" / "obs_smoke")],
        env=module_env(), capture_output=True, text=True, timeout=600)
    log(f"obs_smoke --device cuda: exit {res.returncode} in "
        f"{time.perf_counter() - t0:.1f}s: {res.stdout.strip()} "
        f"{res.stderr.strip()[-2000:]}")
    if res.returncode != 0:
        raise AssertionError(f"obs_smoke exited {res.returncode}")
    return dict(per_step=per_step)


# ---------------------------------------------------------------------------
# phase 5b: the paper's GBR case
# ---------------------------------------------------------------------------
def phase_gbr(smi: str) -> dict:
    """STEPS float64 steps of the GBR case (`gbr_reef.full_size_setup`)
    through the cuda backend, counted; the same steps through the plain
    backend, which must agree within TOL_PATH; TIMED_STEPS more cuda steps
    for ms/step; then, from the state after the counted steps, one per-call
    step (fused_horizontal=False, no lateral-flux launch) and one fused step
    on each backend: per-call and fused agree within PER_CALL_TOL on plain,
    within TOL_PATH on cuda."""
    import dataclasses
    from repro_torch import gbr_reef
    from repro_torch.kernels import dispatch, ops
    from repro_torch.obs import metrics

    dtype = torch.float64
    t0 = time.perf_counter()
    geom, vg, cfg, st0, forcing_at, m_cfl = gbr_reef.full_size_setup(
        dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    log(f"GBR: {geom.nt} triangles x {cfg.nl} layers "
        f"({geom.nt * cfg.nl} prisms), {dtype}, dt={cfg.dt}s, "
        f"m_2d={cfg.m_2d} (external_substeps at "
        f"{gbr_reef.FULL_SIZE['depth_deep']} m: {m_cfl}; at least "
        f"{gbr_reef.FULL_SIZE_M2D_MIN}), reef bathymetry "
        f"{float(vg.b.min()):.2f}-{float(vg.b.max()):.2f} m, Jackett, GLS, f={cfg.coriolis_f}, tide, "
        f"wind, open-boundary T/S; setup {time.perf_counter() - t0:.1f}s")
    if dispatch.resolve(cfg.backend, geom.area.device) is not dispatch.Backend.CUDA:
        raise AssertionError("backend auto did not resolve to cuda")

    torch.cuda.reset_peak_memory_stats()
    metrics.reset()
    ops.reset_launches()
    st_cuda, times = run_steps(geom, vg, cfg, st0, STEPS, forcing_at)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expect = {(op, "cuda"): STEPS * n for op, n in PER_STEP.items()}
    if launches != expect:
        raise AssertionError(f"GBR launch counts {launches} != {expect}")
    check_dispatches(launches)
    log(f"GBR cuda: launches {sorted(launches.items())} in {STEPS} steps "
        f"({ {op: n for op, n in PER_STEP.items()} } a step), equal to the "
        f"dispatch registry")

    cfg_plain = dataclasses.replace(cfg, backend="plain")
    ops.reset_launches()
    st_plain, times_plain = run_steps(geom, vg, cfg_plain, st0, STEPS,
                                      forcing_at)
    expect = {(op, "plain"): STEPS * n for op, n in PER_STEP.items()}
    if dict(ops.LAUNCHES) != expect:
        raise AssertionError(f"GBR plain launch counts {dict(ops.LAUNCHES)} "
                             f"!= {expect}")
    diffs = compare_states(st_cuda, st_plain, dtype)
    umax = float(st_cuda.ux.abs().max())
    if not umax > 0.0:
        raise AssertionError("GBR: no flow developed")
    short = lambda d: {k: float(f"{v:.3e}") for k, v in d.items()}
    log(f"GBR plain: step times {[round(t * 1e3, 2) for t in times_plain]} "
        f"ms; cuda vs plain {short(diffs)} (held to {TOL_PATH[dtype]}); "
        f"max|u| {umax:.4e}")

    st_end, steady = run_steps(geom, vg, cfg, st_cuda, TIMED_STEPS, forcing_at)
    for name, get in FIELDS.items():
        if not bool(torch.isfinite(get(st_end)).all()):
            raise AssertionError(f"GBR: non-finite {name} after "
                                 f"{STEPS + TIMED_STEPS} steps")
    vort = gbr_reef.surface_vorticity(geom, st_end).abs().cpu().numpy()
    ms = float(np.mean(steady)) * 1e3
    res = dict(m_2d=cfg.m_2d, ms_per_step=ms, ms_min=min(steady) * 1e3,
               ms_max=max(steady) * 1e3, first_step_ms=times[0] * 1e3,
               physical_over_wall=cfg.dt / (ms / 1e3), peak_bytes=peak,
               rel_diff_vs_plain=diffs, launches=launches,
               vort_p50=float(np.percentile(vort, 50)),
               vort_p99=float(np.percentile(vort, 99)))
    log(f"GBR cuda float64: counted steps {[round(t * 1e3, 2) for t in times]} "
        f"ms; {TIMED_STEPS} steady steps {[round(t * 1e3, 2) for t in steady]} "
        f"ms: mean {ms:.2f} (min {res['ms_min']:.2f}, max {res['ms_max']:.2f}) "
        f"ms/step; physical/wall {res['physical_over_wall']:.2f}; peak memory "
        f"{peak / 2**30:.3f} GiB ({peak} bytes); max|u| "
        f"{float(st_end.ux.abs().max()):.4e}; |vorticity| p50 "
        f"{res['vort_p50']:.3e} p99 {res['vort_p99']:.3e} 1/s; on {smi}")

    # one step of each path on each backend, from the state after the
    # counted steps: per-call against fused is held on the plain backend to
    # PER_CALL_TOL of max(|x|, 1); on the cuda backend, where K4 rounds
    # otherwise than lat_scatter, to TOL_PATH of each field's own maximum
    # (as cuda against plain), and both measures are logged
    one = {}
    for bk in ("plain", "cuda"):
        for fused in (False, True):
            c = dataclasses.replace(cfg, backend=bk, fused_horizontal=fused)
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            ops.reset_launches()
            st1, t1 = run_steps(geom, vg, c, st_cuda, 1, forcing_at)
            # the step's working memory: its peak above what was live
            one[(bk, fused)] = (st1, dict(ops.LAUNCHES), t1[0] * 1e3,
                                torch.cuda.max_memory_allocated() - live)
    for bk in ("plain", "cuda"):
        got = one[(bk, False)][1]
        expect = {(op, bk): n for op, n in PER_STEP.items()
                  if op != "lateral_flux"}
        if got != expect:
            raise AssertionError(f"GBR per-call {bk} launches {got} != {expect}")

    def diff(a, b):
        out = {}
        for name, get in FIELDS.items():
            x, y = get(one[a][0]), get(one[b][0])
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"GBR {a}: non-finite {name}")
            d = float((x - y).abs().max())
            amax = float(y.abs().max())
            out[name] = (d / max(amax, 1.0), d / amax if amax > 0 else d)
        return out
    pairs = {"plain per-call vs fused": (("plain", False), ("plain", True)),
             "cuda per-call vs fused": (("cuda", False), ("cuda", True)),
             "per-call cuda vs plain": (("cuda", False), ("plain", False)),
             "fused cuda vs plain": (("cuda", True), ("plain", True))}
    diffs1 = {label: diff(*ab) for label, ab in pairs.items()}
    for label, d in diffs1.items():
        met = all(v[0] <= PER_CALL_TOL for v in d.values())
        log(f"GBR one step, {label}: of max(|x|, 1) "
            f"{short({k: v[0] for k, v in d.items()})}; of each field's max "
            f"{short({k: v[1] for k, v in d.items()})}; within "
            f"{PER_CALL_TOL} of max(|x|, 1): {'yes' if met else 'NO'}")
    for name, (rel1, _) in diffs1["plain per-call vs fused"].items():
        if not rel1 <= PER_CALL_TOL:
            raise AssertionError(f"GBR {name}: plain per-call vs fused "
                                 f"{rel1:.3e} > {PER_CALL_TOL}")
    for name, (_, rel) in diffs1["cuda per-call vs fused"].items():
        if not rel <= TOL_PATH[dtype]:
            raise AssertionError(f"GBR {name}: cuda per-call vs fused "
                                 f"{rel:.3e} > {TOL_PATH[dtype]}")
    res.update(one_step_diff={k: {n: v[0] for n, v in d.items()}
                              for k, d in diffs1.items()},
               per_call_launches=one[("cuda", False)][1],
               per_call_ms=one[("cuda", False)][2],
               fused_ms=one[("cuda", True)][2],
               per_call_work_bytes=one[("cuda", False)][3],
               fused_work_bytes=one[("cuda", True)][3])
    log(f"GBR per-call cuda step: launches "
        f"{sorted(res['per_call_launches'].items())} (no lateral_flux); "
        f"{res['per_call_ms']:.2f} ms, peak above the live tensors "
        f"{res['per_call_work_bytes'] / 2**30:.3f} GiB; fused cuda step "
        f"{res['fused_ms']:.2f} ms, {res['fused_work_bytes'] / 2**30:.3f} "
        f"GiB; plain per-call / fused {one[('plain', False)][2]:.2f} / "
        f"{one[('plain', True)][2]:.2f} ms, "
        f"{one[('plain', False)][3] / 2**30:.3f} / "
        f"{one[('plain', True)][3] / 2**30:.3f} GiB")
    del geom, vg, st0, st_cuda, st_plain, st_end, one
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 6: the model kernels
# ---------------------------------------------------------------------------
def model_inputs(case: dict, seed: int) -> list:
    """Seeded float32 numpy inputs with the JAX tests' recipes
    (tests/test_kernels.py): wkv6 r, k, v, u ~ 0.5 N and the decay
    w = exp(-exp(0.5 N - 1)); attention q, k, v ~ 0.3 N."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)
    BH, T, d = case["B"] * case["H"], case["T"], case["d"]
    if case["op"] == "wkv6":
        r, k, v = (0.5 * n(BH, T, d) for _ in range(3))
        w = np.exp(-np.exp(0.5 * n(BH, T, d) - 1.0))
        return [r, k, v, w, 0.5 * n(d)]
    return [0.3 * n(BH, T, d) for _ in range(3)]


def attention_pairs(T: int, causal: bool, window) -> int:
    """Unmasked (q, k) pairs of one head: the keys each query row sees."""
    qi = np.arange(T, dtype=np.int64)
    hi = qi if causal else np.full(T, T - 1)
    lo = np.maximum(qi - window + 1, 0) if window else np.zeros(T, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def model_flops(case: dict) -> int:
    """K8: per token and head, 5 K V flops (k v, then two FMAs an element
    of S: r S into the output, w S + kv), 3 K for sum_i r u k and 2 V for
    adding its product with v; K9: 4 d per unmasked pair."""
    BH, T, d = case["B"] * case["H"], case["T"], case["d"]
    if case["op"] == "wkv6":
        return (5 * d * d + 3 * d + 2 * d) * T * BH
    return 4 * d * BH * attention_pairs(T, case["causal"], case.get("window"))


def wkv6_flops_unfactored(case: dict) -> int:
    """7 K V flops per token and head: the count of K8's bound before its
    redesign, which added u k v to S for every element."""
    return 7 * case["d"] * case["d"] * case["T"] * case["B"] * case["H"]


def model_held(out, ref, dtype) -> tuple:
    """(max |out - ref|, the largest share of its limit an element uses; the
    check passes at <= 1).  float32: TOL * max(|ref|, 1) for every element.
    bfloat16: TOL * the largest |ref| of the element's row.  Attention rows
    over thousands of keys are small (about 0.005 at hubert-xlarge), so one
    limit for the whole output, floored at 1 or set by the causal mask's
    short first rows, would let a kernel that drops a key tile pass."""
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        lim = TOL[dtype] * ref.float().abs().amax(dim=-1, keepdim=True)
    else:
        lim = TOL[dtype] * max(float(ref.float().abs().max()), 1.0)
    share = torch.where(diff == 0, 0.0, diff / lim)
    return float(diff.max()), float(share.max())


def phase_model(ptxas: dict) -> dict:
    """Each case in float32 and bfloat16: one counted call through the ops
    entry point on `auto`, held against the plain version, then timed."""
    from repro_torch.kernels import dispatch, flash_attention, ops, wkv6

    torch.backends.cuda.matmul.allow_tf32 = False   # plain in full float32
    results, path = {}, {}
    clock = sm_clock_mhz()
    for cname, case in MODEL_CASES.items():
        arrs = model_inputs(case, SEED)
        if case["op"] == "wkv6":
            kname, kern, plain, library = ("wkv6", wkv6.wkv6, wkv6.wkv6_plain,
                                           None)
            entry = ops.wkv6
            var = None          # the plan's instantiation, below
        else:
            opts = dict(causal=case["causal"], window=case.get("window"),
                        softcap=case.get("softcap"))
            kname = "flash_attention"
            kern = lambda q, k, v: flash_attention.flash_attention(q, k, v, **opts)
            plain = lambda q, k, v: flash_attention.flash_attention_plain(
                q, k, v, **opts)
            entry = lambda q, k, v: ops.attention(q, k, v, **opts)
            library = None
            if case.get("window") is None and case.get("softcap") is None:
                # (B, H, T, d) views: SDPA's fused kernels take 4-D inputs
                # only; on (BH, T, d) it runs its unfused math path
                heads = (case["B"], case["H"])
                library = lambda q, k, v: (
                    torch.nn.functional.scaled_dot_product_attention(
                        q.unflatten(0, heads), k.unflatten(0, heads),
                        v.unflatten(0, heads), is_causal=case["causal"])
                    .flatten(0, 1))
            var = f"flash_attention_{{}}_d{case['d']}"
        flops = model_flops(case)
        for dtype in (torch.float32, torch.bfloat16):
            ins = [torch.as_tensor(a).to(device="cuda", dtype=dtype)
                   for a in arrs]
            if dispatch.resolve_model(None, ins[0].device) is not dispatch.Backend.CUDA:
                raise AssertionError("auto did not resolve to cuda")
            ops.reset_launches()
            out = entry(*ins)
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            if launches != {(kname, "cuda"): 1}:
                raise AssertionError(f"{cname} {dtype}: launches {launches} != "
                                     f"one {kname} on cuda")
            path[(kname, "cuda")] = path.get((kname, "cuda"), 0) + 1
            ref = plain(*ins)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"{cname} {dtype}: kernel gives "
                                     f"{out.dtype} {tuple(out.shape)}, plain "
                                     f"{ref.dtype} {tuple(ref.shape)}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{cname} {dtype}: non-finite output")
            err, share = model_held(out, ref, dtype)
            ref_max = float(ref.float().abs().max())
            if not share <= 1.0:
                raise AssertionError(f"{cname} {dtype}: max_abs_err {err:.3e}, "
                                     f"{share:.3f} of its limit (max|plain| "
                                     f"{ref_max:.3e})")
            dt = "f32" if dtype == torch.float32 else "bf16"
            alts = {}
            if kname == "wkv6":
                # every plan the launcher takes for this shape (a block
                # width each): each held against the plain version, then
                # timed; the first is the plan's own choice
                BH, _, d = ins[0].shape
                V = ins[2].shape[-1]
                plans = wkv6.alternatives(BH, d, V, dtype)
                alt_name = lambda p: f"{p['block_cols']} columns"
                if dict(plans[0]) != dict(wkv6.launch_plan(BH, d, V, dtype)):
                    raise AssertionError("alternatives()[0] is not the plan")
                for p in plans:
                    a_out = wkv6.wkv6(*ins, plan=p)
                    a_err, a_share = model_held(a_out, ref, dtype)
                    if not a_share <= 1.0:
                        raise AssertionError(f"{cname} {dt} plan {dict(p)}: "
                                             f"max_abs_err {a_err:.3e}, "
                                             f"{a_share:.3f} of its limit")
                    del a_out
                    alts[alt_name(p)] = dict(
                        plan=dict(p), max_abs_err=a_err,
                        blocks_per_sm=wkv6.blocks_per_sm(p, d, dtype),
                        ptxas=ptxas.get(f"wkv6_{dt}_k{d}_r{p['rows']}"
                                        f"c{p['cols']}", {}))
                for rnd in (1, 2):      # two rounds, alternatives in turn
                    for p in plans:
                        alts[alt_name(p)][f"ms_{rnd}"] = time_ms(
                            lambda: wkv6.wkv6(*ins, plan=p), reps=20)
                var = f"wkv6_{{}}_k{d}_r{plans[0]['rows']}c{plans[0]['cols']}"
            del ref
            ms = time_ms(lambda: kern(*ins), reps=20)
            plain_ms = time_ms(lambda: plain(*ins), reps=3, warmup=1)
            library_ms = lib_err = lib_share = None
            if library is not None:
                lib_out = library(*ins)
                lib_err, lib_share = model_held(lib_out, out, dtype)
                if not lib_share <= 1.0:
                    raise AssertionError(f"{cname} {dtype}: the library call "
                                         f"differs by {lib_err:.3e}, "
                                         f"{lib_share:.3f} of the limit")
                del lib_out
                library_ms = time_ms(lambda: library(*ins), reps=20)
            moved = nbytes(*ins, out)
            # K8's state is float32 whatever the inputs' dtype
            bound, by = bound_of(moved, flops,
                                 torch.float32 if kname == "wkv6" else dtype)
            regs = ptxas.get(var.format(dt), {})
            lib_txt = ("" if library_ms is None else
                       f" library_ms={library_ms:.4f} (vs kernel {lib_err:.3e}, "
                       f"{lib_share:.3f} of the limit)")
            sfu_ms = None
            if kname == "flash_attention":
                # one exp per unmasked pair on the SFU at the max SM clock
                sfu_ms = (flops / (4 * case["d"])
                          / (SFU_EX2_PER_CLOCK * clock * 1e6) * 1e3)
                before = K9_BEFORE_MS[(cname, dt)]
                lib_txt += (f" sfu_exp_floor_ms={sfu_ms:.4f} (at {clock:.0f} MHz)"
                            f" before_ms={before:.4f} (FP32-pipe kernel; "
                            f"{before / ms:.2f}x)")
            if kname == "wkv6":
                before = K8_BEFORE_MS[(cname, dt)]
                bound7, _ = bound_of(moved, wkv6_flops_unfactored(case),
                                     torch.float32)
                lib_txt += (f" before_ms={before:.4f} (column-a-thread kernel; "
                            f"{before / ms:.2f}x; share of this bound "
                            f"{bound / before:.4f}) bound_ms_7flop="
                            f"{bound7:.4f} (share {bound7 / ms:.4f})")
                for name, a in alts.items():
                    log(f"model wkv6 {cname} {dt} plan {name}: "
                        f"ms={a['ms_1']:.4f} / {a['ms_2']:.4f} "
                        f"(share {bound / a['ms_1']:.4f} / "
                        f"{bound / a['ms_2']:.4f}) max_abs_err="
                        f"{a['max_abs_err']:.3e} blocks_per_sm="
                        f"{a['blocks_per_sm']} ptxas {a['ptxas']} "
                        f"plan {a['plan']}")
            log(f"model {kname} {cname} {dt}: shape={tuple(ins[0].shape)} "
                f"max_abs_err={err:.3e} (max|plain| {ref_max:.3e}; "
                f"{share:.3f} of the limit, tol {TOL[dtype]:.0e} "
                f"{'per row' if dtype == torch.bfloat16 else 'x max(|plain|, 1)'}) "
                f"ms={ms:.4f} plain_ms={plain_ms:.3f}{lib_txt} bytes={moved} "
                f"flops={flops} bound_ms={bound:.4f} "
                f"({by}) share_of_bound={bound / ms:.4f} ptxas {var.format(dt)} {regs}")
            results[(cname, dt)] = dict(
                kernel=kname, max_abs_err=err, limit_share=share, ms=ms,
                plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound, sfu_floor_ms=sfu_ms,
                bound_by=by, bytes=moved, flops=flops, shape=list(ins[0].shape),
                ptxas=regs,
                alternatives={n: {k: a[k] for k in ("ms_1", "ms_2",
                                                    "max_abs_err", "ptxas",
                                                    "blocks_per_sm")}
                              for n, a in alts.items()},
                plan=alts[next(iter(alts))]["plan"] if alts else None)
            del ins, out
            torch.cuda.empty_cache()
    log(f"model kernels: launches on the path {sorted(path.items())}")
    return dict(results=results, launches=path)


def model_rows(model: dict, serve: dict, train: dict, mesh: dict) -> list:
    """The K8 and K9 rows of the kernel table: the float32 and bfloat16
    numbers of MODEL_TABLE_CASE, with every case's numbers under `cases`.
    `launches` is the main path's: one step of phase 10's training of the
    model that runs the kernel (`launches_serve`: every prefill of phase 9;
    `launches_kernel_phase`: phase 6's calls; `launches_mesh`: every rank's
    launches over phase 11's steps, each on the rank's own heads); K9's row
    adds its time with the row statistics (phase 10 (a))."""
    rows = []
    for name, cname in MODEL_TABLE_CASE.items():
        on_path = {key: n for key, row in serve.items()
                   for k, n in row["launches"].items() if k == f"{name}/cuda"}
        on_train = {f"train/{arch}/bf16 step": n
                    for arch, row in train["train"].items()
                    for k, n in row["launches_per_step"].items()
                    if k == f"{name}/cuda"}
        main_key = next(iter(on_train))
        r32 = model["results"][(cname, "f32")]
        r16 = model["results"][(cname, "bf16")]
        cases = {c: {dt: {k: model["results"][(c, dt)][k] for k in
                          ("ms", "bound_ms", "bound_by", "plain_ms",
                           "library_ms", "max_abs_err", "limit_share",
                           "shape", "alternatives", "plan", "ptxas")}
                      for dt in ("f32", "bf16")}
                 for c, case in MODEL_CASES.items()
                 if (case["op"] == "wkv6") == (name == "wkv6")}
        on_mesh = {f"mesh/{arch}": row["launches_mesh"]
                   for arch, row in mesh.items()
                   if f"{name}/cuda" in row["launches_per_rank_step"]}
        rows.append(dict(
            name=name, route="cuda", source=MODEL_SOURCE[name],
            replaces=REPLACES[name], launches=on_train[main_key],
            launches_path=main_key, launches_serve=on_path,
            launches_mesh=on_mesh,
            launches_kernel_phase=model["launches"][(name, "cuda")],
            max_abs_err=r32["max_abs_err"], ms=r32["ms"],
            plain_ms=r32["plain_ms"], bound_ms=r32["bound_ms"],
            bound_by=r32["bound_by"], library_ms=r32["library_ms"],
            dtype="float32", shape=r32["shape"], case=cname,
            ms_bf16=r16["ms"], bound_ms_bf16=r16["bound_ms"],
            plain_ms_bf16=r16["plain_ms"], library_ms_bf16=r16["library_ms"],
            max_abs_err_bf16=r16["max_abs_err"], cases=cases))
        if name == "flash_attention":
            stats = train["kernels"]["stats"]
            rows[-1].update({
                f"{key}{'' if dt == 'f32' else '_bf16'}": stats[f"{cname}/{dt}"][key]
                for dt in ("f32", "bf16")
                for key in ("ms_stats", "bound_ms_stats")})
    return rows


# ---------------------------------------------------------------------------
# phase 7: the resilient campaign
# ---------------------------------------------------------------------------
def state_diff(a, b) -> dict:
    """Largest |a - b| of each leaf of two states on one device."""
    from repro_torch import tree as T
    return {T.keystr(p): float((x - y).abs().max())
            for (p, x), y in zip(T.flatten_with_path(a), T.leaves(b))}


def require_bitwise(got, want, what: str) -> None:
    from repro_torch.chaos_smoke import bitwise_equal
    if not bitwise_equal(got, want):
        raise AssertionError(f"{what}: not bitwise equal to the fault-free "
                             f"leg; max |diff| by leaf {state_diff(got, want)}")


def checkpoint_bytes(directory: Path) -> int:
    return sum(f.stat().st_size for f in directory.iterdir())


def phase_campaign(bare_ms: float) -> dict:
    """`sim_campaign` legs through SimulationRunner on the card: phase 4's
    case in float64 at full width, CAMPAIGN_STEPS steps a leg, a checkpoint
    every 2 steps, 2 kept.  Two fault-free legs must end bitwise equal;
    each recoverable fault class must end bitwise equal to them; the
    checkpoint restores onto the CPU and back bitwise; then, at the small
    case of the JAX dt-ladder test, the ladder and a recovery resharded
    onto the other device."""
    import shutil
    import tempfile
    from repro_torch import quickstart
    from repro_torch import tree as T
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.kernels import ops
    from repro_torch.launch import sim_campaign
    from repro_torch.obs import diagnostics, metrics
    from repro_torch.runtime import chaos
    from repro_torch.runtime.fault_tolerance import LadderConfig, RunnerConfig

    n = CAMPAIGN_STEPS
    geom, vg, cfg, st0 = quickstart.setup(nx=NX, nl=NL, dtype=torch.float64,
                                          device="cuda")
    case = sim_campaign.Case(geom=geom, vg=vg, cfg=cfg, state=st0)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_campaign_"))
    res = dict(legs={})

    def leg(name, plan=None, resume=False, c=case, steps=n, emit=False,
            ladder=None, keep=False, counted=True):
        """One campaign leg; a counted leg (all on the card) must launch
        each kernel PER_STEP times for every step it ran, the retried ones
        included, as the registry counts it."""
        d = root / name
        rcfg = RunnerConfig(checkpoint_dir=str(d), checkpoint_every=2,
                            keep_last=2, max_retries=3, emit_metrics=emit,
                            backoff_base_s=0.0)
        metrics.reset()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, runner = sim_campaign.run_campaign(
            c, steps, rcfg, ladder=ladder,
            policy=sim_campaign.default_policy(), plan=plan, resume=resume)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = runner.stats["steps"]
        launches = dict(ops.LAUNCHES)
        if counted:
            runs = ran + runner.stats["retries"]
            expect = {(op, "cuda"): runs * k for op, k in PER_STEP.items()}
            if launches != expect:
                raise AssertionError(f"campaign leg {name}: launches "
                                     f"{launches} != {expect}")
            check_dispatches(launches)
        res["legs"][name] = dict(wall_s=wall, steps=ran,
                                 retries=runner.stats["retries"],
                                 ms_per_step=wall / max(ran, 1) * 1e3,
                                 launches={op: k for (op, _), k in
                                           launches.items()} if counted
                                 else None)
        log(f"campaign leg {name}: {ran} steps in {wall:.3f} s "
            f"({wall / max(ran, 1) * 1e3:.2f} ms a step, checkpoints and "
            f"recovery included); stats {runner.stats}; launches "
            f"{sorted(launches.items()) if counted else 'not counted'}; "
            f"chaos {plan.log if plan is not None else []}")
        if not keep:
            shutil.rmtree(d, ignore_errors=True)
        return out, runner

    try:
        # 1. determinism: two fault-free legs
        base, runner = leg("baseline", emit=True, keep=True)
        launches = {(op, "cuda"): k for op, k in
                    res["legs"]["baseline"]["launches"].items()}
        res["launches"] = launches
        hist = metrics.default().histogram("runner.step_time_s").snapshot()
        res["runner_step_ms"] = {k: hist[k] * 1e3
                                 for k in ("p50", "min", "max")}
        log(f"campaign: launches {sorted(launches.items())} over {n} steps "
            f"(2/2/2/4/4 a step, equal to the registry); the runner's step "
            f"(step, diagnostics, monitor) p50 {hist['p50'] * 1e3:.2f} ms "
            f"(min {hist['min'] * 1e3:.2f}, max {hist['max'] * 1e3:.2f}) "
            f"against phase 4's bare f64 step {bare_ms:.2f} ms")
        again, _ = leg("baseline2")
        require_bitwise(again, base, "second fault-free leg")
        log("campaign: two fault-free full-width cuda legs bitwise equal")
        del again

        # 2. the four recoverable fault classes
        plan = chaos.FaultPlan([chaos.Fault("sim.state", "poison_nan",
                                            step=n - 1, field="T")])
        out, r = leg("nan", plan)
        if not (len(plan.log) == 1 and r.stats["retries"] == 1
                and r.rung == 0):
            raise AssertionError(f"nan leg: {plan.log} {r.stats}")
        require_bitwise(out, base, "nan-poison leg")

        plan = chaos.FaultPlan(
            [chaos.Fault("checkpoint.saved", "truncate", step=4),
             chaos.Fault("sim.state", "poison_inf", step=n - 1, field="ux")])
        out, r = leg("corrupt", plan)
        skipped = metrics.default().snapshot()["counter"].get(
            "checkpoint.corrupt_skipped", 0)
        if not skipped >= 1:
            raise AssertionError("corrupt leg: no corrupt step skipped")
        require_bitwise(out, base, "corrupt-checkpoint leg")

        plan = chaos.FaultPlan([chaos.Fault("runner.step", "preempt",
                                            step=n - 2)])
        _, r1 = leg("preempt", plan, keep=True)
        if not (r1.stats["preempted"] and r1.ckpt.latest_step() == n - 2):
            raise AssertionError(f"preempt leg: {r1.stats}")
        out, r2 = leg("preempt", resume=True)
        if r2.stats["steps"] != 2:
            raise AssertionError(f"resumed leg ran {r2.stats['steps']} steps")
        require_bitwise(out, base, "preempted and resumed legs")

        plan = chaos.FaultPlan([chaos.Fault("checkpoint.write", "io_error",
                                            step=2)])
        out, r = leg("savefail", plan)
        if not (r.stats["ckpt_failures"] == 1 and r.stats["retries"] == 0):
            raise AssertionError(f"save-failure leg: {r.stats}")
        require_bitwise(out, base, "save-failure leg")
        del out
        log("campaign: nan-poison, corrupt checkpoint, preemption and save "
            "failure each end bitwise equal to the fault-free leg")

        # 3. the checkpoint: bytes, save and restore times, across devices
        ck = runner.ckpt
        step_dir = root / "baseline" / f"step_{n:09d}"
        res["checkpoint_bytes"] = checkpoint_bytes(step_dir)
        res["state_bytes"] = sum(x.numel() * x.element_size()
                                 for x in T.leaves(base))
        t0 = time.perf_counter()
        on_cpu = ck.restore(st0, devices="cpu")
        res["restore_cpu_ms"] = (time.perf_counter() - t0) * 1e3
        require_bitwise(on_cpu, T.map_leaves(lambda x: x.cpu(), base),
                        "checkpoint restored onto the CPU")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = ck.restore(st0)
        torch.cuda.synchronize()
        res["restore_cuda_ms"] = (time.perf_counter() - t0) * 1e3
        require_bitwise(on_card, base, "checkpoint restored onto the card")
        host = Checkpointer(str(root / "host"), keep_last=2)
        host.save(n, on_cpu, blocking=True)
        back = host.restore(on_cpu, devices="cuda")
        require_bitwise(back, base, "cuda -> CPU -> cuda restore")
        del on_cpu, on_card, back
        shutil.rmtree(root / "host", ignore_errors=True)
        saves = []
        timed = Checkpointer(str(root / "timed"), keep_last=1)
        for k in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed.save(k, base)
            t1 = time.perf_counter()
            timed.wait()
            saves.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        res["save_ms"] = saves
        shutil.rmtree(root / "timed", ignore_errors=True)
        log(f"campaign checkpoint: {res['checkpoint_bytes']} bytes on disk "
            f"({res['state_bytes']} bytes of state, {len(T.leaves(st0))} "
            f"leaves); save: "
            f"caller-side copy {[round(c, 2) for c, _ in saves]} ms, worker "
            f"(np.save + crc32 + rename) {[round(w, 2) for _, w in saves]} "
            f"ms; restore with crc32 verification onto the CPU "
            f"{res['restore_cpu_ms']:.2f} ms, onto the card "
            f"{res['restore_cuda_ms']:.2f} ms; cuda -> CPU -> cuda bitwise")
        del base
        shutil.rmtree(root / "baseline", ignore_errors=True)
        del case, geom, vg, st0, runner, ck
        torch.cuda.empty_cache()

        # 4. the small case: the dt ladder, and recoveries resharded onto
        # the other device (each against a leg resumed on that device)
        small = sim_campaign.build_case(nx=4, ny=3, nl=4, dt=80.0,
                                        device="cuda")
        try:
            leg("blind", c=small, steps=4, emit=True,
                ladder=LadderConfig(max_rungs=0))
            raise AssertionError("blind retry at dt 80 did not fail")
        except diagnostics.MonitorHalt:
            pass
        blind = metrics.default().snapshot()["counter"].get("runner.retries")
        if blind != 4:
            raise AssertionError(f"blind retry: {blind} retries, not 4")
        out, r = leg("ladder", c=small, steps=4, emit=True,
                     ladder=LadderConfig(dt_factor=0.5, max_rungs=2,
                                         recover_steps=64))
        d = diagnostics.to_dict(diagnostics.compute(
            small.geom, small.vg, small.cfg.with_recovery(0.5), out))
        if not (r.rung == 1 and r.stats["steps"] == 4
                and float(out.time) == 4 * 40.0 and not d["nonfinite"]
                and d["cfl_2d"] < 1.0):
            raise AssertionError(f"dt ladder: rung {r.rung} {r.stats} "
                                 f"time {float(out.time)} {d}")
        res["ladder"] = dict(rung=r.rung, steps=r.stats["steps"],
                             time=float(out.time), cfl_2d=d["cfl_2d"])
        log(f"campaign dt ladder (rect_mesh(4, 3), dt 80 s): blind retry "
            f"exhausts 4 retries; the ladder ends at rung {r.rung}, "
            f"{r.stats['steps']} steps, time {float(out.time)} s, cfl_2d "
            f"{d['cfl_2d']:.4f}")

        on = {"cuda": sim_campaign.build_case(nx=4, ny=3, nl=4,
                                              device="cuda")}
        on["cpu"] = T.map_leaves(
            lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, on["cuda"])
        for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
            plan = chaos.FaultPlan([chaos.Fault("runner.step", "preempt",
                                                step=4)])
            leg(f"to_{dst}", plan, c=on[src], keep=True,
                counted=src == "cuda")
            ref, _ = leg(f"to_{dst}", c=on[dst], resume=True,
                         counted=dst == "cuda")
            plan = chaos.FaultPlan(
                [chaos.Fault("sim.state", "poison_nan", step=5, field="S"),
                 chaos.Fault("runner.restore_shardings", "reshard",
                             args={"device": dst})])
            out, r = leg(f"reshard_to_{dst}", plan, c=on[src], counted=False)
            if [f["kind"] for f in plan.log] != ["poison_nan", "reshard"]:
                raise AssertionError(f"reshard leg: {plan.log}")
            require_bitwise(out, ref, f"recovery resharded {src} -> {dst}")
            if out.ux.device.type != dst:
                raise AssertionError(f"resharded leg ended on {out.ux.device}")
        log("campaign: a recovery resharded cuda -> CPU and CPU -> cuda "
            "ends bitwise equal to a leg resumed on that device")

        # 5. the entry points, with no --device: on the card
        for args, expect in (
                (["repro_torch.chaos_smoke"], "OK chaos smoke"),
                (["repro_torch.launch.sim_campaign", "--steps", "6",
                  "--ckpt-every", "2", "--ckpt", str(root / "cli"),
                  "--fault", "poison_nan@sim.state:step=5,field=T"],
                 "steps=7 retries=1")):
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-m", *args],
                                 env=module_env(), capture_output=True,
                                 text=True, timeout=600)
            out = run.stdout.strip()
            log(f"python -m {' '.join(args)}: exit {run.returncode} in "
                f"{time.perf_counter() - t0:.1f}s: {out[-1500:]} "
                f"{run.stderr.strip()[-2000:]}")
            if run.returncode != 0 or expect not in out or "cuda" not in out:
                raise AssertionError(f"{args[0]} on the card: exit "
                                     f"{run.returncode}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 8: the distributed step, ranks on the card
# ---------------------------------------------------------------------------
# (ranks, halo_exchange_period): per stage with a 1-deep halo, then
# communication-avoiding with a 6-deep one
DIST_RUNS = ((4, 0), (2, 2))
DIST_STEPS = 3
DIST_TIMEOUT_S = 480
# the gathered state against the single-device cuda step with identity hooks
# and the same period, of each field's max, and eta absolute; against the
# single-device ref step (the kernels' rounding, amplified by GLS) TOL_PATH
DIST_TOL, DIST_ETA_TOL = 1e-10, 1e-12


def dist_rank(rank: int, n_ranks: int, run: dict) -> dict:
    """One rank of phase 8, a process on cuda:0: its DistributedOcean of
    the main-path basin (backend auto: the CUDA kernels), the global
    initial state read by rank 0 from a checkpoint and scattered, `steps`
    timed steps (between barriers) with their launches counted, the
    gathered state saved by rank 0."""
    from repro_torch import quickstart
    from repro_torch import tree as T
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.distributed import halo, ocean
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics

    mesh = quickstart.basin_mesh(run["nx"])
    tr = halo.Transport()
    do = ocean.DistributedOcean(
        mesh, np.full((3, mesh.nt), quickstart.DEPTH_M), run["cfg"],
        rank, n_ranks, tr, device="cuda")
    st = do.restore(Checkpointer(run["init"]))
    step = do.make_step()
    reg = metrics.default()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ms, shifts, nbytes = [], [], []
    for _ in range(run["steps"]):
        s0 = reg.counter("halo.ppermute").value
        b0 = reg.counter("halo.bytes").value
        tr.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = step(st)
        torch.cuda.synchronize()
        tr.barrier()
        ms.append((time.perf_counter() - t0) * 1e3)
        shifts.append(int(reg.counter("halo.ppermute").value - s0))
        nbytes.append(int(reg.counter("halo.bytes").value - b0))
    launches = dict(ops.LAUNCHES)
    check_dispatches(launches)     # nothing dispatched before the steps
    peak = torch.cuda.max_memory_allocated()
    tensors = [*T.leaves(st), do.geom.area, do.b, *do.tables.send,
               *do.tables.recv]
    do.save(Checkpointer(run["out"]), run["steps"], st)
    return dict(
        rank=rank, mode=tr.mode, n_own=do.spec.n_own, n_loc=do.spec.n_loc,
        halo_slots=int(sum(s.shape[-1] for s in do.tables.send)),
        offsets=do.tables.offsets, backend=do.cfg.backend,
        on_card=all(x.is_cuda for x in tensors), ms=ms, shifts=shifts,
        bytes=nbytes, launches=launches, peak_bytes=peak)


def dist_diffs(ref, got) -> tuple:
    """Each field's max difference over its own max, and eta's absolute;
    raises on a non-finite gathered value."""
    diffs = {}
    for name, get in FIELDS.items():
        a, b = get(ref), get(got)
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"distributed: gathered {name} not finite")
        amax = float(a.abs().max())
        diffs[name] = float((a - b).abs().max()) / (amax or 1.0)
    return diffs, float((ref.ext.eta - got.ext.eta).abs().max())


def phase_distributed() -> dict:
    """The distributed step (`repro_torch.distributed`) on ranks that share
    the card: phase 4's case in float64 at full width, DIST_STEPS steps on
    each of DIST_RUNS through the CUDA kernels (counted on every rank),
    gathered into a checkpoint and held against the single-device cuda
    and ref steps on the card with identity hooks and the same period."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch import quickstart
    from repro_torch import tree as T
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.core import stepper
    from repro_torch.distributed import spawn
    # the closed form the CPU tests hold the halo counts to
    from repro_torch.distributed.halo import shifts_per_step

    geom, vg, cfg0, st0 = quickstart.setup(nx=NX, nl=NL, dtype=torch.float64,
                                           device="cuda")
    log(f"distributed: {geom.nt} triangles x {NL} layers, float64, "
        f"m_2d={cfg0.m_2d}, backend {cfg0.backend}; runs (ranks, "
        f"halo_exchange_period) {DIST_RUNS}, {DIST_STEPS} steps each, every "
        f"rank a process on cuda:0")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    res = {}
    try:
        Checkpointer(str(tmp / "init")).save(0, st0, blocking=True)
        for n_ranks, period in DIST_RUNS:
            cfg = dataclasses.replace(cfg0, halo_exchange_period=period)
            single, single_ms = {}, {}
            for bk in ("cuda", "ref"):
                st, single_ms[bk] = st0, []
                for _ in range(DIST_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st = stepper.step(geom, vg,
                                      dataclasses.replace(cfg, backend=bk),
                                      st, exchange2d=lambda s: s,
                                      exchange_field=lambda f: f)
                    torch.cuda.synchronize()
                    single_ms[bk].append((time.perf_counter() - t0) * 1e3)
                single[bk] = T.map_leaves(lambda x: x.cpu(), st)
                del st
            torch.cuda.empty_cache()

            out_dir = tmp / f"ranks{n_ranks}"
            t0 = time.perf_counter()
            ranks = spawn.run(dist_rank, n_ranks, timeout_s=DIST_TIMEOUT_S,
                              args=(dict(nx=NX, init=str(tmp / "init"),
                                         out=str(out_dir), steps=DIST_STEPS,
                                         cfg=cfg),))
            wall = time.perf_counter() - t0
            got = Checkpointer(str(out_dir)).restore(single["ref"],
                                                     step=DIST_STEPS)
            shutil.rmtree(out_dir)

            vs = {bk: dist_diffs(single[bk], got) for bk in single}
            bad = {k: v for k, v in vs["cuda"][0].items() if not v <= DIST_TOL}
            bad |= {f"{k} (vs ref)": v for k, v in vs["ref"][0].items()
                    if not v <= TOL_PATH[torch.float64]}
            if (bad or not vs["cuda"][1] <= DIST_ETA_TOL
                    or not vs["ref"][1] <= TOL_PATH[torch.float64]):
                raise AssertionError(
                    f"distributed {n_ranks} ranks, period {period}: gathered "
                    f"against single-device steps {bad}, eta abs "
                    f"{vs['cuda'][1]:.3e} (cuda), {vs['ref'][1]:.3e} (ref)")
            expect_launches = {(k, "cuda"): DIST_STEPS * n
                               for k, n in PER_STEP.items()}
            for r in ranks:
                closed = shifts_per_step(len(r["offsets"]), period, cfg.m_2d)
                checks = {
                    "transport gloo-staged": r["mode"] == "gloo-staged",
                    "tensors on the card": r["on_card"],
                    f"cuda launches {expect_launches}":
                        r["launches"] == expect_launches,
                    f"halo.ppermute {closed} a step":
                        r["shifts"] == [closed] * DIST_STEPS}
                failed = [k for k, ok in checks.items() if not ok]
                if failed:
                    raise AssertionError(f"distributed rank {r['rank']} of "
                                         f"{n_ranks}: {failed}: {r}")
            timed = [max(r["ms"][i] for r in ranks)
                     for i in range(1, DIST_STEPS)]
            row = dict(
                ranks=n_ranks, period=period, mode=ranks[0]["mode"],
                backend=ranks[0]["backend"],
                launches_per_rank={k[0]: v for k, v in
                                   ranks[0]["launches"].items()},
                ms_mean=float(np.mean(timed)), ms_min=min(timed),
                ms_max=max(timed), single_ms=single_ms,
                single_ms_mean={bk: float(np.mean(v[1:]))
                                for bk, v in single_ms.items()},
                wall_s=wall, rel_diff_vs_cuda=vs["cuda"][0],
                eta_abs_vs_cuda=vs["cuda"][1], rel_diff_vs_ref=vs["ref"][0],
                eta_abs_vs_ref=vs["ref"][1],
                per_rank=[{k: r[k] for k in (
                    "rank", "n_own", "n_loc", "halo_slots", "offsets", "ms",
                    "peak_bytes")} | {"shifts_per_step": r["shifts"][-1],
                                      "bytes_per_step": r["bytes"][-1]}
                          for r in ranks])
            res[f"{n_ranks}x{period}"] = row
            for r in row["per_rank"]:
                log(f"distributed {n_ranks} ranks, period {period}, rank "
                    f"{r['rank']}: n_own {r['n_own']}, n_loc {r['n_loc']}, "
                    f"halo slots {r['halo_slots']}, offsets {r['offsets']}, "
                    f"{r['shifts_per_step']} exchanges and "
                    f"{r['bytes_per_step']} bytes a step; step ms "
                    f"{[round(t, 2) for t in r['ms']]}; peak memory "
                    f"{r['peak_bytes'] / 2**30:.3f} GiB ({r['peak_bytes']} B)")
            short = lambda d: {k: float(f"{v:.3e}") for k, v in d.items()}
            log(f"distributed {n_ranks} ranks, period {period} "
                f"({row['mode']}, backend {row['backend']}: cuda launches a "
                f"rank {row['launches_per_rank']} in {DIST_STEPS} steps): ms "
                f"a step over a barrier, steps 2-{DIST_STEPS}: mean "
                f"{row['ms_mean']:.2f} (min {row['ms_min']:.2f}, max "
                f"{row['ms_max']:.2f}); single-device steps ms "
                f"{ {bk: [round(t, 2) for t in v] for bk, v in single_ms.items()} }; "
                f"run {wall:.1f} s with spawn and set-up; gathered against "
                f"the single-device cuda step {short(vs['cuda'][0])}, eta abs "
                f"{vs['cuda'][1]:.3e}; against the ref step "
                f"{short(vs['ref'][0])}, eta abs {vs['ref'][1]:.3e}; "
                f"nvidia-smi: {nvidia_smi()}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del geom, vg, st0
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 9: the LM serving path at full width and depth
# ---------------------------------------------------------------------------
SERVE_ARCHS = ("olmo-1b", "rwkv6-3b")   # configs/archs.py, full size
# the prompt: 512 tokens (1,024 until phase 13 needed the time; each held
# reading stays, the prompt stepped through decode is half as long)
SERVE_B, SERVE_T, SERVE_GEN = 4, 512, 32
SERVE_PREFILL_REPS = 3      # timed prefills after the counted one
# last-token logits, of max |logit|: cuda against plain, and serve's
# decode-stepped prompt against cuda prefill.  float32: the kernels' and the
# decode path's summation orders; bfloat16: phase 6's 2e-2 of one op,
# compounded over 16 or 32 layers.  A model whose own floor (below) is
# higher is held to SERVE_FLOOR_MARGIN times its floor instead
SERVE_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# the model's floor: the largest change of the cuda prefill's last-token
# logits, of max |logit|, when every attention / WKV output is multiplied
# by (1 + SERVE_NOISE N(0, 1)) in float32, over SERVE_FLOOR_DRAWS draws.
# 2^-23 is no larger than K8's difference from its plain version on the
# model path's inputs (1.1e-7 to 1.8e-7 of max |out| at rwkv6-3b, NVIDIA
# H100 80GB HBM3 at 700 W); the seeded rwkv6-3b amplifies it to ~0.11 of
# max |logit| in bfloat16 (PERF.md, section 6)
SERVE_NOISE = 2.0 ** -23
SERVE_FLOOR_DRAWS = 3
SERVE_FLOOR_MARGIN = 2.0
# the op and the kernel each family's prefill runs, by its mixer
SERVE_KERNEL = {"attn": ("attention", "flash_attention"), "rwkv": ("wkv6", "wkv6")}


def max_share(out, ref) -> float:
    """max |out - ref| over max |ref|."""
    ref = ref.float()
    return float((out.float() - ref).abs().max() / ref.abs().max())


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PeakMemory:
    """Peak allocated device memory from its creation to `read` (0 off the
    card)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def read(self) -> int:
        sync(self.dev)
        return (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else 0)


@contextlib.contextmanager
def tapped_model_ops(calls=None, noise=0.0, gen=None):
    """While active, `ops.wkv6` and `ops.attention` (which the models call
    through the module) append (op, args, kwargs) to ``calls`` and multiply
    each output by (1 + noise N(0, 1)) in float32."""
    from repro_torch.kernels import ops
    orig = {"wkv6": ops.wkv6, "attention": ops.attention}

    def wrap(name, fn):
        def call(*args, **kwargs):
            if calls is not None:
                calls.append((name, args, kwargs))
            out = fn(*args, **kwargs)
            if noise:
                eps = torch.randn(out.shape, generator=gen, device=out.device)
                out = (out.float() * (1.0 + noise * eps)).to(out.dtype)
            return out
        return call
    try:
        for name, fn in orig.items():
            setattr(ops, name, wrap(name, fn))
        yield
    finally:
        for name, fn in orig.items():
            setattr(ops, name, fn)


def hold_path_calls(calls: list, what: str) -> float:
    """Each recorded model-path call once more through the kernel and the
    plain version on its own inputs (not counted), held as phase 6 holds
    them (model_held); returns the largest share of the limit."""
    from repro_torch.kernels import ops
    worst = 0.0
    for i, (name, args, kwargs) in enumerate(calls):
        kw = {k: v for k, v in kwargs.items() if k != "backend"}
        fn = getattr(ops, name)
        out = fn(*args, backend="cuda", **kw)
        ref = fn(*args, backend="plain", **kw)
        err, share = model_held(out, ref, out.dtype)
        if not share <= 1.0:
            raise AssertionError(f"{what}: {name} call {i} on the model path's "
                                 f"inputs differs from plain by {err:.3e}, "
                                 f"{share:.3f} of its limit")
        worst = max(worst, share)
    return worst


def phase_serve(configs: dict, device="cuda") -> dict:
    """Each config of ``configs`` ({name: ArchConfig}) in float32, then
    bfloat16, with the port's seeded parameters: `Model.prefill` of SERVE_B
    x SERVE_T seeded tokens on `auto` (the kernels on the card), counted,
    every kernel call of it held again against the plain version on its
    own inputs, the whole prefill against `plain`; then `serve.generate`
    (the prompt stepped through decode_step, SERVE_GEN greedy tokens),
    counted, its last prompt-step logits against the prefill's; the model's
    floor (SERVE_NOISE); then SERVE_PREFILL_REPS timed prefills.  Peak
    memory is read over the decode loop and over the timed prefills.
    Everything under `torch.inference_mode()`."""
    from repro_torch.kernels import dispatch, ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.obs import metrics

    dev = torch.device(device)
    bk = dispatch.resolve_model(None, dev).value
    res = {}
    for name, arch in configs.items():
        for dtype in (torch.float32, torch.bfloat16):
            t_phase = time.perf_counter()
            dt = "f32" if dtype == torch.float32 else "bf16"
            model = Model(arch, dtype=dtype, device=dev)
            plain = Model(arch, dtype=dtype, device=dev, backend="plain")
            mixers = [sub.mixer for sub in model.program]
            kernels = {SERVE_KERNEL[m] for m in mixers if m in SERVE_KERNEL}
            if len(kernels) != 1:
                raise AssertionError(f"{name}: prefill runs {kernels}")
            (op, kernel), = kernels
            n_kernel = model.n_super * sum(m in SERVE_KERNEL for m in mixers)
            params = model.init(SEED)
            g = torch.Generator(device=dev).manual_seed(SEED + 1)
            toks = torch.randint(0, arch.vocab, (SERVE_B, SERVE_T), generator=g,
                                 device=dev)
            batch = {"tokens": toks}
            calls = []
            with torch.inference_mode():
                metrics.reset()
                ops.reset_launches()
                t0 = time.perf_counter()
                with tapped_model_ops(calls):
                    last = model.prefill(params, batch)
                sync(dev)
                first_ms = (time.perf_counter() - t0) * 1e3
                launches = dict(ops.LAUNCHES)
                if launches != {(kernel, bk): n_kernel}:
                    raise AssertionError(f"{name} {dt} prefill: launches "
                                         f"{launches} != {n_kernel} {kernel}")
                check_dispatches(launches)
                if len(calls) != n_kernel:
                    raise AssertionError(f"{name} {dt}: {len(calls)} calls "
                                         f"recorded, {n_kernel} launched")
                path_share = (hold_path_calls(calls, f"{name} {dt}")
                              if bk == "cuda" else 0.0)
                del calls
                ops.reset_launches()
                ref = plain.prefill(params, batch)
                if dict(ops.LAUNCHES) != {(kernel, "plain"): n_kernel}:
                    raise AssertionError(f"{name} {dt} plain prefill: "
                                         f"launches {dict(ops.LAUNCHES)}")
                vs_plain = max_share(last, ref)
                del ref
                gen = torch.Generator(device=dev).manual_seed(SEED + 2)
                floors = []
                for _ in range(SERVE_FLOOR_DRAWS):
                    with tapped_model_ops(noise=SERVE_NOISE, gen=gen):
                        floors.append(max_share(model.prefill(params, batch),
                                                  last))
            metrics.reset()
            ops.reset_launches()
            peak = PeakMemory(dev)
            out = serve.generate(model, params, toks, SERVE_GEN)
            peak_serve = peak.read()
            if dict(ops.LAUNCHES):
                raise AssertionError(f"{name} {dt} decode loop: launches "
                                     f"{dict(ops.LAUNCHES)} (decode is plain "
                                     f"torch)")
            check_dispatches({})
            vs_prefill = max_share(out["logits"], last)
            finite = bool(torch.isfinite(last).all()) and bool(
                torch.isfinite(out["last_logits"]).all())
            if not finite or tuple(last.shape) != (SERVE_B, arch.vocab):
                raise AssertionError(f"{name} {dt}: logits {tuple(last.shape)}"
                                     f", finite {finite}")
            floor = max(floors)
            tol = max(SERVE_TOL[dtype], SERVE_FLOOR_MARGIN * floor)
            if not (vs_plain <= tol and vs_prefill <= tol):
                raise AssertionError(f"{name} {dt}: cuda against plain "
                                     f"{vs_plain:.3e}, decode against prefill "
                                     f"{vs_prefill:.3e} (limit {tol:.3e}; "
                                     f"floor {floor:.3e})")
            prefill_ms = []
            peak = PeakMemory(dev)
            with torch.inference_mode():
                for _ in range(SERVE_PREFILL_REPS):
                    sync(dev)
                    t0 = time.perf_counter()
                    model.prefill(params, batch)
                    sync(dev)
                    prefill_ms.append((time.perf_counter() - t0) * 1e3)
            peak_prefill = peak.read()
            step_ms = [s * 1e3 for s in out["step_s"]]
            mean_ms = sum(prefill_ms) / len(prefill_ms)
            dec_ms = sum(step_ms) / len(step_ms)
            row = dict(
                launches={f"{kernel}/{bk}": n_kernel}, decode_launches=0,
                path_calls_limit_share=path_share,
                vs_plain=vs_plain, vs_prefill=vs_prefill, floor=floor,
                floors=floors, tol=tol,
                prefill_first_ms=first_ms, prefill_ms=mean_ms,
                prefill_ms_min=min(prefill_ms), prefill_ms_max=max(prefill_ms),
                prefill_tok_s=SERVE_B * SERVE_T / mean_ms * 1e3,
                prompt_stepped_s=out["prefill_s"],
                decode_ms=dec_ms, decode_ms_min=min(step_ms),
                decode_ms_max=max(step_ms),
                decode_tok_s=SERVE_B / dec_ms * 1e3,
                decode_tok_s_min=SERVE_B / max(step_ms) * 1e3,
                decode_tok_s_max=SERVE_B / min(step_ms) * 1e3,
                peak_prefill_bytes=peak_prefill, peak_serve_bytes=peak_serve,
                ids=[int(x) for x in out["ids"][0][:10]],
                seconds=time.perf_counter() - t_phase)
            res[f"{name}/{dt}"] = row
            log(f"serve {name} {dt} (B {SERVE_B}, prompt {SERVE_T}, gen "
                f"{SERVE_GEN}, {arch.n_layers} layers, d {arch.d_model}): "
                f"prefill launches {kernel}/{bk} {n_kernel}, decode loop 0; "
                f"each {kernel} call of the prefill against plain on its "
                f"inputs: {path_share:.3f} of its limit at most; last-token "
                f"logits cuda against plain {vs_plain:.3e}, decode-stepped "
                f"against prefill {vs_prefill:.3e}, limit {tol:.3e} of max "
                f"|logit| (the model's floor {floor:.3e}: "
                f"{[float(f'{f:.3e}') for f in floors]}); prefill ms "
                f"{mean_ms:.3f} (min {min(prefill_ms):.3f}, max "
                f"{max(prefill_ms):.3f}; first {first_ms:.3f}), "
                f"{row['prefill_tok_s']:.1f} tok/s; decode ms a token "
                f"{dec_ms:.3f} (min {min(step_ms):.3f}, max "
                f"{max(step_ms):.3f}), {row['decode_tok_s']:.1f} tok/s at "
                f"batch {SERVE_B} (min {row['decode_tok_s_min']:.1f}, max "
                f"{row['decode_tok_s_max']:.1f}); prompt stepped through "
                f"decode {out['prefill_s']:.2f} s; peak memory prefill "
                f"{peak_prefill / 2**30:.3f} GiB, serve "
                f"{peak_serve / 2**30:.3f} GiB; sample ids {row['ids']}; "
                f"{row['seconds']:.1f} s; nvidia-smi: "
                f"{nvidia_smi() if dev.type == 'cuda' else 'not measured'}")
            del model, plain, params, last, out
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return res


def serve_configs() -> dict:
    from repro_torch.configs import get_arch
    return {name: get_arch(name) for name in SERVE_ARCHS}


# ---------------------------------------------------------------------------
# phase 10: the LM training path
# ---------------------------------------------------------------------------
TRAIN_ARCHS = ("olmo-1b", "rwkv6-3b")    # configs/archs.py
# (c): full depth and width, bfloat16 parameters, float32 moments, remat on
TRAIN_BT = {"olmo-1b": (4, 1024), "rwkv6-3b": (2, 1024)}
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_TIMED = 10, 2, 3
# (b): full width, GRAD_LAYERS layers, float32, GRAD_B x GRAD_T tokens;
# every gradient leaf on cuda within GRAD_TOL of that leaf's max |g| on
# plain (the kernels' summation orders), the loss within LOSS_TOL relative
GRAD_LAYERS, GRAD_B, GRAD_T = 2, 2, 512
GRAD_TOL, LOSS_TOL = 1e-4, 1e-5
# (a): the Functions' gradients with the kernel forward against autograd
# through the plain version, of each input's max |g|: float32 the kernels'
# summation orders; bfloat16 the plain version's roundings inside its graph
# (q * scale and p to bfloat16), which autograd differentiates through
KGRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# K9's row statistics against the plain version's, relative: float32 the
# summation orders; bfloat16 rounds q * scale and the scores' products
# differ from the plain version's float32 matmul of the same bf16 values
STATS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
KGRAD_CASES = {
    # olmo-1b's heads (d 128, causal), T 2048
    "olmo-1b": dict(op="attention", B=1, H=16, T=2048, d=128, causal=True),
    # gemma2-9b's local layer: d 256, its window of 4096 (binding past
    # row 4096) and soft-cap 50
    "gemma2-9b-local": dict(op="attention", B=1, H=4, T=6144, d=256,
                            causal=True, window=4096, softcap=50.0),
    # rwkv6-3b's heads (K 64, 40 a token row), T 512
    "rwkv6-3b": dict(op="wkv6", B=1, H=40, T=512, d=64),
}


class RepeatedBatch:
    """A TokenDataset that gives its first batch at every step."""

    def __init__(self, ds):
        self.batch = ds.batch_at(0)

    def batch_at(self, step: int) -> dict:
        return self.batch


def phase_train_kernels() -> dict:
    """(a) K9's m and l against the plain version's at phase 6's attention
    shapes (the output with them bitwise the output without), and K9's time
    with and without them at olmo-1b's; each Function's gradients (kernel
    forward, plain backward) against autograd through the plain version at
    KGRAD_CASES; the plain backwards' times at phase (c)'s layer shapes."""
    from repro_torch.kernels import flash_attention, ops, wkv6
    from repro_torch.models import attention, rwkv

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    res = {"stats": {}, "grads": {}, "backward_ms": {}}
    for cname, case in MODEL_CASES.items():
        if case["op"] != "attention":
            continue
        opts = dict(causal=case["causal"], window=case.get("window"),
                    softcap=case.get("softcap"))
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            q, k, v = (torch.as_tensor(a).to(dev, dtype)
                       for a in model_inputs(case, SEED))
            out, m, l = flash_attention.flash_attention(q, k, v, stats=True, **opts)
            bitwise = torch.equal(out, flash_attention.flash_attention(q, k, v, **opts))
            _, pm, pl = flash_attention.flash_attention_plain(q, k, v, stats=True,
                                                              **opts)
            empty = pm == -1e30
            m_err = float((m - pm)[~empty].abs().max() / pm[~empty].abs().max())
            l_err = float(((l - pl) / pl).abs().max())
            row = dict(m_rel_err=m_err, l_rel_err=l_err, bitwise=bitwise,
                       empty_rows=int(empty.sum()),
                       empty_same=bool(torch.equal(m == -1e30, empty)))
            if not (bitwise and row["empty_same"] and m_err <= STATS_TOL[dtype]
                    and l_err <= STATS_TOL[dtype]):
                raise AssertionError(f"K9 stats {cname} {dt}: {row} (limit "
                                     f"{STATS_TOL[dtype]})")
            if cname == MODEL_TABLE_CASE["flash_attention"]:
                plain_ms = time_ms(lambda: flash_attention.flash_attention(
                    q, k, v, **opts), reps=5)
                stats_ms = time_ms(lambda: flash_attention.flash_attention(
                    q, k, v, stats=True, **opts), reps=5)
                BH, T = q.shape[0], q.shape[1]
                flops = model_flops(case)
                bound, by = bound_of(nbytes(q, k, v, out) + 8 * BH * T, flops,
                                     dtype)
                row.update(ms=plain_ms, ms_stats=stats_ms, bound_ms_stats=bound,
                           bound_by_stats=by)
            res["stats"][f"{cname}/{dt}"] = row
            log(f"K9 row statistics {cname} {dt} {tuple(q.shape)}: m within "
                f"{m_err:.3e}, l within {l_err:.3e} of the plain version's "
                f"(limit {STATS_TOL[dtype]:.0e}), {row['empty_rows']} rows with "
                f"no valid key at m = -1e30; output with stats bitwise the "
                f"output without: {bitwise}"
                + (f"; K9 ms {row['ms']:.4f} without, {row['ms_stats']:.4f} "
                   f"with m and l (bound {row['bound_ms_stats']:.4f}, "
                   f"{row['bound_by_stats']})" if "ms" in row else ""))
            del q, k, v, out, m, l, pm, pl
    for cname, case in KGRAD_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            arrs = [torch.as_tensor(a).to(dev, dtype)
                    for a in model_inputs(case, SEED + 1)]
            if case["op"] == "wkv6":
                H = case["H"]
                arrs[4] = (0.5 * torch.randn(H, case["d"], generator=torch.Generator(
                    device=dev).manual_seed(SEED), device=dev)).to(dtype)
                fn = lambda *a: rwkv.WKV6.apply(*a, "cuda")
                plain = wkv6.wkv6_plain
                kernel = "wkv6"
            else:
                opts = dict(causal=case["causal"], window=case.get("window"),
                            softcap=case.get("softcap"))
                fn = lambda q, k, v: attention.FlashAttention.apply(
                    q, k, v, opts["causal"], opts["window"], opts["softcap"], "cuda")
                plain = lambda q, k, v: flash_attention.flash_attention_plain(
                    q, k, v, **opts)
                kernel = "flash_attention"
            g = torch.Generator(device=dev).manual_seed(SEED + 2)
            dout = torch.randn(arrs[2].shape, generator=g, device=dev).to(dtype)
            got = [a.clone().requires_grad_() for a in arrs]
            ops.reset_launches()
            fn(*got).backward(dout)
            torch.cuda.synchronize()
            if dict(ops.LAUNCHES) != {(kernel, "cuda"): 1}:
                raise AssertionError(f"{cname} {dt}: launches {dict(ops.LAUNCHES)}")
            want = [a.clone().requires_grad_() for a in arrs]
            plain(*want).backward(dout)
            errs = {n: max_share(a.grad, b.grad)
                    for n, a, b in zip("qkv" if kernel != "wkv6" else "rkvwu",
                                       got, want)}
            res["grads"][f"{cname}/{dt}"] = errs
            log(f"{kernel} Function gradients {cname} {dt} "
                f"{tuple(arrs[0].shape)}: kernel forward + plain backward "
                f"against autograd through the plain version, of max |g|: "
                + ", ".join(f"d{n} {e:.3e}" for n, e in errs.items())
                + f" (limit {KGRAD_TOL[dtype]:.0e})")
            if not max(errs.values()) <= KGRAD_TOL[dtype]:
                raise AssertionError(f"{kernel} Function {cname} {dt}: {errs}")
            del arrs, got, want, dout
            torch.cuda.empty_cache()
    # the plain backwards at (c)'s layer shapes: olmo-1b's attention in
    # bfloat16 (B 4, T 1024), rwkv6-3b's WKV (float32 heads, B 2, T 1024)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rnd = lambda *s, dtype=torch.bfloat16: (0.3 * torch.randn(
        *s, generator=gen, device=dev)).to(dtype)
    B, T = TRAIN_BT["olmo-1b"]
    q, k, v, do = (rnd(B * 16, T, 128) for _ in range(4))
    out, m, l = flash_attention.flash_attention(q, k, v, causal=True, stats=True)
    res["backward_ms"]["olmo-1b attention"] = time_ms(
        lambda: attention.flash_attention_bwd(q, k, v, out, m, l, do, True),
        reps=3)
    res["backward_ms"]["olmo-1b attention forward"] = time_ms(
        lambda: flash_attention.flash_attention(q, k, v, causal=True, stats=True),
        reps=3)
    del q, k, v, do, out, m, l
    B, T = TRAIN_BT["rwkv6-3b"]
    f32 = torch.float32
    r, kk, vv, do = (rnd(B * 40, T, 64, dtype=f32) for _ in range(4))
    w = torch.exp(-torch.exp(rnd(B * 40, T, 64, dtype=f32) - 1.0))
    u = rnd(40, 64, dtype=f32)
    xs = [t.requires_grad_() for t in (r, kk, vv, w, u)]
    fwd_ms = time_ms(lambda: rwkv.WKV6.apply(*xs, "cuda"), reps=3)
    both_ms = time_ms(lambda: torch.autograd.grad(
        rwkv.WKV6.apply(*xs, "cuda"), xs, do), reps=3)
    res["backward_ms"]["rwkv6-3b wkv"] = both_ms - fwd_ms
    res["backward_ms"]["rwkv6-3b wkv forward"] = fwd_ms
    log("plain backwards at phase 10's layer shapes (a layer, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["backward_ms"].items()))
    del r, kk, vv, w, u, do, xs
    torch.cuda.empty_cache()
    return res


def phase_train_grads(configs: dict, device="cuda") -> dict:
    """(b) Each config at GRAD_LAYERS layers (full width, heads, vocab) in
    float32: `value_and_grad(Model.loss)` of GRAD_B x GRAD_T seeded tokens
    on `auto` (the kernels on the card, counted) and on `plain`, every leaf
    held to GRAD_TOL of its max |g|, the loss to LOSS_TOL."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.kernels import dispatch, ops
    from repro_torch.models.model import Model, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    bk = dispatch.resolve_model(None, dev).value
    res = {}
    for name, full in configs.items():
        arch = dataclasses.replace(full, n_layers=GRAD_LAYERS)
        model = Model(arch, dtype=torch.float32, device=dev)
        plain = Model(arch, dtype=torch.float32, device=dev, backend="plain")
        params = model.init(SEED)
        g = torch.Generator(device=dev).manual_seed(SEED + 4)
        toks = torch.randint(0, arch.vocab, (GRAD_B, GRAD_T + 1), generator=g,
                             device=dev)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        ops.reset_launches()
        loss, grads = value_and_grad(model.loss, params, batch)
        sync(dev)
        launches = dict(ops.LAUNCHES)
        ops.reset_launches()
        ref_loss, ref = value_and_grad(plain.loss, params, batch)
        errs = {T.keystr(p): max_share(a, b) for (p, a), b in
                zip(T.flatten_with_path(grads), T.leaves(ref))}
        worst = max(errs, key=errs.get)
        loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        res[name] = dict(loss=float(loss), loss_plain=float(ref_loss),
                         loss_rel_err=loss_err, worst_leaf=worst,
                         worst=errs[worst], leaves=len(errs), launches={
                             f"{k[0]}/{k[1]}": n for k, n in launches.items()})
        log(f"gradients {name} ({GRAD_LAYERS} layers, d {arch.d_model}, vocab "
            f"{arch.vocab}, f32, B {GRAD_B} x T {GRAD_T}) on {bk} against "
            f"plain: loss {float(loss):.6f} vs {float(ref_loss):.6f} (rel "
            f"{loss_err:.3e}, limit {LOSS_TOL:.0e}); {len(errs)} leaves, worst "
            f"{worst} at {errs[worst]:.3e} of its max |g| (limit "
            f"{GRAD_TOL:.0e}); launches {res[name]['launches']}")
        if not (loss_err <= LOSS_TOL and errs[worst] <= GRAD_TOL):
            raise AssertionError(f"{name} gradients: {res[name]}")
        del model, plain, params, grads, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


def train_kernels_per_step(model) -> dict:
    """The kernel launches one training step should make: each attention
    (K9) and RWKV (K8) sub-layer once forward and, under remat, once more in
    its recompute."""
    per = 2 if model.arch.remat else 1
    kernels = {"attn": "flash_attention", "rwkv": "wkv6"}
    out = {}
    for sub in model.program:
        if sub.mixer in kernels:
            key = kernels[sub.mixer]
            out[key] = out.get(key, 0) + per * model.n_super
    return out


def phase_train(configs: dict, device="cuda") -> dict:
    """(c) Each config at full depth: bfloat16 parameters, float32 moments,
    remat as the config has it (on), TRAIN_STEPS AdamW steps of
    `launch.train`'s train step (in place: one copy of the model state)
    through `TrainRunner` on one repeated TokenDataset batch.  Every step's
    launches must be `train_kernels_per_step`'s; the last loss below the
    first; steps TRAIN_WARMUP .. TRAIN_WARMUP + TRAIN_TIMED - 1 timed (a
    device synchronise at each end); peak memory over the run.  The runner
    gets no retries: an in-place step changes the state it would restore."""
    import tempfile
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.kernels import dispatch, ops
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import Model, count_params
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import RunnerConfig, TrainRunner

    dev = torch.device(device)
    bk = dispatch.resolve_model(None, dev).value
    res = {}
    for name, arch in configs.items():
        t_phase = time.perf_counter()
        B, T = TRAIN_BT[name]
        model = Model(arch, dtype=torch.bfloat16, device=dev)
        total, _ = count_params(model)
        want = {(k, bk): n for k, n in train_kernels_per_step(model).items()}
        params = model.init(SEED)
        state = (params, adamw.init(params))
        ds = RepeatedBatch(TokenDataset(vocab=arch.vocab, seq_len=T,
                                        global_batch=B, seed=SEED, device=dev))
        step = make_train_step(model, adamw.AdamWConfig(), inplace=True)
        losses, step_ms, launches = [], [], []

        def step_fn(state, batch):
            ops.reset_launches()
            sync(dev)
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(ops.LAUNCHES))
            losses.append(float(loss))
            return state, {"loss": loss}

        peak = PeakMemory(dev)
        with tempfile.TemporaryDirectory() as ckpt:
            runner = TrainRunner(step_fn, ds, RunnerConfig(
                checkpoint_dir=ckpt, checkpoint_every=TRAIN_STEPS + 1,
                max_retries=0))
            runner.run(state, n_steps=TRAIN_STEPS, resume=False)
        peak_bytes = peak.read()
        bad = [i for i, n in enumerate(launches) if n != want]
        timed = step_ms[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_TIMED]
        ms = sum(timed) / len(timed)
        row = dict(params=total, B=B, T=T, layers=arch.n_layers,
                   remat=arch.remat, losses=losses,
                   launches_per_step={f"{k[0]}/{k[1]}": n for k, n in want.items()},
                   step_ms=step_ms, ms=ms, ms_min=min(timed), ms_max=max(timed),
                   tok_s=B * T / ms * 1e3, peak_bytes=peak_bytes,
                   runner_steps=runner.stats["steps"],
                   seconds=time.perf_counter() - t_phase)
        res[name] = row
        log(f"train {name} ({arch.n_layers} layers, d {arch.d_model}, "
            f"{total / 1e9:.3f} B params, bf16 params, f32 moments, remat "
            f"{arch.remat}, B {B} x T {T}, "
            f"{TRAIN_STEPS} AdamW steps through TrainRunner on one repeated "
            f"batch): losses {[round(x, 4) for x in losses]}; launches a step "
            f"{row['launches_per_step']} (predicted; steps that differ: {bad}); "
            f"ms a step {ms:.2f} (steps {TRAIN_WARMUP + 1}-"
            f"{TRAIN_WARMUP + TRAIN_TIMED}: min {min(timed):.2f}, max "
            f"{max(timed):.2f}; first {step_ms[0]:.2f}), {row['tok_s']:.1f} "
            f"tok/s; peak memory {peak_bytes / 2**30:.3f} GiB; "
            f"{row['seconds']:.1f} s; nvidia-smi: "
            f"{nvidia_smi() if dev.type == 'cuda' else 'not measured'}")
        if bad:
            raise AssertionError(f"{name}: steps {bad} launched "
                                 f"{[launches[i] for i in bad]}, not {want}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]
                and runner.stats["steps"] == TRAIN_STEPS):
            raise AssertionError(f"{name}: losses {losses}, runner "
                                 f"{runner.stats}")
        del model, params, state, ds, runner
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


def phase_train_launcher() -> dict:
    """(d) `python -m repro_torch.launch.train --arch olmo-1b --reduced
    --steps 20` on the card (no --device), which must exit 0."""
    import tempfile
    with tempfile.TemporaryDirectory() as ckpt:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "olmo-1b", "--reduced", "--steps", "20", "--ckpt", ckpt],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
        seconds = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-3:]
    log(f"launch.train --arch olmo-1b --reduced --steps 20: exit "
        f"{proc.returncode} in {seconds:.1f} s; {' | '.join(tail)}")
    if proc.returncode != 0:
        raise AssertionError(f"launch.train exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return dict(exit=proc.returncode, seconds=seconds, tail=tail)


def train_configs() -> dict:
    from repro_torch.configs import get_arch
    return {name: get_arch(name) for name in TRAIN_ARCHS}


def phase_training() -> dict:
    """Phase 10: (a) the kernels' training pieces, (b) full-width
    gradients against plain, (c) full-depth training, (d) the launcher."""
    t0 = time.perf_counter()
    res = dict(kernels=phase_train_kernels(),
               grads=phase_train_grads(train_configs()),
               train=phase_train(train_configs()),
               launcher=phase_train_launcher())
    log(f"train: phase 10 in {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 11: the LM mesh path, ranks sharing the card
# ---------------------------------------------------------------------------
MESH_SHAPE = (2, 2)       # ("data", "model"): 4 ranks, every one on cuda:0
# steps of each model: rwkv6-3b's take 30-50 s on these ranks (NVIDIA H100),
# so it runs 2 (one to warm up, one timed) to keep the whole script inside
# its 1,200 s; olmo-1b runs 3 (5, 2 of them warm-up, until phase 13 needed
# the time: m_last, v_last and update are still read after more than one
# step), its first MESH_WARMUP steps not timed either
MESH_STEPS = {"olmo-1b": 3, "rwkv6-3b": 2}
MESH_WARMUP = {"olmo-1b": 1, "rwkv6-3b": 1}
MESH_TIMEOUT_S = 900
# What the mesh run is held to, against the single-device cuda steps from
# the same parameters and batch (bfloat16 parameters and activations, the
# sums in other orders and shapes), each reading within its MESH_BASE
# limit or twice the model's own floor where that is more (phase 9's rule;
# `mesh_floor`: the single-device steps again with every kernel output
# perturbed by MESH_FLOOR_NOISE, half a bfloat16 ulp, the rounding each of
# the mesh's bfloat16 partial sums adds):
# - loss: each step's loss, relative; the first step's (the same
#   parameters) within MESH_LOSS1;
# - m1, v1: the float32 moments of every leaf after the first step (m =
#   0.1 g, v = 0.05 g^2: the gradient itself), the largest element error
#   over the leaf's max: m within KGRAD_TOL[bf16] (the limit phase 10 (a)
#   holds the kernels' bfloat16 gradients to against plain), v within
#   twice that (|g1^2 - g2^2| <= 2 |g1 - g2| max |g|);
# - m_last, v_last: the same after the last step, where the two runs'
#   parameters have parted too;
# - update: each leaf's parameters after the last step, the norm of their
#   difference over the norm of the single-device run's change (a mesh that
#   left a leaf unchanged reads 1, one that flipped its updates 2).  An
#   element-wise limit on the parameters cannot tell a fault: AdamW moves
#   an element by about lr a step whatever its gradient's size, so an
#   element whose gradient is rounding noise parts by 2 lr a step on a
#   sound mesh, as far as any fault can take it.
# The limits of m_last, v_last and update are about twice olmo-1b's
# readings on a sound mesh after 5 steps (NVIDIA H100: 7.02e-2, 0.110,
# 0.103); the run now takes 3.  Planted
# faults fail them: half the batch on each data rank reads 0.7-1.0 in
# olmo-1b's m1; the parameters left unchanged (moments updated) 1.0 in its
# update; u's gradient not summed over the data axis 0.85 in rwkv6-3b's
# `bonus` m1, against twice its floor, 0.56.
MESH_FLOOR_NOISE = 2.0 ** -9
MESH_BASE = {"loss": 1e-2,
             "m1": KGRAD_TOL[torch.bfloat16], "v1": 2 * KGRAD_TOL[torch.bfloat16],
             "m_last": 0.15, "v_last": 0.25, "update": 0.25}
# The first step's loss: olmo-1b's reads 1.823e-5 on a sound mesh; rwkv6-3b's
# 9.487e-4, 3.2 times its floor (2.977e-4; the floor perturbs K8's outputs
# alone, the mesh every tensor-parallel projection's partial sums), and a
# fault that changes the forward (half the batch) reads 4.1e-4 in
# olmo-1b's: in rwkv6-3b the moments, not the loss, tell a fault.
MESH_LOSS1 = {"olmo-1b": 1e-4, "rwkv6-3b": 2e-3}
# The readings each model holds.  The single-device leaves stay on the card
# (the ranks read them through CUDA IPC; copying rwkv6-3b's 52 GB to the
# host took 141 s), and beside rwkv6-3b's four ranks there is room for
# one float32 copy of its parameters: m after step 1 (0.1 g, which also
# fixes v1 = 0.05 g^2).  Its later readings sit at its floor on a sound
# mesh, as far as a fault's (at 3 steps: m3 0.9-1.2 of a leaf's max,
# update 0.8-0.9).
MESH_HELD = {"olmo-1b": ("m1", "v1", "m_last", "v_last", "update"),
             "rwkv6-3b": ("m1",)}


def mesh_tags(name: str, steps: int) -> tuple:
    """{step: the moments held after it} and whether the parameters are."""
    out = {}
    for t in MESH_HELD[name]:
        if t != "update":
            s = 1 if t[1:] == "1" else steps
            out.setdefault(s, []).append(t[0])
    return out, "update" in MESH_HELD[name]


def mesh_piece(whole: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard, at ``placements`` on ``mesh``, of ``whole``, a
    copy on the card."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(whole.shape, mesh,
                                                       placements)
    return whole[tuple(slice(o, o + n) for o, n in zip(off, shape))].to("cuda")


def mesh_leaf_errs(leaves, ref: list) -> list:
    """Each DTensor leaf's largest element difference, on this rank's
    shard, from the single-device leaf in ``ref``."""
    out = []
    for d, whole in zip(leaves, ref):
        piece = mesh_piece(whole, d.device_mesh, d.placements)
        out.append(float((d.to_local().float() - piece.float()).abs().max()))
        del piece
    return out


def mesh_rank(rank: int, n_ranks: int, run: dict) -> dict:
    """One rank of phase 11, a process on cuda:0 over the staged gloo group:
    `launch.train`'s layout of ``run["arch"]`` on the mesh (bfloat16
    parameters from SEED, as phase 10's), ``run["steps"]`` in-place AdamW
    steps of the repeated batch, each timed between barriers with its
    kernel launches, the (B*H) rows of each kernel call and the staged
    collectives.  The first step's kernel calls are held once more against
    plain on their own inputs (not counted).  After the first and the last
    step the rank's shards of m and v, and after the last its parameters,
    are held against the single-device run's leaves in ``run["ref"]``
    (`mesh_reference`'s, on the card, read through CUDA IPC), as
    `mesh_tags` says."""
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.distributed import staged
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import MeshSpec, make_mesh
    from repro_torch.models import sharding
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    # the only reference to the parent's leaves: they are released (to the
    # parent's `torch.cuda.ipc_collect`) when this function returns
    ref = run.pop("ref")
    snaps, hold_p = mesh_tags(run["arch"].name, run["steps"])
    mesh = make_mesh(MeshSpec(MESH_SHAPE, ("data", "model")), "cuda")
    model = Model(run["arch"], dtype=torch.bfloat16, device="cuda")
    peak = PeakMemory(torch.device("cuda"))
    # each rank draws the whole seeded tree and keeps its shards; one rank
    # at a time, so that only one whole tree is on the card at once
    for r in range(n_ranks):
        if r == rank:
            params = sharding.distribute(model.init(SEED), ttrain.mesh_layout(
                model, mesh, n_ranks), mesh)
            torch.cuda.empty_cache()
        dist.barrier()
    state = (params, adamw.init(params))
    B, Tn = run["BT"]
    ds = ttrain.MeshBatches(TokenDataset(vocab=model.arch.vocab, seq_len=Tn,
                                         global_batch=B, seed=SEED,
                                         device="cuda"), model, mesh)
    batch = ds.batch_at(0)
    step = ttrain.make_train_step(model, adamw.AdamWConfig(), inplace=True)
    rows, losses, ms, launches, staged_steps = [], [], [], [], []
    moment_errs, held_share = {}, None
    for s in range(1, run["steps"] + 1):
        calls = []
        ops.reset_launches()
        staged.reset_counts()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tapped_model_ops(calls):
            state, loss = step(state, batch)
        torch.cuda.synchronize()
        dist.barrier()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        launches.append({f"{k[0]}/{k[1]}": n for k, n in ops.LAUNCHES.items()})
        staged_steps.append(dict(staged.COUNTS))
        rows += [(name, int(a[0].shape[0])) for name, a, _ in calls]
        if s == 1:
            with torch.no_grad():
                held_share = hold_path_calls(
                    [(n, tuple(a.detach() if torch.is_tensor(a) else a
                                for a in args), kw)
                     for n, args, kw in calls],
                    f"mesh {run['arch'].name} rank {rank}")
        del calls
        for kind in snaps.get(s, ()):
            moment_errs[f"{kind}{s}"] = mesh_leaf_errs(
                T.leaves(getattr(state[1], kind)), ref[f"{kind}{s}"])
    peak_bytes = peak.read()
    on_card = all((t.to_local() if hasattr(t, "to_local") else t).is_cuda
                  for t in T.leaves(state))
    p_max, p_sq = [], []
    for d, whole in zip(T.leaves(state[0]), ref["p"] if hold_p else ()):
        diff = d.to_local().float() - mesh_piece(
            whole, d.device_mesh, d.placements).float()
        # replicated shards are held by several ranks: count each once
        copies = int(np.prod([mesh.size(j) for j, pl in enumerate(d.placements)
                              if not pl.is_shard()]))
        p_max.append(float(diff.abs().max()))
        p_sq.append(float(torch.linalg.vector_norm(diff, dtype=torch.float64)
                          ** 2) / copies)
        del diff
    return dict(rank=rank, losses=losses, ms=ms, launches=launches,
                rows=sorted(set(rows)), n_rows=len(rows), staged=staged_steps,
                peak_bytes=peak_bytes, on_card=on_card, held_share=held_share,
                moment_errs=moment_errs, p_max=p_max, p_sq=p_sq,
                local_params=sum(t.to_local().numel() for t in T.leaves(state[0])))


def card_block(shapes: list, dtype) -> list:
    """Empty tensors of ``shapes`` on the card, views of one allocation."""
    sizes = [math.prod(s) for s in shapes]
    block = torch.empty(sum(sizes), dtype=dtype, device="cuda")
    return [v.view(s) for v, s in zip(block.split(sizes), shapes)]


def share_of(err: float, scale: float) -> float:
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def single_steps(arch, BT, steps: int, noise: float = 0.0):
    """Phase 10's in-place step of ``arch`` (bfloat16, float32 moments) from
    SEED on the repeated batch, on one device: yields (step, state, loss,
    ms) after each step.  With ``noise`` every kernel output is multiplied
    by (1 + noise N(0, 1)) (`tapped_model_ops`, seeded)."""
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    model = Model(arch, dtype=torch.bfloat16, device="cuda")
    params = model.init(SEED)
    state = (params, adamw.init(params))
    B, Tn = BT
    batch = TokenDataset(vocab=arch.vocab, seq_len=Tn, global_batch=B,
                         seed=SEED, device="cuda").batch_at(0)
    step = make_train_step(model, adamw.AdamWConfig(), inplace=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with (tapped_model_ops(noise=noise, gen=gen) if noise
          else contextlib.nullcontext()):
        for s in range(1, steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            yield s, state, float(loss), (time.perf_counter() - t0) * 1e3


def mesh_reference(name: str, arch, BT, steps: int) -> dict:
    """The single-device cuda steps phase 11 is held to (`single_steps`).
    Returns the losses, ms a step, ``held``: copies on the card of each
    leaf's float32 moments after the steps `mesh_tags` names (``m1``: m
    after step 1, ``v5``: v after step 5) and of its parameters after the
    last step (``p``), with each moment leaf's max (``maxes``), each leaf's
    name and the norm of its change over the steps."""
    from repro_torch import tree as T
    from repro_torch.models.model import Model
    snaps, hold_p = mesh_tags(name, steps)
    # each held set in one block, taken before the run: copies made into
    # the allocator's segments in mid-run would keep them all reserved
    # (35.6 GiB for rwkv6-3b's 11.5 GB of m, with no room left for its ranks)
    gc.collect()
    torch.cuda.empty_cache()
    shapes = [x.shape for x in T.leaves(Model(arch, dtype=torch.bfloat16,
                                               device="meta").init_abstract())]
    held = {f"{k}{s}": card_block(shapes, torch.float32)
            for s, kinds in snaps.items() for k in kinds}
    if hold_p:
        held["p"] = card_block(shapes, torch.bfloat16)
    losses, ms, maxes = [], [], {}
    for s, state, loss, t in single_steps(arch, BT, steps):
        losses.append(loss)
        ms.append(t)
        for kind in snaps.get(s, ()):
            leaves = T.leaves(getattr(state[1], kind))
            for dst, x in zip(held[f"{kind}{s}"], leaves):
                dst.copy_(x)
            maxes[f"{kind}{s}"] = [float(x.abs().max()) for x in leaves]
        if s == steps:
            names = [T.keystr(p) for p, _ in T.flatten_with_path(state[0])]
            if hold_p:
                for dst, x in zip(held["p"], T.leaves(state[0])):
                    dst.copy_(x)
    del state
    change = []
    if hold_p:
        start = T.leaves(Model(arch, dtype=torch.bfloat16,
                               device="cuda").init(SEED))
        change = [float(torch.linalg.vector_norm(p.float() - p0.float(),
                                                 dtype=torch.float64))
                  for p, p0 in zip(held["p"], start)]
        del start
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, ms=ms, maxes=maxes, names=names,
                change=change, held=held)


def mesh_floor(name: str, arch, BT, steps: int, ref: dict) -> dict:
    """Phase 9's floor, for phase 11: the single-device steps again, as far
    as the last held reading, with every kernel output multiplied by (1 +
    MESH_FLOOR_NOISE N(0, 1)); each reading of `mesh_readings` taken of
    this run against ``ref``'s: how far a sound perturbation of the size of
    the mesh's bfloat16 roundings parts two runs of this model, leaf by
    leaf, and each step's loss."""
    from repro_torch import tree as T
    snaps, hold_p = mesh_tags(name, steps)
    last = steps if hold_p else max(snaps)
    out = {"loss": []}
    for s, state, loss, _ in single_steps(arch, BT, last,
                                          noise=MESH_FLOOR_NOISE):
        want = ref["losses"][s - 1]
        out["loss"].append(abs(loss - want) / abs(want))
        for kind in snaps.get(s, ()):
            tag = f"{kind}{s}"
            out[tag] = [share_of(float((x - h).abs().max()), mx)
                        for x, h, mx in zip(T.leaves(getattr(state[1], kind)),
                                            ref["held"][tag], ref["maxes"][tag])]
        if s == steps and hold_p:
            out["update"] = [share_of(float(torch.linalg.vector_norm(
                x.float() - h.float(), dtype=torch.float64)), c)
                for x, h, c in zip(T.leaves(state[0]), ref["held"]["p"],
                                   ref["change"])]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_readings(ranks: list, ref: dict) -> dict:
    """Each leaf's readings over the ranks: every snapshot's moment error
    as a share of the single-device leaf's max, and the parameters' error
    norm over the single-device change (and the largest element error)."""
    out = {}
    for tag, maxes in ref["maxes"].items():
        out[tag] = [share_of(max(r["moment_errs"][tag][i] for r in ranks), m)
                    for i, m in enumerate(maxes)]
    if ref["change"]:
        out["update"] = [share_of(sum(r["p_sq"][i] for r in ranks) ** 0.5, c)
                         for i, c in enumerate(ref["change"])]
        out["p_max"] = [max(r["p_max"][i] for r in ranks)
                        for i in range(len(ref["change"]))]
    return out


def mesh_limits(tag: str, floor: list) -> list:
    """Each leaf's limit for reading ``tag``: MESH_BASE's, or twice the
    model's own floor where that is more (phase 9's rule)."""
    base = MESH_BASE[tag if tag == "update" else
                     tag[0] + ("1" if tag[1:] == "1" else "_last")]
    return [max(base, 2 * f) for f in floor]


def phase_mesh(configs: dict) -> dict:
    """Phase 11: each config trained on a MESH_SHAPE mesh of ranks that
    share the card (`launch.train --mesh`'s layout, DTensor leaves, the
    staged gloo group), MESH_STEPS of its steps, against the single-device
    cuda steps from the same parameters and batch (`mesh_reference`), beside
    the model's own floor (`mesh_floor`).  Every rank must launch K9 / K8
    as the single-device step does, each call on the rank's own rows (B /
    data) times heads (H / model), and the first step's calls must agree
    with plain on their inputs; the losses, moments and parameters are
    held as MESH_BASE's comment says.  Every config runs before a failure
    is raised.  These ranks time-share one card and stage their
    all-gathers through the host: the times are a record of this path, not
    a scaling figure."""
    from repro_torch.distributed import spawn
    from repro_torch.models.model import Model

    res, failures = {}, []
    for name, arch in configs.items():
        t_phase = time.perf_counter()
        BT = TRAIN_BT[name]
        model = Model(arch, dtype=torch.bfloat16, device="meta")
        want_launches = {f"{k}/cuda": n for k, n in
                         train_kernels_per_step(model).items()}
        heads = (arch.d_model // arch.rwkv.head_dim if arch.rwkv
                 else arch.n_heads)
        op = "wkv6" if arch.rwkv else "attention"
        data, tp = MESH_SHAPE
        want_rows = [(op, BT[0] // data * heads // tp)]
        steps = MESH_STEPS[name]
        t0 = time.perf_counter()
        ref = mesh_reference(name, arch, BT, steps)
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        floor = mesh_floor(name, arch, BT, steps, ref)
        floor_s = time.perf_counter() - t0
        log(f"mesh {name}: one device's {steps} steps in {ref_s:.1f} s, the "
            f"floor's {len(floor['loss'])} in {floor_s:.1f} s; the parent keeps "
            f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved on the "
            f"card")
        t0 = time.perf_counter()
        ranks = spawn.run(mesh_rank, data * tp, timeout_s=MESH_TIMEOUT_S,
                          device="cuda", args=(dict(
                              arch=arch, BT=BT, steps=steps,
                              ref=ref["held"]),))
        wall = time.perf_counter() - t0
        del ref["held"]
        gc.collect()
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        read = mesh_readings(ranks, ref)
        read["loss"] = [abs(a - b) / abs(b) for a, b in
                        zip(ranks[0]["losses"], ref["losses"])]
        limits = {k: mesh_limits(k, floor[k]) for k in floor if k != "loss"}
        # the floor's run stops at the last held reading; later losses keep
        # their base limit
        limits["loss"] = [max(MESH_LOSS1[name] if s == 0 else MESH_BASE["loss"],
                              2 * f) for s, f in enumerate(floor["loss"])]
        limits["loss"] += [MESH_BASE["loss"]] * (steps - len(limits["loss"]))
        names = ref["names"]
        # each reading's worst leaf (or step, for the loss) by its share of
        # its limit
        worst = {}
        for k, lim in limits.items():
            i = max(range(len(lim)), key=lambda j: read[k][j] / lim[j])
            worst[k] = dict(at=i + 1 if k == "loss" else names[i],
                            value=read[k][i],
                            floor=floor[k][i] if i < len(floor[k]) else None,
                            limit=lim[i], of_limit=read[k][i] / lim[i])
        slowest = [max(r["ms"][i] for r in ranks) for i in range(steps)]
        timed = slowest[MESH_WARMUP[name]:]
        ms = float(np.mean(timed))
        staged_last = ranks[0]["staged"][-1]
        held_share = max(r["held_share"] for r in ranks)
        row = dict(
            shape=MESH_SHAPE, B=BT[0], T=BT[1], layers=arch.n_layers,
            steps=steps, losses=ranks[0]["losses"], ref_losses=ref["losses"],
            loss_rel_errs=read["loss"], floor_loss=floor["loss"], worst=worst,
            leaves={n: {k: v[i] for k, v in read.items() if k != "loss"}
                    for i, n in enumerate(names)},
            floor_leaves={n: {k: v[i] for k, v in floor.items() if k != "loss"}
                          for i, n in enumerate(names)},
            path_calls_limit_share=held_share,
            ms_slowest=slowest, ms=ms, tok_s=BT[0] * BT[1] / ms * 1e3,
            ref_ms=ref["ms"], launches_per_rank_step=ranks[0]["launches"][-1],
            rows=ranks[0]["rows"],
            heads_per_call=want_rows[0][1] // (BT[0] // data),
            launches_mesh=sum(sum(st.get(k, 0) for st in r["launches"])
                              for r in ranks for k in want_launches),
            staged_per_step=staged_last,
            peak_bytes=[r["peak_bytes"] for r in ranks],
            local_params=[r["local_params"] for r in ranks],
            wall_s=wall, seconds=time.perf_counter() - t_phase)
        res[name] = row
        for r in ranks:
            log(f"mesh {name} rank {r['rank']}: launches a step "
                f"{r['launches'][-1]}, kernel calls {r['n_rows']} on rows "
                f"{r['rows']}, step 1's against plain at "
                f"{r['held_share']:.3f} of their limit at most, step ms "
                f"{[round(t, 1) for t in r['ms']]}, staged a step "
                f"{r['staged'][-1]}, peak memory "
                f"{r['peak_bytes'] / 2**30:.3f} GiB, {r['local_params']} "
                f"parameter elements held")
        for i, n in enumerate(names):
            log(f"mesh {name} leaf {n}: reading (floor) " + ", ".join(
                f"{k} {read[k][i]:.4e} ({floor[k][i]:.4e})" for k in floor
                if k != "loss") + (f", p_max {read['p_max'][i]:.4e}"
                                   if "p_max" in read else ""))
        log(f"mesh {name} ({arch.n_layers} layers, d {arch.d_model}, bf16 "
            f"params, f32 moments, remat {arch.remat}, B {BT[0]} x T "
            f"{BT[1]}, mesh {MESH_SHAPE} of ranks sharing the card): losses "
            f"{[round(x, 4) for x in ranks[0]['losses']]} against one "
            f"device's {[round(x, 4) for x in ref['losses']]} (rel "
            f"{[float(f'{e:.3e}') for e in read['loss']]}, the floor's "
            f"{[float(f'{e:.3e}') for e in floor['loss']]}); each reading's "
            f"worst against its limit (moments: of the leaf's max; update: "
            f"error norm over the change): {worst}; {op} {want_rows[0][1]} "
            f"rows a call ({row['heads_per_call']} heads of {heads} a rank); "
            f"step 1's kernel calls against plain {held_share:.3f} of their "
            f"limit at most; ms a step on the slowest rank, steps "
            f"{MESH_WARMUP[name] + 1}-{steps}: {ms:.1f} ({row['tok_s']:.1f} "
            f"tok/s; one device "
            f"{float(np.mean(ref['ms'][MESH_WARMUP[name]:])):.1f} ms), "
            f"every step {[round(t, 1) for t in slowest]}; staged a step "
            f"{staged_last}; {wall:.1f} s with spawn; four ranks time-share "
            f"one card: not a scaling figure; nvidia-smi: {nvidia_smi()}")
        checks = {
            **{k: w["of_limit"] <= 1.0 for k, w in worst.items()},
            "on the card": all(r["on_card"] for r in ranks),
            f"launches {want_launches} a step": all(
                st == want_launches for r in ranks for st in r["launches"]),
            f"rows {want_rows}": all(r["rows"] == want_rows for r in ranks),
            "finite": bool(np.isfinite(ranks[0]["losses"]).all())}
        failures += [f"{name}: {k}" for k, ok in checks.items() if not ok]
        del ranks, ref
        gc.collect()
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"mesh: {failures}: "
                             f"{ {n: r['worst'] for n, r in res.items()} }")
    return res


# ---------------------------------------------------------------------------
# phase 12: the ocean dry run on fake groups of the production meshes
# ---------------------------------------------------------------------------
DRYRUN_CELLS = ("benchmark", "benchmark-ca2")
# rank 0's n_own and n_loc by (cell, ranks): the port's build_partition at
# the halo depth DistributedOcean gives each cell, max(1, 3 * period)
DRYRUN_SIZES = {("benchmark", 256): (820, 913), ("benchmark", 512): (410, 493),
                ("benchmark-ca2", 256): (820, 1399),
                ("benchmark-ca2", 512): (410, 881)}
DRYRUN_TIMED = 3            # timed rank steps after the counted one
# the ops of the step's kernels, and the positions of their data operands
# (the rest is the geometry or the system's matrix): phase 12 holds each
# call also with these replaced by seeded normals, since the cells start at
# rest, where much of what the kernels get is zero or uniform
DRYRUN_FREE = {"solve_r": (1, 2), "solve_w": (1, 2), "block_thomas": (1,),
               "lateral_flux_term": (1, 2, 3), "tridiag": (3,)}


@contextlib.contextmanager
def tapped_ocean_ops(calls: list, limit: int):
    """While active, the first ``limit`` calls of the step's kernel ops
    (`ops.<op>` of DRYRUN_FREE, which the step calls through the module)
    append (op, args, kwargs) to ``calls``; nothing is copied or launched,
    so a traced step counts the same."""
    from repro_torch.kernels import ops
    orig = {name: getattr(ops, name) for name in DRYRUN_FREE}

    def wrap(name, fn):
        def call(*args, **kwargs):
            if len(calls) < limit:
                calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return call
    try:
        for name, fn in orig.items():
            setattr(ops, name, wrap(name, fn))
        yield
    finally:
        for name, fn in orig.items():
            setattr(ops, name, fn)


def block_residual(lo, dg, up, rhs, x) -> float:
    """The componentwise backward error of ``x`` as a solution of the
    block-tridiagonal system (lo, dg, up) x = rhs, in the kernel's layout
    (blocks (nl, 6, 6, nt), rhs and x (k, nl, 6, nt); lo[0], up[-1] unread):
    max |A x - rhs| / (|A| |x| + |rhs|), in float64.  A backward-stable
    solve keeps it near the dtype's rounding unit however ill-conditioned
    A is, where its distance to another solver's result grows with A's
    condition number."""
    lo, dg, up, rhs, x = (t.double() for t in (lo, dg, up, rhs, x))

    def apply(lo, dg, up, x):
        ax = torch.einsum("limc,klmc->klic", dg, x)
        ax[:, 1:] += torch.einsum("limc,klmc->klic", lo[1:], x[:, :-1])
        ax[:, :-1] += torch.einsum("limc,klmc->klic", up[:-1], x[:, 1:])
        return ax
    r = (apply(lo, dg, up, x) - rhs).abs()
    scale = apply(lo.abs(), dg.abs(), up.abs(), x.abs()) + rhs.abs()
    return float((r / scale.clamp_min(torch.finfo(torch.float64).tiny)).max())


def hold_ocean_calls(calls: list, what: str, gen) -> dict:
    """Each recorded call once more through the kernel and the plain
    version (not counted), on its own operands and then with its
    DRYRUN_FREE operands replaced by seeded normals.  K7 must equal plain
    bitwise; K3, a solver, must keep its backward error (`block_residual`)
    within TOL, and its distances to plain and to the float64 solution
    are printed; K1, K2 and K4 are held to plain, on their own operands
    as phase 3 holds them (`held`), on seeded ones within TOL of max
    |plain| (their results can be far below 1).  Returns {op: the worst
    of each reading}."""
    from repro_torch.kernels import ops
    worst = {}
    for i, (name, args, kwargs) in enumerate(calls):
        kw = {k: v for k, v in kwargs.items() if k != "backend"}
        fn = getattr(ops, name)
        seeded = list(args)
        for j in DRYRUN_FREE[name]:
            if j < len(seeded) and isinstance(seeded[j], torch.Tensor):
                x = seeded[j]
                seeded[j] = torch.randn(x.shape, generator=gen, dtype=x.dtype,
                                        device=x.device)
        row = worst.setdefault(name, {"calls": 0})
        row["calls"] += 1
        for k, a in enumerate((args, seeded)):
            out = fn(*a, backend="cuda", **kw)
            ref = fn(*a, backend="plain", **kw)
            torch.cuda.synchronize()
            on = ("own", "seeded")[k]
            tag = f"{what}: {name} call {i} on {on} operands"
            err = float((out - ref).abs().max())
            read = {f"err_{on}": err}
            if name == "tridiag":
                if not torch.equal(out, ref):
                    raise AssertionError(f"{tag}: not bitwise equal to plain "
                                         f"(max_abs_err {err:.3e})")
            elif name == "block_thomas":
                blocks, rhs = a
                x64 = fn(tuple(b.double() for b in blocks), rhs.double(),
                         backend="plain")
                top = float(x64.abs().max()) or 1.0
                read.update({
                    f"backward_{on}": block_residual(*blocks, rhs, out),
                    f"backward_plain_{on}": block_residual(*blocks, rhs, ref),
                    f"vs_f64_{on}": float((out.double() - x64).abs().max()) / top,
                    f"vs_f64_plain_{on}": float((ref.double() - x64).abs().max())
                    / top})
                if not read[f"backward_{on}"] <= TOL[out.dtype]:
                    raise AssertionError(
                        f"{tag}: backward error {read[f'backward_{on}']:.3e} > "
                        f"{TOL[out.dtype]:.0e} (plain's "
                        f"{read[f'backward_plain_{on}']:.3e}; max_abs_err "
                        f"against plain {err:.3e})")
            elif k == 0:
                held(out, ref, out.dtype, tag)
            else:
                scale = float(ref.abs().max())
                if not err <= TOL[out.dtype] * scale:
                    raise AssertionError(f"{tag}: max_abs_err {err:.3e} > "
                                         f"{TOL[out.dtype]:.0e} * {scale:.3e}")
                read[f"err_{on}"] = err / scale
            for key, v in read.items():
                row[key] = max(row.get(key, 0.0), v)
    return worst


def dryrun_checks(rec: dict) -> dict:
    """{check: passed} of one dry-run record (see phase 12)."""
    from repro_torch.distributed import halo
    from repro_torch.launch.ocean_dryrun import OCEAN_CELLS
    cell = OCEAN_CELLS[rec["arch"][len("ocean-"):]]
    part, hlo = rec["partition"], rec["hlo"]
    period = cell.halo_exchange_period
    shifts = halo.shifts_per_step(len(part["offsets"]), period, cell.m_2d)
    moved = halo.bytes_per_step(part["msg"], period, cell.nl, 4, cell.m_2d)
    sizes = DRYRUN_SIZES[(cell.name, rec["chips"])]
    return {
        f"exchanges {shifts} a step": hlo["n_collectives"] == shifts,
        f"halo bytes {moved} a step": hlo["coll_bytes"] == moved,
        f"launches {PER_STEP}": {k: v["launches"] for k, v in
                                 rec["kernels"].items()} == PER_STEP,
        f"n_own, n_loc {sizes}": (part["n_own"], part["n_loc"]) == sizes}


def phase_dryrun() -> dict:
    """Phase 12: the ocean dry run on the card and, for one record, on the
    CPU; every record held by `dryrun_checks`, every kernel call of the
    card's traced steps by `hold_ocean_calls`, the card's bytes and flops
    against the CPU's; the card's state finite, its distance to the CPU's
    printed beside the CPU's own across backends."""
    from repro_torch import tree as T
    from repro_torch.launch import dryrun, ocean_dryrun
    from repro_torch.launch.mesh import production_spec
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    recs, states, holds = {}, {}, {}
    for multi in (False, True):
        spec = production_spec(multi_pod=multi)
        for name in DRYRUN_CELLS:
            key, calls = (name, spec.size, "cuda"), []
            # the warm-up step's calls: their operands, kept until the
            # holds, are part of the allocation the counted step starts
            # from, so the record's peak does not count them
            with tapped_ocean_ops(calls, sum(PER_STEP.values())):
                recs[key], states[key] = ocean_dryrun.trace_ocean(
                    name, spec, device="cuda", time_steps=DRYRUN_TIMED,
                    return_state=True)
            holds[key] = hold_ocean_calls(calls, f"dryrun {name}@{spec.size}",
                                          gen)
            shown = {op: {k: float(f"{v:.3g}") for k, v in r.items()}
                     for op, r in holds[key].items()}
            log(f"dryrun {name}@{spec.size}:cuda: {len(calls)} kernel calls "
                f"held (K1, K2, K4's err_seeded over max|plain|; K3's "
                f"backward errors, and its distances to the f64 solution "
                f"over its max): {shown}")
            del calls
    key = ("benchmark", 256, "cpu")
    recs[key], states[key] = ocean_dryrun.trace_ocean(
        "benchmark", production_spec(), device="cpu", return_state=True)
    _, ref_state = ocean_dryrun.trace_ocean(
        "benchmark", production_spec(), device="cpu", backend="ref",
        return_state=True)
    state_diffs = {}
    for (path, a), b, c in zip(
            T.flatten_with_path(states[("benchmark", 256, "cuda")]),
            T.leaves(states[key]), T.leaves(ref_state)):
        leaf = T.keystr(path)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"dryrun benchmark@256: {leaf} non-finite "
                                 f"on the card")
        scale = max(float(b.abs().max()), 1.0)
        state_diffs[leaf] = [float((a.cpu() - b).abs().max()) / scale,
                             float((b - c).abs().max()) / scale]
    shown = {k: [float(f"{v:.3e}") for v in d] for k, d in state_diffs.items()}
    log(f"dryrun benchmark@256: state after the counted step, finite on the "
        f"card; [cuda vs cpu, cpu plain vs cpu ref] over max(|cpu|, 1), "
        f"printed, not held (f32 with faked exchanges does not reproduce "
        f"across summation orders; the kernels are held call by call): "
        f"{shown}")
    del states, ref_state
    failures, res = [], {"state_vs_cpu": state_diffs}
    for (name, ranks, dev), rec in recs.items():
        key = f"{name}@{ranks}:{dev}"
        checks = dryrun_checks(rec)
        failures += [f"{key}: {c}" for c, ok in checks.items() if not ok]
        r, mem, hlo = rec["roofline"], rec["memory"], rec["hlo"]
        log(f"dryrun {key}{dryrun.summary(rec)}")
        log(f"dryrun {key}: n_own {rec['partition']['n_own']}, n_loc "
            f"{rec['partition']['n_loc']}, {len(rec['partition']['offsets'])} "
            f"ring offsets; peak {mem['peak_per_device']} B, arguments "
            f"{mem['argument_bytes']} B; hlo.bytes {hlo['bytes']:.0f}, "
            f"hlo.flops {hlo['flops']:.0f}, coll_bytes {hlo['coll_bytes']:.0f}, "
            f"n_collectives {hlo['n_collectives']}; compute_s "
            f"{r['compute_s']:.6g}, memory_s {r['memory_s']:.6g}, "
            f"collective_s {r['collective_s']:.6g} (latency "
            f"{r['coll_latency_s']:.6g}), dominant {r['dominant']}; "
            f"launches { {k: v['launches'] for k, v in rec['kernels'].items()} }; "
            f"{rec['n_ops']} eager ops; checks "
            f"{'all held' if all(checks.values()) else checks}")
        if "step_ms" in rec:
            ms = rec["step_ms"]
            log(f"dryrun {key}: one rank, no communication (exchanges faked, "
                f"not a scaling figure): {[round(t, 3) for t in ms]} ms a "
                f"step, mean {np.mean(ms):.3f}, against roofline memory_s "
                f"{r['memory_s'] * 1e3:.4f} ms, {rec['n_ops']} eager ops a "
                f"step; card {rec.get('card')}")
        res[key] = {k: rec[k] for k in (
            "partition", "n_ops", "kernels", "hlo", "roofline", "trace_s",
            "build_s", "device")} | {
            "memory": {k: v for k, v in rec["memory"].items()
                       if k != "arguments"},
            "step_ms": rec.get("step_ms"), "card": rec.get("card"),
            "held_calls": holds.get((name, ranks, dev))}
    card, cpu = recs[("benchmark", 256, "cuda")], recs[("benchmark", 256, "cpu")]
    for f in ("bytes", "flops"):
        if card["hlo"][f] != cpu["hlo"][f]:
            failures.append(f"benchmark@256 hlo.{f}: cuda {card['hlo'][f]} "
                            f"against cpu {cpu['hlo'][f]}")
    log(f"dryrun: phase 12 in {time.perf_counter() - t0:.1f} s; cuda and cpu "
        f"hlo.bytes {card['hlo']['bytes']:.0f} / {cpu['hlo']['bytes']:.0f}, "
        f"hlo.flops {card['hlo']['flops']:.0f} / {cpu['hlo']['flops']:.0f}; "
        f"nvidia-smi: {nvidia_smi()}")
    if failures:
        raise AssertionError(f"dryrun: {failures}")
    res["launches"] = {k: sum(rec["kernels"][k]["launches"]
                              for (_, _, dev), rec in recs.items()
                              if dev == "cuda") for k in PER_STEP}
    return res


# ---------------------------------------------------------------------------
# phase 13: the LM dry run on a fake group of the production mesh
# ---------------------------------------------------------------------------
LMDRY_CELLS = (("olmo-1b", "train_4k"), ("olmo-1b", "prefill_32k"),
               ("rwkv6-3b", "prefill_32k"), ("rwkv6-3b", "decode_32k"))
LMDRY_HELD = ("olmo-1b", "train_4k")     # the card's record against the CPU's
LMDRY_REPS = 5                           # timed launches of each call
LMDRY_CPU = r"""
import json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import lm_dryrun
from repro_torch.launch.mesh import production_spec
rec = lm_dryrun.trace_cell(sys.argv[2], sys.argv[3], production_spec(),
                           device="cpu")
with open(sys.argv[4], "w") as f:
    json.dump(rec, f)
"""


def start_lm_cpu_trace(src: str) -> tuple:
    """The CPU trace of LMDRY_HELD at (16, 16), in a subprocess on one
    thread: (the process, the file its record goes to)."""
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json", prefix="lmdry_cpu_")
    os.close(fd)
    proc = subprocess.Popen([sys.executable, "-c", LMDRY_CPU, src,
                             *LMDRY_HELD, path], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, path


def finish_lm_cpu_trace(job: tuple) -> dict:
    proc, path = job
    out, _ = proc.communicate(timeout=900)
    try:
        if proc.returncode:
            raise AssertionError(f"lm dryrun: the CPU trace failed "
                                 f"(rc {proc.returncode}): {out[-3000:]}")
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def lm_call_operands(name: str, call: dict, gen) -> list:
    """Seeded operands on the card for one recorded call of K9 (q, k, v
    ~ 0.3 N) or K8 (r, k, v, u ~ 0.5 N, w = exp(-exp(0.5 N - 1))), at its
    local shapes and dtype (phase 6's recipes)."""
    dt = getattr(torch, call["dtype"])
    n = lambda s: torch.randn(s, generator=gen, device="cuda")
    shapes = [tuple(s) for s in call["shapes"]]
    if name == "flash_attention":
        return [(0.3 * n(s)).to(dt) for s in shapes]
    r, k, v, w, u = shapes
    return [(0.5 * n(r)).to(dt), (0.5 * n(k)).to(dt), (0.5 * n(v)).to(dt),
            torch.exp(-torch.exp(0.5 * n(w) - 1.0)).to(dt),
            (0.5 * n(u)).to(dt)]


def lm_call_fns(name: str, call: dict, args: list) -> tuple:
    """(the call through `ops` on `auto`, on plain, the kernel's wrapper
    alone) of one recorded call."""
    from repro_torch.kernels import flash_attention, ops, wkv6
    if name == "wkv6":
        return (lambda: ops.wkv6(*args), lambda: ops.wkv6(*args, backend="plain"),
                lambda: wkv6.wkv6(*args))
    causal, window, softcap, stats = call["options"]
    fn = ops.attention_with_stats if stats else ops.attention
    kw = dict(causal=causal, window=window, softcap=softcap)
    return (lambda: fn(*args, **kw), lambda: fn(*args, backend="plain", **kw),
            lambda: flash_attention.flash_attention(*args, stats=stats, **kw))


def phase_lm_dryrun(cpu_job: tuple) -> dict:
    """Phase 13 (see the module docstring): the card's traces, the held
    record against the CPU's, and every recorded K9 / K8 call run, held and
    timed at the rank's shapes."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun, lm_dryrun
    from repro_torch.launch.mesh import production_spec
    from repro_torch.roofline import kernels as rk
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    recs = {}
    for arch, shape in LMDRY_CELLS:
        recs[(arch, shape)] = rec = lm_dryrun.trace_cell(
            arch, shape, production_spec(), device="cuda")
        hlo, mem = rec["hlo"], rec["memory"]
        log(f"lm dryrun {arch} {shape}@256:cuda{dryrun.summary(rec)}")
        log(f"lm dryrun {arch} {shape}@256:cuda: peak {mem['peak_per_device']} "
            f"B, arguments {mem['argument_bytes']} B; hlo.bytes "
            f"{hlo['bytes']:.0f}, hlo.flops {hlo['flops']:.0f}; collectives "
            f"{hlo['n_collectives']}, bytes by kind {hlo['coll_by_kind']}; "
            f"bytes by source { {k: float(f'{v:.4g}') for k, v in hlo['bytes_by_source'].items()} }; "
            f"kernel calls { {k: v['calls'] for k, v in rec['kernels'].items()} }; "
            f"{rec['n_ops']} ops; card {rec.get('card')}")
    cpu = finish_lm_cpu_trace(cpu_job)
    card = recs[LMDRY_HELD]
    failures = [f"{'/'.join(LMDRY_HELD)} {key}: cuda {a} against cpu {b}"
                for key, a, b in (
                    ("hlo.bytes", card["hlo"]["bytes"], cpu["hlo"]["bytes"]),
                    ("hlo.flops", card["hlo"]["flops"], cpu["hlo"]["flops"]),
                    ("argument bytes", card["memory"]["argument_bytes"],
                     cpu["memory"]["argument_bytes"]))
                if a != b]
    log(f"lm dryrun {'/'.join(LMDRY_HELD)}@256: cuda / cpu hlo.bytes "
        f"{card['hlo']['bytes']:.0f} / {cpu['hlo']['bytes']:.0f}, hlo.flops "
        f"{card['hlo']['flops']:.0f} / {cpu['hlo']['flops']:.0f}, arguments "
        f"{card['memory']['argument_bytes']} / {cpu['memory']['argument_bytes']}")
    if failures:
        raise AssertionError(f"lm dryrun: {failures}")
    calls = {}
    for (arch, shape), rec in recs.items():
        for name, k in rec["kernels"].items():
            for call in k["shapes"]:
                key = (name, json.dumps([call["shapes"], call["dtype"],
                                         call["options"]]))
                calls.setdefault(key, dict(call, kernel=name, cells=[]))
                calls[key]["cells"].append(f"{arch}/{shape}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    operands = {key: lm_call_operands(key[0], call, gen)
                for key, call in calls.items()}
    # each call once through `ops` on `auto`: the launches of this run
    dispatch.reset_launches()
    outs = {key: lm_call_fns(key[0], call, operands[key])[0]()
            for key, call in calls.items()}
    torch.cuda.synchronize()
    launches = {k: dispatch.LAUNCHES[(k, "cuda")]
                for k in ("flash_attention", "wkv6")}
    if not all(launches.values()):
        raise AssertionError(f"lm dryrun: a kernel of the path was not "
                             f"launched: {launches}")
    rows = []
    for key, call in calls.items():
        name, args, out = key[0], operands.pop(key), outs.pop(key)
        _, plain, kernel = lm_call_fns(name, call, args)
        ref = plain()
        pick = lambda o: o[0] if isinstance(o, tuple) else o
        err, share = model_held(pick(out), pick(ref), pick(out).dtype)
        if not share <= 1.0:
            raise AssertionError(f"lm dryrun {name} {call['shapes'][0]} "
                                 f"{call['dtype']} {call['options']}: differs "
                                 f"from plain by {err:.3e}, {share:.3f} of "
                                 f"its limit")
        cost = rk.COST[name](*args, *call["options"])
        dt = getattr(torch, call["dtype"])
        bound, by = bound_of(cost.bytes, cost.flops, dt)
        ms = time_ms(kernel, reps=LMDRY_REPS)
        library = None
        if name == "flash_attention" and call["options"][1:3] == [None, None]:
            # SDPA computes the same output (not m, l) at the same shapes
            q, k, v = (t[None] for t in args)
            library = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=call["options"][0]), reps=LMDRY_REPS)
        rows.append(dict(kernel=name, shapes=call["shapes"], dtype=call["dtype"],
                         options=call["options"], cells=call["cells"],
                         calls_a_step=call["calls"], max_abs_err=err,
                         limit_share=share, ms=ms, bound_ms=bound, bound_by=by,
                         bound_share=bound / ms, bytes=cost.bytes,
                         flops=cost.flops, library_ms=library))
        log(f"lm dryrun {name} {call['shapes'][0]} {call['dtype']} options "
            f"{call['options']} (cells {call['cells']}, {call['calls']} calls a "
            f"step): max_abs_err vs plain {err:.3e} ({share:.3f} of its "
            f"limit); {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"{bound / ms:.3f} of the bound; SDPA "
            f"{'n/a' if library is None else f'{library:.4f} ms'}")
        del args, out, ref
    log(f"lm dryrun: phase 13 in {time.perf_counter() - t0:.1f} s; {len(rows)} "
        f"distinct kernel calls at the rank's shapes; launches {launches}; "
        f"nvidia-smi: {nvidia_smi()}")
    res = {"/".join(c): {k: rec[k] for k in ("hlo", "roofline", "n_ops",
                                             "kernels", "trace_s", "options")}
           | {"memory": {k: v for k, v in rec["memory"].items()
                         if k != "arguments"}}
           for c, rec in recs.items()}
    res["calls"] = rows
    res["launches"] = launches
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k7-only", action="store_true",
                    help="only time K7 at the main path's shape (k7_only)")
    ap.add_argument("--k7-depths", action="store_true",
                    help="only sweep K7's variants over depths (k7_depths)")
    ap.add_argument("--campaign-only", action="store_true",
                    help="only build and run phase 7 (phase_campaign)")
    ap.add_argument("--distributed-only", action="store_true",
                    help="only build and run phase 8 (phase_distributed)")
    ap.add_argument("--serve-only", action="store_true",
                    help="only build and run phase 9 (phase_serve)")
    ap.add_argument("--train-only", action="store_true",
                    help="only build and run phase 10 (phase_training)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="only build and run phase 11 (phase_mesh)")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="only build and run phase 12 (phase_dryrun)")
    ap.add_argument("--lm-dryrun-only", action="store_true",
                    help="only build and run phase 13 (phase_lm_dryrun)")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding repro_torch (default: ./src)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import cuda_lib

    if args.k7_only or args.k7_depths:
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}")
        cuda_lib.build()
        rows = (k7_only(2 * NX * (NX // 2), NL, SEED) if args.k7_only
                else k7_depths(2 * NX * (NX // 2), SEED))
        print(json.dumps({"src": args.src, "rows": rows}))
        print(nvidia_smi())
        return 0

    if args.campaign_only:
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}")
        cuda_lib.build()
        res = phase_campaign(float("nan"))
        print(json.dumps({"campaign": {k: v for k, v in res.items()
                                       if k != "launches"}}))
        print(nvidia_smi())
        return 0

    if args.distributed_only:
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}")
        cuda_lib.build()
        print(json.dumps({"distributed": phase_distributed()}))
        print(nvidia_smi())
        return 0

    if args.serve_only:
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}")
        cuda_lib.build()
        t0 = time.perf_counter()
        serve_res = phase_serve(serve_configs())
        log(f"serve: phase 9 in {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"serve": serve_res}))
        print(nvidia_smi())
        return 0

    if args.train_only:
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}")
        cuda_lib.build()
        train_res = phase_training()
        print(json.dumps({"train": train_res}))
        print(nvidia_smi())
        return 0

    if args.mesh_only:
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}")
        cuda_lib.build()
        t0 = time.perf_counter()
        mesh_res = phase_mesh(train_configs())
        log(f"mesh: phase 11 in {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"mesh": mesh_res}))
        print(nvidia_smi())
        return 0

    if args.dryrun_only:
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}")
        cuda_lib.build()
        print(json.dumps({"dryrun": phase_dryrun()}))
        print(nvidia_smi())
        return 0

    if args.lm_dryrun_only:
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}")
        cpu_job = start_lm_cpu_trace(args.src)
        cuda_lib.build()
        print(json.dumps({"lm_dryrun": phase_lm_dryrun(cpu_job)}))
        print(nvidia_smi())
        return 0

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind}; count {torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    so = cuda_lib.build()
    cuda_lib.library()
    log(f"build: {so.name} in {time.perf_counter() - t0:.1f}s "
        f"({' '.join(cuda_lib.NVCC_FLAGS)})")
    report = cuda_lib.ptxas_report()
    ptxas = ptxas_summary(report)
    for variant, info in sorted(ptxas.items()):
        log(f"ptxas {variant}: {info}")
    for line in sorted({ln.strip() for ln in report.splitlines()
                        if "wgmma" in ln.lower() or "setmaxnreg" in ln}):
        log(f"ptxas note: {line}")
    check_ptxas(ptxas)
    sass, tool = sass_counts(so)
    for variant, counts in sorted(sass.items()):
        log(f"sass {variant} ({tool}): {counts}")
    check_sass(sass)
    # phase 13's CPU trace, on one thread beside the phases on the card
    lm_cpu_job = start_lm_cpu_trace(args.src)

    # 3. kernels at the main path's shapes
    kres = phase_kernels(2 * NX * (NX // 2), NL, SEED)
    kres.update(phase_block_thomas(2 * NX * (NX // 2), NL, SEED, ptxas))
    kres.update(phase_tridiag(2 * NX * (NX // 2), NL, SEED, ptxas, sass))

    # 4. main path: float32 (the run the kernel table's launches come from),
    # then float64, where every field is held to TOL_PATH
    mres = phase_main_path(torch.float32)
    mres64 = phase_main_path(torch.float64)

    # 5. the observed step, float64
    phase_observed()

    # 5b. the paper's GBR case, float64
    gbr = phase_gbr(smi)

    # 6. the model kernels at the LM configs' widths
    model = phase_model(ptxas)

    # 7. the resilient campaign, float64, against phase 4's bare step
    campaign = phase_campaign(mres64["ms_per_step"])

    # 8. the distributed step, ranks sharing the card, float64
    dist_res = phase_distributed()
    print(json.dumps({"distributed": dist_res}))

    # 9. the LM serving path, olmo-1b and rwkv6-3b at full width and depth
    t0 = time.perf_counter()
    serve_res = phase_serve(serve_configs())
    log(f"serve: phase 9 in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"serve": serve_res}))

    # 10. the LM training path: the kernels' training pieces, full-width
    # gradients, olmo-1b and rwkv6-3b trained at full depth, the launcher
    train_res = phase_training()
    print(json.dumps({"train": train_res}))

    # 11. the LM mesh path: olmo-1b and rwkv6-3b on a 2 x 2 mesh of ranks
    # that share the card, against the single-device step
    t0 = time.perf_counter()
    mesh_res = phase_mesh(train_configs())
    log(f"mesh: phase 11 in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"mesh": mesh_res}))

    # 12. the ocean dry run: rank 0 of the benchmark cells on fake groups
    # of the production meshes, on the card and on the CPU
    dryrun_res = phase_dryrun()
    print(json.dumps({"dryrun": dryrun_res}))

    # 13. the LM dry run: olmo-1b and rwkv6-3b cells on a fake group of the
    # (16, 16) mesh, and their kernels' calls at the rank's shapes
    lm_res = phase_lm_dryrun(lm_cpu_job)
    print(json.dumps({"lm_dryrun": lm_res}))

    table = []
    for name, label in TABLE_CASE.items():
        r32, r64 = kres[(name, label, "f32")], kres[(name, label, "f64")]
        table.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=mres["launches"][(name, "cuda")],
            max_abs_err=r32["max_abs_err"], ms=r32["ms"],
            plain_ms=r32["plain_ms"], bound_ms=r32["bound_ms"],
            bound_by=r32["bound_by"], library_ms=r32["library_ms"],
            dtype="float32", shape=r32["shape"], case=label,
            ms_f64=r64["ms"], bound_ms_f64=r64["bound_ms"],
            plain_ms_f64=r64["plain_ms"], library_ms_f64=r64["library_ms"],
            max_abs_err_f64=r64["max_abs_err"]))
        if name in PER_STEP:
            # the launches of phase 5b's 3 counted GBR steps, of phase
            # 7's fault-free campaign leg (CAMPAIGN_STEPS steps) and of
            # phase 8's ranks (every rank of both runs, DIST_STEPS each)
            table[-1]["launches_gbr"] = gbr["launches"][(name, "cuda")]
            table[-1]["launches_campaign"] = campaign["launches"][(name, "cuda")]
            table[-1]["launches_distributed"] = sum(
                row["launches_per_rank"][name] * row["ranks"]
                for row in dist_res.values())
            # phase 12's counted steps on the card, one a record
            table[-1]["launches_dryrun"] = dryrun_res["launches"][name]
        if name == "block_thomas":
            # the plan's tile, the narrower ones and the global variant
            # at the main path's shape, and the deep case
            table[-1].update(
                variant=r32["variant"], tc=r32["tc"], smem=r32["smem"],
                ptxas=r32["ptxas"], tiles_per_sm=r32["tiles_per_sm"],
                ms_global=r32["ms_global"], tc_f64=r64["tc"],
                smem_f64=r64["smem"], ptxas_f64=r64["ptxas"],
                tiles_per_sm_f64=r64["tiles_per_sm"],
                ms_global_f64=r64["ms_global"],
                cases={"f32": {"tiles": r32["tiles"], "deep": r32["deep"]},
                       "f64": {"tiles": r64["tiles"], "deep": r64["deep"]}})
        if name == "tridiag":
            # every case: each variant at the main path's shape, the ragged
            # nt, the deep columns; bitwise, with registers and SASS counts
            table[-1].update(
                variant=r32["plan"]["variant"], smem=r32["plan"]["smem"],
                prof_ms=r32["prof_ms"], prof_ms_f64=r64["prof_ms"],
                primed_ms=r32["primed_ms"], primed_ms_f64=r64["primed_ms"],
                host_us=r32["host_us"], host_us_f64=r64["host_us"],
                ptxas=r32["ptxas"], ptxas_f64=r64["ptxas"],
                cases={"f32": r32["cases"], "f64": r64["cases"]})
        if name in COPY_KERNELS:
            # every K5 / K6 case: the vector one above, the scalar ones
            cases = {}
            for (n, lab, dt), r in kres.items():
                if n == name:
                    cases.setdefault(lab, {})[dt] = {k: r.get(k) for k in (
                        "variant", "ms", "prof_ms", "primed_ms", "graph_ms",
                        "host_us", "bound_ms", "library_ms", "library_prof_ms",
                        "library_primed_ms", "library_graph_ms", "plain_ms",
                        "max_abs_err", "shape")}
            table[-1]["cases"] = cases
            table[-1]["sass"] = {v: n for v, n in sass.items()
                                 if v.startswith(name)}
    for row in model_rows(model, serve_res, train_res, mesh_res):
        if row["name"] == "flash_attention":
            row["sass"] = sass
        # phase 13's calls at the dry run's (16, 16) rank shapes
        row["launches_lm_dryrun"] = lm_res["launches"][row["name"]]
        table.append(row)
    print(json.dumps({"kernels": table}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
