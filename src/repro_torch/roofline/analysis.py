"""Roofline terms from one rank's traffic, on a machine model (the JAX
package's `roofline/analysis.py`, less its HLO parser).

The JAX package derives a rank's FLOPs, bytes and collective bytes from the
compiled SPMD program's HLO and divides them by TPU v5e constants.  The
port has no compiled program: its dry run (`launch/ocean_dryrun.py`)
counts them while one rank's eager step runs, into the same `HloStats`
record, so `roofline_from_stats` and `rederive` read either framework's
record.  The machine is an argument:

  compute    = FLOPs / peak[dtype]
  memory     = bytes / HBM bytes/s
  collective = coll_bytes / link bytes/s + n_collectives * latency

(per rank, as JAX's; the totals in `Roofline` are over ``chips``).

`model_flops_estimate` sets an LM cell's useful FLOPs
(`launch/lm_dryrun.py`).  `HloStats.add`, `peak_bandwidth` and
`CPU_MEM_BW` have no caller in the package (the port traces a step as one
program); `tests/test_torch_roofline.py` holds each to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Union

import torch

DtypeLike = Union[str, torch.dtype]

# JAX's HLO names of the dtypes a peak is given for
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float32: "f32", torch.float64: "f64"}


def dtype_name(dtype: DtypeLike) -> str:
    """``"bf16"``, ``"f32"``, ... of a torch dtype or of such a name."""
    return dtype if isinstance(dtype, str) else _DTYPE_NAMES[dtype]


@dataclasses.dataclass(frozen=True)
class Machine:
    """One device's peaks: FLOP/s by dtype name, HBM bytes/s, interconnect
    bytes/s a direction, and seconds a collective (launch, sync and first
    hop)."""
    name: str
    peak_flops: Mapping[str, float]
    hbm_bytes_per_s: float
    link_bytes_per_s: float
    collective_latency_s: float

    def peak(self, dtype: DtypeLike) -> float:
        name = dtype_name(dtype)
        if name not in self.peak_flops:
            raise KeyError(f"{self.name} has no {name} peak; it has "
                           f"{sorted(self.peak_flops)}")
        return self.peak_flops[name]


# The JAX package's constants (`roofline/analysis.py:34-43`): one TPU v5e
# chip, ICI link, and its 2 us model of a collective's dispatch and first
# hop.  Here to hold the port's roofline to JAX's, never a figure of the port.
TPU_V5E = Machine("TPU_V5E", {"bf16": 197e12, "f32": 98.5e12},
                  hbm_bytes_per_s=819e9, link_bytes_per_s=50e9,
                  collective_latency_s=2e-6)

# One NVIDIA H100 SXM (NVIDIA's data sheet: dense, no sparsity; the
# numbers behind PERF.md's kernel bounds): 3.35 TB/s HBM3, 989 TFLOP/s
# bf16 / fp16 on the tensor cores, 67 / 34 TFLOP/s f32 / f64 outside them.
# The link and latency are NOT measured (no run here has a second card):
# NVLink 4's published 450 GB/s a direction, and the paper's ~7.5 us a
# synchronisation, communication and launch on A100 + InfiniBand (§3.3).
H100_SXM = Machine("H100_SXM",
                   {"bf16": 989e12, "f16": 989e12, "f32": 67e12, "f64": 34e12},
                   hbm_bytes_per_s=3.35e12, link_bytes_per_s=450e9,
                   collective_latency_s=7.5e-6)

MACHINES = {m.name: m for m in (TPU_V5E, H100_SXM)}

# the host-memory model of the CPU containers (JAX's CPU_MEM_BW): benches
# on the CPU report achieved-against-bound on it
CPU_MEM_BW = 50e9

# JAX's source tags for byte attribution (`analysis.py:81`), in its order:
# a byte goes to the first tag that names its source
SOURCE_TAGS = ("wkv", "flash_attention", "mamba", "_ssm_scan", "moe_apply",
               "block_thomas", "solve_r", "solve_w", "gls_step",
               "run_external", "horizontal_advdiff", "adamw", "logsumexp")


def peak_bandwidth(device_type: str) -> float:
    """Memory-bandwidth bound (bytes/s) of a device type: ``cuda`` the
    H100's HBM, ``tpu`` the v5e's, anything else the CPU host model."""
    if device_type == "cuda":
        return H100_SXM.hbm_bytes_per_s
    if device_type == "tpu":
        return TPU_V5E.hbm_bytes_per_s
    return CPU_MEM_BW


@dataclasses.dataclass
class HloStats:
    """A rank's program: FLOPs, bytes, collective wire bytes (all-reduce
    counted twice), their count, and the bytes by source tag."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    bytes_by_source: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def add_bytes(self, b: float, tag: str):
        self.bytes += b
        self.bytes_by_source[tag] = self.bytes_by_source.get(tag, 0.0) + b

    def add(self, o: "HloStats", f: float = 1.0, include_bytes: bool = True):
        self.flops += f * o.flops
        self.coll_bytes += f * o.coll_bytes
        self.n_collectives += int(f * o.n_collectives)
        for k, v in o.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + f * v
        if include_bytes:
            self.bytes += f * o.bytes
            for k, v in o.bytes_by_source.items():
                self.bytes_by_source[k] = self.bytes_by_source.get(k, 0.0) \
                    + f * v


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float      # bandwidth term + latency term
    flops: float
    bytes: float
    coll_bytes: float
    chips: int
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    coll_bw_s: float = 0.0
    coll_latency_s: float = 0.0
    n_collectives: int = 0
    # the compute peak the terms were taken at (not a field of the record)
    peak_flops: float = dataclasses.field(default=H100_SXM.peak("bf16"),
                                          repr=False)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Simple no-overlap upper bound = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """Useful model throughput vs peak at the modelled step time."""
        if self.step_time_s <= 0:
            return 0.0
        return (self.model_flops / self.step_time_s) / (
            self.chips * self.peak_flops)

    def to_dict(self):
        d = dataclasses.asdict(self)
        del d["peak_flops"]
        d["dominant"] = self.dominant
        d["step_time_s"] = self.step_time_s
        d["roofline_fraction"] = self.roofline_fraction()
        return d


def roofline_from_stats(stats: HloStats, chips: int,
                        model_flops: float = 0.0,
                        machine: Machine = H100_SXM,
                        dtype: DtypeLike = "bf16",
                        cost_analysis_flops: float = 0.0) -> Roofline:
    """stats are one rank's: flops and bytes per rank, collective bytes
    per rank on the wire.

    The compute term takes max(stats FLOPs, cost-analysis FLOPs) at the
    machine's peak for ``dtype`` (JAX's takes every cell at the bf16 peak;
    the port's ocean cells are float32 and take the f32 one).  The
    collective term adds n_collectives times the machine's latency: the
    paper's 2D-mode wall is latency, not bandwidth."""
    peak = machine.peak(dtype)
    flops_pc = max(stats.flops, cost_analysis_flops or 0.0)
    compute = flops_pc / peak
    memory = stats.bytes / machine.hbm_bytes_per_s
    coll_bw = stats.coll_bytes / machine.link_bytes_per_s
    coll_lat = stats.n_collectives * machine.collective_latency_s
    total_flops = flops_pc * chips
    return Roofline(
        compute_s=compute, memory_s=memory,
        collective_s=coll_bw + coll_lat,
        flops=total_flops, bytes=stats.bytes * chips,
        coll_bytes=stats.coll_bytes * chips, chips=chips,
        model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
        coll_bw_s=coll_bw, coll_latency_s=coll_lat,
        n_collectives=stats.n_collectives, peak_flops=peak)


def model_flops_estimate(arch, shape, n_total: int, n_active: int) -> float:
    """MODEL_FLOPS: 6 N D (train), 2 N D (prefill), decode: 2 N B + KV reads."""
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * B * T
    if shape.kind == "prefill":
        return 2.0 * n_active * B * T
    flops = 2.0 * n_active * B
    if arch.family not in ("ssm",):
        n_attn_layers = arch.n_layers if arch.attn_period == 0 else \
            arch.n_layers // arch.attn_period
        flops += 4.0 * B * T * n_attn_layers * arch.n_heads * arch.hd
    return flops
