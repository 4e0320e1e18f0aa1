"""Reduce a `torch.profiler` session over a few steps to what the per-layer
readers need: device activities with their durations, each kernel tied to
the host launch that issued it, and the intervals of the stepper's ranges
(`core/stepper.py`'s `stage.*` and `imex.*`, read from the program's
`obs/trace.annotate`).

The arithmetic is the one of the port's `profile_step.py`: a kernel is
linked to its runtime call by the CUPTI correlation id and counted in every
range whose host interval holds that call."""
from __future__ import annotations

import bisect
import dataclasses

# the profiler also lays each range on the device timeline under its own
# name: those are not device work (`halo.`, `distributed.`: the ranges of
# the port's distributed step)
RANGE_PREFIXES = ("imex.", "stage.", "kops.", "obs.", "halo.",
                  "distributed.")
# a collective's kernels (NCCL's send/receive) spin on the device while they
# wait for a peer: they are the exchange's time, not the device's work
COMM_PREFIX = "nccl"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    launched_ns: int        # host time of the launch call, -1 if unknown
    kernel: bool            # False for memcpy / memset

    @property
    def comm(self) -> bool:
        """A collective's kernel (`COMM_PREFIX`)."""
        return self.name.startswith(COMM_PREFIX)


@dataclasses.dataclass
class Trace:
    ops: list               # DeviceOp
    ranges: dict            # range name -> [(start_ns, end_ns)]
    steps: int
    window_s: float         # host wall time of the traced steps

    def in_range(self, op: DeviceOp, name: str) -> bool:
        t = op.launched_ns
        return any(a <= t <= b for a, b in self.ranges.get(name, ()))

    def range_open_at(self, t_ns: int, prefix: str = "stage.") -> str:
        """The range of ``prefix`` open on the host at t_ns (the stepper's
        `stage.*` ranges follow one another, none inside another)."""
        if not hasattr(self, "_spans"):
            self._spans = sorted((a, b, n) for n, spans in self.ranges.items()
                                 if n.startswith(prefix) for a, b in spans)
            self._starts = [a for a, _, _ in self._spans]
        i = bisect.bisect_right(self._starts, t_ns) - 1
        if i >= 0 and t_ns <= self._spans[i][1]:
            return self._spans[i][2]
        return "outside the stages"

    def _work(self) -> list:
        """(start_ns, end_ns) of the device activities but a collective's
        kernels, in order."""
        return sorted((o.start_ns, o.start_ns + o.dur_ns) for o in self.ops
                      if not o.comm)

    def busy_ns(self) -> int:
        """The union of the device activities' intervals, a collective's
        kernels left out."""
        spans = self._work()
        total, cur_a, cur_b = 0, None, None
        for a, b in spans:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    total += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            total += cur_b - cur_a
        return total

    def gaps(self) -> list:
        """(start_ns, length_ns) of each idle gap between the device
        activities of `busy_ns`."""
        spans = self._work()
        out, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                out.append((end, a - end))
            end = b if end is None else max(end, b)
        return out


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def from_events(events, steps: int, window_s: float,
                range_names) -> Trace:
    """Build a Trace from the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    launched, ranges, device = {}, {n: [] for n in range_names}, []
    for e in events:
        name = e.name()
        if _is_device(e):
            if e.is_user_annotation() or name.startswith(RANGE_PREFIXES):
                continue
            device.append(e)
        elif name in LAUNCH_CALLS:
            launched[e.correlation_id()] = e.start_ns()
        elif name in ranges:
            ranges[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    ops = [DeviceOp(name=e.name(), start_ns=e.start_ns(),
                    dur_ns=e.duration_ns(),
                    launched_ns=launched.get(e.correlation_id(), -1),
                    kernel=not e.name().startswith(("Memcpy", "Memset")))
           for e in device]
    return Trace(ops=ops, ranges=ranges, steps=steps, window_s=window_s)
