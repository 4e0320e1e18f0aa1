"""The process-group layer of ranks that share one card: gloo, with the
collectives that gloo refuses on CUDA tensors staged through host memory.

NCCL refuses two ranks on one device, so ranks that share the card form a
gloo group.  Gloo takes CUDA tensors in the collectives DTensor issues,
except one: DTensor's all-gather on CUDA tensors (`all_gather_into_tensor`,
the Shard -> Replicate redistribution that FSDP weights and the sequence
gathers need) kills the process with a segmentation fault on the card
(torch 2.11, NVIDIA H100; the probe is `tests/test_torch_gpu.py::
test_gloo_cuda_collectives`).  `StagedGroup` is the process group the
ranks run on (`spawn.run(..., device="cuda")`): every collective goes to an
inner gloo group, and for the all-gathers (`_allgather_base`, `allgather`)
a CUDA tensor is copied to the host, gathered there by gloo, and copied
back.  Every
staged call is counted in `COUNTS` (calls and bytes moved each way), which
a rank reads and reports.  Compute never leaves the card: only the staged
collectives' buffers cross to the host.  A collective that fails raises.

Registered (`register()`) as the backend ``gloostaged`` for CPU and CUDA
tensors; importing this module registers nothing.
"""
from __future__ import annotations

import collections
import datetime

import torch
import torch.distributed as dist
from torch._C import _distributed_c10d as c10d

NAME = "gloostaged"
# {op: staged calls} and {op + " bytes": bytes copied to the host}
COUNTS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()


def _done(result) -> "dist.Work":
    """A completed Work holding ``result``."""
    fut = torch.futures.Future()
    fut.set_result(result)
    return c10d._create_work_from_future(fut)


def _on_card(*ts) -> bool:
    return any(t.device.type != "cpu" for t in ts)


def _count(op: str, *ts) -> None:
    COUNTS[op] += 1
    COUNTS[op + " bytes"] += sum(t.numel() * t.element_size() for t in ts)


class StagedGroup(dist.ProcessGroup):
    """A process group over an inner gloo group; the all-gathers of CUDA
    tensors run on host copies.  It carries the collectives the mesh path
    issues: DTensor's four, broadcast and barrier."""

    def __init__(self, store, rank: int, size: int,
                 timeout: datetime.timedelta):
        super().__init__(rank, size)
        self.gloo = c10d.ProcessGroupGloo(store, rank, size, timeout)

    def getBackendName(self) -> str:
        return NAME

    @property
    def group_name(self) -> str:
        """The name torch.distributed registered this group under."""
        return dist.distributed_c10d._world.pg_names[self]

    # --- all-gather -----------------------------------------------------------
    def _allgather_base(self, output, input, opts=c10d.AllgatherOptions()):
        if not _on_card(output, input):
            return self.gloo._allgather_base(output, input, opts)
        _count("all_gather_into_tensor", input)
        host = torch.empty(output.shape, dtype=output.dtype)
        self.gloo._allgather_base(host, input.cpu(), opts).wait()
        output.copy_(host)
        return _done(output)

    all_gather_single = _allgather_base

    def allgather(self, output_tensors, input_tensors,
                  opts=c10d.AllgatherOptions()):
        if not _on_card(*input_tensors):
            return self.gloo.allgather(output_tensors, input_tensors, opts)
        _count("allgather", *input_tensors)
        host_out = [[torch.empty(t.shape, dtype=t.dtype) for t in outs]
                    for outs in output_tensors]
        self.gloo.allgather(host_out, [t.cpu() for t in input_tensors],
                            opts).wait()
        for outs, hosts in zip(output_tensors, host_out):
            for t, h in zip(outs, hosts):
                t.copy_(h)
        return _done(output_tensors)

    def allgather_into_tensor_coalesced(self, outputs, inputs,
                                        opts=c10d.AllgatherOptions()):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i, opts).wait()
        return _done(outputs)

    # --- passed to gloo as they are ---------------------------------------------
    def _reduce_scatter_base(self, output, input,
                             opts=c10d.ReduceScatterOptions()):
        return self.gloo._reduce_scatter_base(output, input, opts)

    reduce_scatter_single = _reduce_scatter_base

    def allreduce(self, tensors, opts=c10d.AllreduceOptions()):
        return self.gloo.allreduce(tensors, opts)

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=c10d.AllToAllOptions()):
        return self.gloo.alltoall_base(output, input, output_split_sizes,
                                       input_split_sizes, opts)

    all_to_all_single = alltoall_base

    def reduce_scatter(self, output_tensors, input_tensors,
                       opts=c10d.ReduceScatterOptions()):
        return self.gloo.reduce_scatter(output_tensors, input_tensors, opts)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs,
                                        opts=c10d.ReduceScatterOptions()):
        for o, i in zip(outputs, inputs):
            self.gloo._reduce_scatter_base(o, i, opts).wait()
        return _done(outputs)

    def allreduce_coalesced(self, tensors,
                            opts=c10d.AllreduceCoalescedOptions()):
        return self.gloo.allreduce_coalesced(tensors, opts)

    def gather(self, output_tensors, input_tensors, opts=c10d.GatherOptions()):
        return self.gloo.gather(output_tensors, input_tensors, opts)

    def scatter(self, output_tensors, input_tensors,
                opts=c10d.ScatterOptions()):
        return self.gloo.scatter(output_tensors, input_tensors, opts)

    def send(self, tensors, dst: int, tag: int):
        return self.gloo.send(tensors, dst, tag)

    def recv(self, tensors, src: int, tag: int):
        return self.gloo.recv(tensors, src, tag)

    def broadcast(self, tensors, opts=c10d.BroadcastOptions()):
        return self.gloo.broadcast(tensors, opts)

    def barrier(self, opts=c10d.BarrierOptions()):
        return self.gloo.barrier(opts)


def _create(store, rank, size, timeout):
    return StagedGroup(store, rank, size, timeout)


def register() -> None:
    """Register ``gloostaged`` with torch.distributed (once a process)."""
    if NAME not in dist.Backend.backend_list:
        dist.Backend.register_backend(NAME, _create, devices=["cpu", "cuda"])
