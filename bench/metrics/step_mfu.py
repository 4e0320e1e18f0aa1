"""The whole step's share of the cards' peak, in %: the step's counted
flops (`cells/<workload>.json`, `bench/flops.py`: one step of the plain
reference over the whole mesh) over the untraced window's wall time a step
times the data sheet's peak for the dtype, times the cards the step runs
on."""
from bench.roofline import PEAK_FLOPS


def read(ctx):
    flops = ctx["cell"].get("flops_per_step")
    if not flops or not ctx["steps"]:
        return None
    step_s = ctx["wall_s"] / ctx["steps"]
    return 100.0 * flops / (step_s * ctx.get("chips", 1)
                            * PEAK_FLOPS[ctx["dtype"]])
