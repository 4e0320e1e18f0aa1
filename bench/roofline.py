"""The yardstick of the kernels' roofline shares: the data sheet's peaks of
the card, and each kernel's bytes and operations from its operands' shapes
(the formulas of the port's `roofline/kernels.py`, copied: each input read
once, each output written once; operations as the column algorithm needs
them), with the calls one step makes of each.

The calls a step makes (`STEP_CALLS`) follow `core/stepper.py`: per stage
one K1 over (u, v), one K2, one K4 over (u, v) for the prediction and one
over (u, v, T, S); in the implicit stage two K3 over two right-hand sides
and two K7 (GLS k and epsilon), and two K7 in the explicit stage's final
turbulence update.  A reader checks them against the program's own launch
counter, and reads nothing where they differ.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}   # tensor-core f64; f32 CUDA cores
PEAK_BYTES_S = 3.35e12                               # HBM3


def _nbytes(shape, itemsize) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * itemsize


def solve_r(K, nl, nt, itemsize):
    """K1: F (K, nl, 6, nt), area (nt,), bc (K, 3, nt) read, F written."""
    F = _nbytes((K, nl, 6, nt), itemsize)
    return (2 * F + _nbytes((nt,), itemsize) + _nbytes((K, 3, nt), itemsize),
            K * nt * (nl * 34 + 1))


def solve_w(K, nl, nt, itemsize):
    """K2: as K1, with no floor values read (impermeable floor)."""
    F = _nbytes((K, nl, 6, nt), itemsize)
    return 2 * F + _nbytes((nt,), itemsize), K * nt * (nl * 34 + 1)


def block_thomas(k, nl, nt, itemsize):
    """K3: lo but its first layer, dg, up but its last layer, rhs
    (k, nl, 6, nt) read; x written."""
    blk = _nbytes((6, 6, nt), itemsize)
    rhs = _nbytes((k, nl, 6, nt), itemsize)
    per_layer = 36 * 13 + 6 * k * 13 + 6 * (133 + 11 * k)
    flops = nt * (nl * per_layer + (nl - 1) * 6 * k * 13)
    return (nl - 1) * blk + nl * blk + (nl - 1) * blk + 2 * rhs, flops


def lateral_flux(k, nl, nt, itemsize):
    """K4: f (k, nl, 6, nt), fext (k, nl, 3, 2, 2, nt), speed
    (nl, 2, 3, 2, nt), edge_len (3, nt) read; f's shape written."""
    f = _nbytes((k, nl, 6, nt), itemsize)
    return (2 * f + _nbytes((k, nl, 12, nt), itemsize)
            + _nbytes((nl, 12, nt), itemsize) + _nbytes((3, nt), itemsize),
            k * nl * nt * 300)


def tridiag(nl, nt, itemsize):
    """K7: three bands and b (nl, C) read, x written."""
    return 5 * _nbytes((nl, nt), itemsize), 8 * nl * nt


# kernel name (as the port's launch counter and device names have it) ->
# [(cost function, leading argument)] of one step
STEP_CALLS = {
    "solve_r": [(solve_r, 2)] * 2,
    "solve_w": [(solve_w, 1)] * 2,
    "lateral_flux": [(lateral_flux, 2), (lateral_flux, 4)] * 2,
    "block_thomas": [(block_thomas, 2)] * 2,
    "tridiag": [(tridiag, None)] * 4,
}


def step_costs(nl: int, nt: int, dtype: str) -> dict:
    """kernel -> (bytes, flops) summed over one step's calls."""
    itemsize = {"float64": 8, "float32": 4}[dtype]
    out = {}
    for kernel, calls in STEP_CALLS.items():
        b = f = 0
        for fn, lead in calls:
            cb, cf = (fn(nl, nt, itemsize) if lead is None
                      else fn(lead, nl, nt, itemsize))
            b, f = b + cb, f + cf
        out[kernel] = (b, f)
    return out


def bound_s(nbytes: int, flops: int, dtype: str) -> float:
    """The least time the card could take: the larger of the byte and the
    operation bound."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype])


# the device names of those kernels (templates of csrc/ocean_kernels.cu)
OWN_KERNELS = ("solve_r_kernel", "solve_w_kernel", "block_thomas_kernel",
               "lateral_flux_kernel", "tridiag_kernel")


def is_own_kernel(name: str) -> bool:
    return any(k in name for k in OWN_KERNELS)
