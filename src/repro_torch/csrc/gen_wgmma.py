"""Write `wgmma.cuh`: the Hopper `wgmma.mma_async` bf16 -> f32 instructions
that the flash-attention kernel (`flash_attention.cu`) issues, one inline-PTX
function per tile width N (each lists its N / 2 accumulator registers).

    python src/repro_torch/csrc/gen_wgmma.py      # rewrites wgmma.cuh

`tests/test_torch_flash_plan.py` checks that the committed header is what
this script writes.
"""
from pathlib import Path

SS_N = (64, 128)                     # S = Q K^T: N = the key tile
RS_N = (16, 32, 64, 80, 128, 256)    # O += P V: N = the head dim

HEAD = """\
// Generated by gen_wgmma.py: do not edit.
//
// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, for one warpgroup.
//   wgmma_ss<N>(d, a, b, scale_d): A (64 x 16) and B (16 x N) both read
//     from shared memory through descriptors, both K-major; scale_d = 0
//     overwrites d, 1 adds to it.
//   wgmma_rs<N>(d, a, b, scale_d): A from registers (the fragment of
//     4 x 2 bf16 per thread laid out like the accumulator), B from shared
//     memory MN-major (transpose bit set).
// The accumulator d[N / 2] of thread t of the warpgroup holds row
// 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + c in
// d[4 j + 2 h + c].
#pragma once
#include <stdint.h>

template <int N> __device__ __forceinline__ void wgmma_ss(
    float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <int N> __device__ __forceinline__ void wgmma_rs(
    float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int scale_d);
"""


def _regs(n: int, first: int = 0) -> str:
    return ", ".join(f"%{first + i}" for i in range(n))


def _outs(n: int) -> str:
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def ss(n: int) -> str:
    r = n // 2
    return f"""
template <> __device__ __forceinline__ void wgmma_ss<{n}>(
    float (&d)[{r}], uint64_t a, uint64_t b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {_outs(r)}
      : "l"(a), "l"(b), "r"(scale_d));
}}
"""


def rs(n: int) -> str:
    r = n // 2
    return f"""
template <> __device__ __forceinline__ void wgmma_rs<{n}>(
    float (&d)[{r}], const uint32_t (&a)[4], uint64_t b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(r)}}}, {{{_regs(4, r)}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"
      : {_outs(r)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}}
"""


def header() -> str:
    return HEAD + "".join(ss(n) for n in SS_N) + "".join(rs(n) for n in RS_N)


if __name__ == "__main__":
    (Path(__file__).resolve().parent / "wgmma.cuh").write_text(header())
