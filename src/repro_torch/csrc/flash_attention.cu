// K9: forward flash attention with causal mask, sliding window and tanh
// soft-cap, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel: grid (BH, Tq / 128, Tk / 128), m, l and the accumulator
// in VMEM scratch carried across the kv grid dimension).  The sequential kv
// grid dimension becomes a loop over key tiles inside the block.
//
// What it computes (the Pallas kernel's semantics): s = (q * scale, rounded
// to the input dtype) k^T summed in float32; soft-cap softcap * tanh(s /
// softcap); keys above the causal diagonal (top-left aligned) or with
// k <= q - window get the -1e30 sentinel; online softmax in float32; p is
// rounded to the input dtype before P V, which sums in float32; the output
// is acc / max(l, 1e-30).  Given two non-null float32 (BH, Tq) pointers, it
// also writes each row's final m and l (the backward's row statistics, as
// JAX's custom VJP saves them); with null pointers it stores nothing more.
// A row with no valid key keeps m at the sentinel,
// so Pallas gives every key p = 1: its output is the mean of v over all Tk
// keys, which a second pass computes (only threads holding such a row run
// it).  Key tiles outside the causal / window band of a whole query tile
// are skipped.  Inside the band a row may see a tile with no valid key for
// it: p = 0 if its m is valid, else (still at the sentinel) whatever its
// first valid key rescales away with alpha = 0.  Only tiles that straddle
// the diagonal, the window's edge or the ragged end evaluate the mask, and
// soft-cap and mask each run as a loop of their own (inside one loop the
// compiler predicates both and pays for them on every score).  exp is one
// MUFU.EX2 of (s - m) log2 e (float32) or s log2 e - m log2 e (bfloat16,
// one FFMA).
//
// Bound on the H100: operations (4 d flops per unmasked (q, k) pair against
// 4 d elements moved per query row: thousands of flops per byte at these
// sequence lengths).  Second bound, in bf16 at small d: one exp per pair on
// the SFU (16 a clock per SM).
//
// bfloat16 (flash_bf16_kernel<D>): both products on the tensor cores.
//   One block per (bh, 128-query tile): two consumer warpgroups of 64 query
//   rows each, plus a producer warpgroup that gives its registers to them
//   (setmaxnreg: 240 a consumer thread).  The producer loads the Q tile once
//   and the K and V tiles into a ring of shared-memory stages (3 at
//   d <= 128, 2 at d = 256) with TMA: 3-D tensor maps over (BH, T, d), so a
//   ragged tile reads TMA's zero fill and never the next head's rows,
//   completing on mbarriers; a stage is refilled when both warpgroups have
//   released it.  Each warpgroup scales its Q rows in place (rounded to
//   bf16, as Pallas rounds q * scale), then per key tile: S = Q K^T by
//   wgmma m64nBKk16 with both operands K-major in shared memory, softmax
//   on the accumulator fragment in registers, P rounded to bf16 and packed
//   as wgmma's register A operand (the accumulator layout is the A layout,
//   no shuffles), O += P V by wgmma m64nDk16 with V MN-major (transpose
//   bit).  O stays in float32 registers.  The products of tile t (S) and
//   t - 1 (P V) go out as one wgmma group, and the two warpgroups take
//   turns at the tensor cores (named barriers), so one warpgroup's softmax
//   overlaps the other's products.  Soft-cap's tanh goes through exp2
//   (tanh_ex2), not tanhf.  Shared memory holds each operand in chunks of
//   CW columns swizzled by 2 CW bytes (128 B at d = 64, 128, 256; 64 B at
//   d = 32; 32 B at d = 16 and d = 80, whose 160-byte rows fit no single
//   span).  Tile sizes, chunks, stages and shared-memory bytes come from
//   the Python launch plan (kernels/flash_attention.py: launch_plan), which
//   the launcher checks against the constants below.  Not done: overlap of
//   a tile's softmax with its own warpgroup's P V (tried: no gain at
//   d = 128, slower at d = 256), exps on the FMA pipes, persistent blocks.
//
// float32 (flash_f32_kernel<D>): the FP32 pipes, register-blocked.  One
//   block of 256 threads per (bh, 128-query tile; 64 at d = 256) over
//   key tiles of 64 at d = 128, else 32.  Thread (rg, cg) holds the scores of rows rg + 32 i and
//   keys cg + 8 j, and the output of its rows at the columns of cg; Q, K,
//   V and P are row-major in shared memory with padded strides, read as
//   16-byte vectors along d (Q K^T) and along the keys (P V): about one
//   shared load per 8 to 10 FMAs.  Tiles arrive by cp.async (zero-filled
//   past Tk): K double-buffered, so K of tile t + 1 loads while tile t
//   computes; V single, loading while the next tile's Q K^T runs.
//
// The launchers return the cudaError_t of the launch (cudaGetLastError()
// right after it); the kernels never synchronise with the host and
// allocate nothing.  The tensor maps are encoded on the host with the CUDA
// driver API's cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -Xptxas -v -c flash_attention.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's mask sentinel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (2^(2 x log2 e) + 1), odd: within ~3e-7 of tanhf
// (ex2.approx and a fast divide), so soft-cap 50 moves a logit by ~1.5e-5,
// not the ~0.025 of tanh.approx.f32's 2^-11 relative error
__device__ __forceinline__ float tanh_ex2(float x) {
  const float e = ex2(fminf(2.f * kLog2e * fabsf(x), 64.f));
  return copysignf(1.f - __fdividef(2.f, e + 1.f), x);
}

__device__ __forceinline__ bool key_ok(int qi, int kj, int tk, int causal,
                                       int win) {
  return kj < tk && (!causal || kj <= qi) && (win <= 0 || kj > qi - win);
}

// the window as a 32-bit int (keys and rows are < 2^31, so a wider window
// masks nothing more)
__device__ __forceinline__ int window_i32(int64_t window) {
  return window > 0x7fffffff ? 0x7fffffff : static_cast<int>(window);
}

// The key tiles [k_begin, k_end) that hold a valid key for some row of the
// query tile [q0, q0 + bq); k_begin is a multiple of bk.
__device__ __forceinline__ int ntiles_of(int64_t q0, int bq, int bk,
                                         int64_t Tk, int causal,
                                         int64_t window, int64_t* k_begin) {
  int64_t end = Tk, begin = 0;
  if (causal && q0 + bq < end) end = q0 + bq;
  if (window > 0 && q0 - window + 1 > 0) begin = ((q0 - window + 1) / bk) * bk;
  *k_begin = begin;
  return end > begin ? static_cast<int>((end - begin + bk - 1) / bk) : 0;
}

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma
// ---------------------------------------------------------------------------
template <int D>
struct Bf16Plan {
  static constexpr int BQ = 128;                       // 2 warpgroups x 64
  static constexpr int BK = D == 256 ? 64 : 128;       // key tile
  static constexpr int CW = D % 64 == 0 ? 64 : (D == 32 ? 32 : 16);
  static constexpr int NCH = D / CW;                   // column chunks
  static constexpr int STAGES = D <= 128 ? 3 : 2;       // as shared memory allows
  static constexpr int THREADS = 384;                  // 2 consumer warpgroups + producer
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;          // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
                              8 * (1 + 2 * STAGES);
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr uint64_t LAYOUT = CW == 64 ? 1 : (CW == 32 ? 2 : 3);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(Bf16Plan<D>::THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int64_t Tq, int64_t Tk,
                  int causal, int64_t window, float scale, float softcap) {
  using P = Bf16Plan<D>;
  constexpr int BQ = P::BQ, BK = P::BK, CW = P::CW, NCH = P::NCH, S = P::STAGES;
  constexpr uint32_t ROWB = CW * 2;        // bytes of one row of a chunk
  extern __shared__ __align__(1024) uint8_t fa_smem[];
  const uint32_t raw = smem_u32(fa_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = fa_smem + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + P::Q_BYTES;                 // + stage * KV_BYTES
  const uint32_t sV = sK + S * P::KV_BYTES;
  const uint32_t bars = sV + S * P::KV_BYTES;          // full_q, full[S], empty[S]
  const uint32_t full_q = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + S + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  int64_t k_begin;
  const int ntiles = ntiles_of(q0, BQ, BK, Tk, causal, window, &k_begin);

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);            // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer warpgroup: one thread issues every load; the warpgroup
    // hands its registers to the consumers (168 a thread at launch; 128 x
    // (168 - 24) released = 256 x (240 - 168) taken)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == 256) {
      mbar_expect_tx(full_q, P::Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        tma_load_3d(sQ + c * BQ * ROWB, &qmap, full_q, c * CW,
                    static_cast<int>(q0), bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % S;
        mbar_wait(empty(s), ((t / S) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * P::KV_BYTES);
        const int k0 = static_cast<int>(k_begin) + t * BK;
        for (int c = 0; c < NCH; ++c) {
          tma_load_3d(sK + s * P::KV_BYTES + c * BK * ROWB, &kmap, full(s),
                      c * CW, k0, bh);
          tma_load_3d(sV + s * P::KV_BYTES + c * BK * ROWB, &vmap, full(s),
                      c * CW, k0, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows qa .. qa + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int wg = tid >> 7, t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
  const int quad = lane & 3;
  const int64_t qa = q0 + 64 * wg;
  const int64_t row0 = qa + 16 * warp + (lane >> 2);  // and row0 + 8
  // 32-bit copies for the mask (the launcher takes Tq, Tk < 2^31)
  const int r0 = static_cast<int>(row0), tk = static_cast<int>(Tk),
            win = window_i32(window);
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  // q * scale, rounded to bf16, in place: the warpgroup's 64 rows of each
  // chunk are one contiguous range (the swizzle permutes within 8 rows)
  mbar_wait(full_q, 0);
  for (int c = 0; c < NCH; ++c) {
    uint4* rows = reinterpret_cast<uint4*>(gbase + c * BQ * ROWB + 64 * wg * ROWB);
    for (int e = t128; e < 64 * ROWB / 16; e += 128) {
      uint4 x = rows[e];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        h[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      rows[e] = x;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");

  float o[D / 2], sc[BK / 2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // S = (q * scale) K^T of tile t into sc
  auto issue_s = [&](int t) {
    const int s = t % S;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / CW;
      const uint32_t intra = (kk * 16 % CW) * 2;
      const uint64_t da = gmma_desc(sQ + c * BQ * ROWB + 64 * wg * ROWB + intra,
                                    16, 8 * ROWB, P::LAYOUT);
      const uint64_t db = gmma_desc(sK + s * P::KV_BYTES + c * BK * ROWB + intra,
                                    16, 8 * ROWB, P::LAYOUT);
      wgmma_ss<BK>(sc, da, db, kk > 0);
    }
  };
  // O += P V of tile t, P from pa
  auto issue_pv = [&](int t) {
    const int s = t % S;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = gmma_desc(sV + s * P::KV_BYTES + kk * 16 * ROWB,
                                    BK * ROWB, 8 * ROWB, P::LAYOUT);
      wgmma_rs<D>(o, pa[kk], db, 1);
    }
  };
  // soft-cap, mask, online softmax of tile t's scores in sc; rescales O
  // and packs p (rounded to bf16) into pa
  auto softmax = [&](int t) {
    const int64_t k0 = k_begin + static_cast<int64_t>(t) * BK;
    const bool masked = k0 + BK > Tk || (causal && k0 + BK - 1 > qa) ||
                        (window > 0 && k0 <= qa + 63 - window);
    // (each option is a loop of its own: inside one loop the compiler
    // predicates both branches and pays for them on every score)
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = softcap * tanh_ex2(sc[i] * inv_cap);
    }
    if (masked) {
      const int kb = static_cast<int>(k0) + 2 * quad;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (!key_ok(r0 + 8 * ((i >> 1) & 1), kb + 8 * (i >> 2) + (i & 1), tk, causal, win))
          sc[i] = kNegInf;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      alpha[h] = ex2((m[h] - mn) * kLog2e);
      m[h] = mn;
      l[h] *= alpha[h];
    }
    // p = 2^(s log2 e - m log2 e), one FFMA; a row still at the sentinel
    // takes m log2 e = 0, so its masked scores give p = 0, not Pallas's 1:
    // its first valid key rescales that by alpha = 0 either way, and a row
    // that never gets one is redone below
    float ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) ms[h] = m[h] == kNegInf ? 0.f : m[h] * kLog2e;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float p = ex2(fmaf(sc[i], kLog2e, -ms[h]));
      sc[i] = p;
      l[h] += p;                        // this thread's columns; summed at the end
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  };

  // Software pipeline: batch t issues S of tile t and P V of tile t - 1 in
  // one wgmma group, then the softmax of tile t runs while the other
  // warpgroup's batch keeps the tensor cores busy (ping-pong: named
  // barrier 3 + g lets warpgroup g issue; warpgroup 1 lets 0 go first).
  // Every tile of the block's band is computed for both warpgroups: a tile
  // with no valid key for a row gives it p = 0 (see softmax).
  if (ntiles > 0) {
    const int me = 3 + wg, other = 4 - wg;
    if (wg == 1) asm volatile("bar.arrive 3, 256;" ::: "memory");
    mbar_wait(full(0), 0);
    asm volatile("bar.sync %0, 256;" :: "r"(me) : "memory");
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    asm volatile("bar.arrive %0, 256;" :: "r"(other) : "memory");
    wgmma_wait_all();
    fence_regs(sc);
    softmax(0);
    for (int t = 1; t < ntiles; ++t) {
      mbar_wait(full(t % S), (t / S) & 1);
      asm volatile("bar.sync %0, 256;" :: "r"(me) : "memory");
      fence_regs(o);
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      wgmma_commit();
      asm volatile("bar.arrive %0, 256;" :: "r"(other) : "memory");
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(o);
      if (t128 == 0) mbar_arrive(empty((t - 1) % S));
      softmax(t);
    }
    asm volatile("bar.sync %0, 256;" :: "r"(me) : "memory");
    fence_regs(o);
    wgmma_fence();
    issue_pv(ntiles - 1);
    wgmma_commit();
    if (wg == 0) asm volatile("bar.arrive 4, 256;" ::: "memory");
    wgmma_wait_all();
    fence_regs(o);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // rows with no valid key: the mean of v over all Tk keys
  const __nv_bfloat16* vb = v + static_cast<int64_t>(bh) * Tk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row0 + 8 * h >= Tq || m[h] != kNegInf) continue;
    l[h] = static_cast<float>(Tk);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[4 * j + 2 * h] = o[4 * j + 2 * h + 1] = 0.f;
    for (int64_t kj = 0; kj < Tk; ++kj) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            vb + kj * D + 8 * j + 2 * quad));
        o[4 * j + 2 * h] += f.x;
        o[4 * j + 2 * h + 1] += f.y;
      }
    }
  }

  __nv_bfloat16* ob = out + static_cast<int64_t>(bh) * Tq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t qi = row0 + 8 * h;
    if (qi >= Tq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + qi * D + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    if (m_out != nullptr && quad == 0) {    // the row statistics of a backward
      m_out[static_cast<int64_t>(bh) * Tq + qi] = m[h];
      l_out[static_cast<int64_t>(bh) * Tq + qi] = l[h];
    }
  }
}

// ---------------------------------------------------------------------------
// float32: register-blocked SIMT, cp.async double buffering
// ---------------------------------------------------------------------------
template <int D>
struct F32Plan {
  static constexpr int BQ = D == 256 ? 64 : 128;
  static constexpr int BK = D == 128 ? 64 : 32;     // as shared memory allows
  static constexpr int STAGES = 2;                   // of K; V has one
  static constexpr int THREADS = 256;                // 32 row groups x 8
  static constexpr int RM = BQ / 32;                 // rows per thread
  static constexpr int KN = BK / 8;                  // keys per thread
  static constexpr int VW = D % 32 == 0 ? 4 : 2;     // output vector width
  static constexpr int NG = D / (8 * VW);            // output vectors per row
  static constexpr int QS = D + 4, KS = D + 4, VS = D, PS = BK + 8;
  static constexpr int SMEM = 4 * (BQ * QS + STAGES * BK * KS + BK * VS + BQ * PS);
};

template <int VW> struct VecOf;
template <> struct VecOf<4> { using type = float4; };
template <> struct VecOf<2> { using type = float2; };

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

template <int D>
__global__ void __launch_bounds__(F32Plan<D>::THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int64_t Tq, int64_t Tk, int causal, int64_t window,
                 float scale, float softcap) {
  using P = F32Plan<D>;
  constexpr int BQ = P::BQ, BK = P::BK, RM = P::RM, KN = P::KN, VW = P::VW,
                NG = P::NG, QS = P::QS, KS = P::KS, VS = P::VS, PS = P::PS;
  using Vec = typename VecOf<VW>::type;
  extern __shared__ __align__(16) float f32_smem[];
  float* Qs = f32_smem;                     // [BQ][QS]  q * scale
  float* Ks = Qs + BQ * QS;                 // [2][BK][KS]
  float* Vs = Ks + 2 * BK * KS;             // [BK][VS]
  float* Ps = Vs + BK * VS;                 // [BQ][PS]

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int64_t bh = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  q += bh * Tq * D;
  out += bh * Tq * D;
  k += bh * Tk * D;
  v += bh * Tk * D;
  int64_t k_begin;
  const int ntiles = ntiles_of(q0, BQ, BK, Tk, causal, window, &k_begin);
  const int tk = static_cast<int>(Tk), win = window_i32(window);

  // tile t of K (into stage t % 2) or V into shared memory, as one
  // cp.async group; rows past Tk are zero-filled
  auto load = [&](const float* src, float* dst, int stride, int t) {
    const int64_t k0 = k_begin + static_cast<int64_t>(t) * BK;
    for (int e = tid; e < BK * D / 4; e += P::THREADS) {
      const int rr = e / (D / 4), c4 = e - rr * (D / 4);
      const bool ok = k0 + rr < Tk;
      cp_async16(dst + rr * stride + 4 * c4, src + (ok ? (k0 + rr) * D + 4 * c4 : 0), ok);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // groups in flight, oldest first: V_t, K_(t+1) while tile t computes
  if (ntiles > 0) {
    load(k, Ks, KS, 0);
    load(v, Vs, VS, 0);
  }

  for (int e = tid; e < BQ * D / 4; e += P::THREADS) {
    const int rr = e / (D / 4), c4 = e - rr * (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + rr < Tq) x = *reinterpret_cast<const float4*>(q + (q0 + rr) * D + 4 * c4);
    *reinterpret_cast<float4*>(Qs + rr * QS + 4 * c4) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  float m[RM], l[RM], acc[RM][NG * VW];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * VW; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int s = t & 1;
    const int64_t k0 = k_begin + static_cast<int64_t>(t) * BK;
    const bool next = t + 1 < ntiles;
    if (next) {
      load(k, Ks + (s ^ 1) * BK * KS, KS, t + 1);
      asm volatile("cp.async.wait_group 2;" ::: "memory");   // K_t is in
    } else {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    }
    __syncthreads();   // K_t (and, at t = 0, Qs) visible to all

    const float* Kt = Ks + s * BK * KS;
    float sc[RM][KN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qv[RM], kv[KN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (rg + 32 * i) * QS + dd);
#pragma unroll
      for (int j = 0; j < KN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Kt + (cg + 8 * j) * KS + dd);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }

    const bool masked = k0 + BK > Tk || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + BQ - 1 - window);
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) sc[i][j] = softcap * tanhf(sc[i][j] / softcap);
    }
    if (masked) {
      const int kb = static_cast<int>(k0) + cg, qb = static_cast<int>(q0) + rg;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j)
          if (!key_ok(qb + 32 * i, kb + 8 * j, tk, causal, win)) sc[i][j] = kNegInf;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < KN; ++j) mc = fmaxf(mc, sc[i][j]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = ex2((m[i] - mn) * kLog2e);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const float p = ex2((sc[i][j] - mn) * kLog2e);
        ps += p;
        Ps[(rg + 32 * i) * PS + cg + 8 * j] = p;
      }
      l[i] = alpha * l[i] + ps;         // this thread's keys; summed at the end
#pragma unroll
      for (int c = 0; c < NG * VW; ++c) acc[i][c] *= alpha;
    }
    if (next) {
      asm volatile("cp.async.wait_group 1;" ::: "memory");   // V_t is in
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();   // P complete, V_t visible to all

    const float* Vt = Vs;
#pragma unroll 2
    for (int c0 = 0; c0 < BK; c0 += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (rg + 32 * i) * PS + c0);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const Vec vv = *reinterpret_cast<const Vec*>(
              Vt + (c0 + cc) * VS + cg * VW + 8 * VW * g);
          const float* vf = reinterpret_cast<const float*>(&vv);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int e = 0; e < VW; ++e)
              acc[i][g * VW + e] = fmaf(p, vf[e], acc[i][g * VW + e]);
          }
        }
      }
    }
    __syncthreads();   // K stage s, V and P read
    if (next) load(v, Vs, VS, t + 1);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int64_t qi = q0 + rg + 32 * i;
    if (qi >= Tq) continue;
    if (m[i] == kNegInf) {
      // no valid key: the mean of v over all Tk keys
      l[i] = static_cast<float>(Tk);
#pragma unroll
      for (int c = 0; c < NG * VW; ++c) acc[i][c] = 0.f;
      for (int64_t kj = 0; kj < Tk; ++kj) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const Vec vv = *reinterpret_cast<const Vec*>(v + kj * D + cg * VW + 8 * VW * g);
          const float* vf = reinterpret_cast<const float*>(&vv);
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[i][g * VW + e] += vf[e];
        }
      }
    }
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      Vec r;
      float* rf = reinterpret_cast<float*>(&r);
#pragma unroll
      for (int e = 0; e < VW; ++e) rf[e] = acc[i][g * VW + e] * inv;
      *reinterpret_cast<Vec*>(out + qi * D + cg * VW + 8 * VW * g) = r;
    }
    if (m_out != nullptr && cg == 0) {      // the row statistics of a backward
      m_out[bh * Tq + qi] = m[i];
      l_out[bh * Tq + qi] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D map over a contiguous (BH, T, D) bf16 tensor, box (1, rows, cw)
bool encode_map(CUtensorMap* map, const void* ptr, int64_t BH, int64_t T,
                int D, int rows, int cw) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cw), static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the launch plan computed in Python (kernels/flash_attention.py), with the
// grid's query tiles; the launcher refuses one that is not its own
struct Plan {
  int64_t block_q, block_k, chunk, stages, threads, smem, grid_x;
};

template <typename K>
int set_smem(K kernel, int64_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int D>
int launch_bf16_d(const void* q, const void* k, const void* v, void* out,
                  void* m_out, void* l_out, int64_t BH, int64_t Tq, int64_t Tk,
                  int causal, int64_t window,
                  float scale, float softcap, const Plan& plan, void* stream) {
  using P = Bf16Plan<D>;
  if (plan.block_q != P::BQ || plan.block_k != P::BK || plan.chunk != P::CW ||
      plan.stages != P::STAGES || plan.threads != P::THREADS || plan.smem != P::SMEM ||
      plan.grid_x != (Tq + P::BQ - 1) / P::BQ)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!encode_map(&qm, q, BH, Tq, D, P::BQ, P::CW) ||
      !encode_map(&km, k, BH, Tk, D, P::BK, P::CW) ||
      !encode_map(&vm, v, BH, Tk, D, P::BK, P::CW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = set_smem(flash_bf16_kernel<D>, P::SMEM)) return err;
  const dim3 grid(static_cast<unsigned>(plan.grid_x), static_cast<unsigned>(BH));
  flash_bf16_kernel<D><<<grid, P::THREADS, P::SMEM, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), Tq, Tk, causal, window,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32_d(const void* q, const void* k, const void* v, void* out,
                 void* m_out, void* l_out, int64_t BH, int64_t Tq, int64_t Tk,
                 int causal, int64_t window,
                 float scale, float softcap, const Plan& plan, void* stream) {
  using P = F32Plan<D>;
  if (plan.block_q != P::BQ || plan.block_k != P::BK || plan.chunk != 0 ||
      plan.stages != P::STAGES || plan.threads != P::THREADS || plan.smem != P::SMEM ||
      plan.grid_x != (Tq + P::BQ - 1) / P::BQ)
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = set_smem(flash_f32_kernel<D>, P::SMEM)) return err;
  const dim3 grid(static_cast<unsigned>(plan.grid_x), static_cast<unsigned>(BH));
  flash_f32_kernel<D><<<grid, P::THREADS, P::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), Tq, Tk, causal,
      window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

#define FA_SWITCH(LAUNCH)                                                         \
  switch (d) {   /* the head dims of configs/archs.py (80, 128, 256) and the tests' */ \
    case 16: return LAUNCH<16>(q, k, v, out, m_out, l_out, BH, Tq, Tk, causal, window, sc, cap, plan, stream);   \
    case 32: return LAUNCH<32>(q, k, v, out, m_out, l_out, BH, Tq, Tk, causal, window, sc, cap, plan, stream);   \
    case 64: return LAUNCH<64>(q, k, v, out, m_out, l_out, BH, Tq, Tk, causal, window, sc, cap, plan, stream);   \
    case 80: return LAUNCH<80>(q, k, v, out, m_out, l_out, BH, Tq, Tk, causal, window, sc, cap, plan, stream);   \
    case 128: return LAUNCH<128>(q, k, v, out, m_out, l_out, BH, Tq, Tk, causal, window, sc, cap, plan, stream); \
    case 256: return LAUNCH<256>(q, k, v, out, m_out, l_out, BH, Tq, Tk, causal, window, sc, cap, plan, stream); \
    default: return static_cast<int>(cudaErrorInvalidValue);                      \
  }

}  // namespace

extern "C" {

// m_out and l_out: null, or float32 (BH, Tq) for the row statistics
#define FA_ARGS                                                                  \
  const void *q, const void *k, const void *v, void *out, void *m_out,           \
      void *l_out, int64_t BH, int64_t Tq, int64_t Tk, int64_t d, int causal,    \
      int64_t window, double scale, double softcap, int64_t block_q,             \
      int64_t block_k, int64_t chunk, int64_t stages, int64_t threads,           \
      int64_t smem, int64_t grid_x, void *stream

int flash_attention_bf16(FA_ARGS) {
  const float sc = static_cast<float>(scale), cap = static_cast<float>(softcap);
  const Plan plan{block_q, block_k, chunk, stages, threads, smem, grid_x};
  FA_SWITCH(launch_bf16_d)
}

int flash_attention_f32(FA_ARGS) {
  const float sc = static_cast<float>(scale), cap = static_cast<float>(softcap);
  const Plan plan{block_q, block_k, chunk, stages, threads, smem, grid_x};
  FA_SWITCH(launch_f32_d)
}

#undef FA_ARGS

}  // extern "C"
