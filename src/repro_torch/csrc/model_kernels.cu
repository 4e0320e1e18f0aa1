// Hand-written Hopper (sm_90a) kernels of the model ops: K8 wkv6 (the RWKV6
// recurrence) and K9 flash_attention (forward attention with causal mask,
// sliding window and tanh soft-cap).
//
// Each kernel is templated on the element type (float or __nv_bfloat16) and
// on its head dimension, and is launched through an extern "C" function
// that returns the cudaError_t of the launch (cudaGetLastError() right
// after it).  The Python wrappers in repro_torch/kernels/{wkv6,
// flash_attention}.py check shapes, dtypes and contiguity, allocate the
// output and pass the current PyTorch stream; the kernels never synchronise
// and allocate nothing.  All arithmetic is float32; bfloat16 inputs are
// widened on load, and the values the TPU kernels round to bfloat16 (q *
// scale and p in K9, k v^T and u k v^T in K8) are rounded here too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -Xptxas -v -c model_kernels.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the value a T-typed intermediate holds
template <typename T>
__device__ __forceinline__ float round_to(float x) { return widen(narrow<T>(x)); }

constexpr float kNegInf = -1e30f;   // the TPU kernels' mask sentinel

// ---------------------------------------------------------------------------
// K8: RWKV6 WKV recurrence.
//
// Replaces the TPU kernel repro/kernels/wkv6.py::wkv6 (its pallas_call body:
// grid (BH, T / 128), S in VMEM scratch carried across the time blocks).
// Bound on the H100: operations in principle (7 K V flops per token and
// head against (3K + 2V) elements moved), but in practice latency: each
// column is a chain of T dependent steps, and at BH = 320, V = 64 the grid
// is only 320 blocks of 64 threads, about 5 warps per SM.
// Design: one block per (bh, 64 value columns), one thread per column
// holding S[:, v] (K floats) in registers, so the state never leaves the
// SM.  Tiles of kTile time steps of r, k, w and v are staged in shared
// memory by coalesced loads (r, k, w are read by every thread, as float4
// broadcasts); the thread then walks the tile, splitting the output sum
// over four accumulators to shorten its dependent chain.  The sequential
// TPU grid dimension becomes the loop over tiles; any T is taken.
// ---------------------------------------------------------------------------
constexpr int kWkvThreads = 64;
constexpr int kWkvTile = 32;

template <typename T, int K>
__global__ void __launch_bounds__(kWkvThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const T* __restrict__ u, T* __restrict__ out, int64_t T_len,
            int64_t V) {
  __shared__ __align__(16) float rs[kWkvTile * K];
  __shared__ __align__(16) float ks[kWkvTile * K];
  __shared__ __align__(16) float ws[kWkvTile * K];
  __shared__ __align__(16) float us[K];
  __shared__ float vs[kWkvTile * kWkvThreads];

  const int64_t bh = blockIdx.x;
  const int64_t v0 = static_cast<int64_t>(blockIdx.y) * kWkvThreads;
  const int64_t col = v0 + threadIdx.x;
  const bool live = col < V;
  r += bh * T_len * K;
  k += bh * T_len * K;
  w += bh * T_len * K;
  v += bh * T_len * V;
  out += bh * T_len * V;
  for (int i = threadIdx.x; i < K; i += kWkvThreads) us[i] = widen(u[i]);

  float S[K];
#pragma unroll
  for (int i = 0; i < K; ++i) S[i] = 0.f;

  for (int64_t t0 = 0; t0 < T_len; t0 += kWkvTile) {
    const int nt = static_cast<int>(T_len - t0 < kWkvTile ? T_len - t0 : kWkvTile);
    __syncthreads();   // the previous tile has been read
    for (int e = threadIdx.x; e < nt * K; e += kWkvThreads) {
      const int64_t g = t0 * K + e;
      rs[e] = widen(r[g]);
      ks[e] = widen(k[g]);
      ws[e] = widen(w[g]);
    }
    for (int tt = 0; tt < nt; ++tt)
      vs[tt * kWkvThreads + threadIdx.x] = live ? widen(v[(t0 + tt) * V + col]) : 0.f;
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const float vv = vs[tt * kWkvThreads + threadIdx.x];
      const float4* r4 = reinterpret_cast<const float4*>(rs + tt * K);
      const float4* k4 = reinterpret_cast<const float4*>(ks + tt * K);
      const float4* w4 = reinterpret_cast<const float4*>(ws + tt * K);
      const float4* u4 = reinterpret_cast<const float4*>(us);
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i4 = 0; i4 < K / 4; ++i4) {
        const float4 rq = r4[i4], kq = k4[i4], wq = w4[i4], uq = u4[i4];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
        const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
        const float uu[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * i4 + j;
          const float kv = round_to<T>(kk[j] * vv);
          o[j] = fmaf(rr[j], S[i] + round_to<T>(uu[j] * kv), o[j]);
          S[i] = fmaf(ww[j], S[i], kv);
        }
      }
      out[(t0 + tt) * V + col] = narrow<T>((o[0] + o[1]) + (o[2] + o[3]));
    }
  }
}

// ---------------------------------------------------------------------------
// K9: forward flash attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel: grid (BH, Tq / 128, Tk / 128), m, l and the accumulator in
// VMEM scratch carried across the kv grid dimension).
// Bound on the H100: operations (4 d flops per unmasked (q, k) pair against
// 4 d elements per query row moved: hundreds of flops per byte at these
// sequence lengths).
// Design: one block of 256 threads per (bh, 64-query tile); the sequential
// kv grid dimension becomes a loop over 64-key tiles, with m, l and the
// float32 output rows in registers.  The scaled query tile, K^T and V tiles
// and the probabilities P live in shared memory (row strides padded by one
// word, so the column reads of K^T and P hit distinct banks); above 48 KB
// (d >= 64) the launcher raises the dynamic shared-memory limit.  Thread
// (rg, cg) of the 16 x 16 grid owns query rows rg + 16 i (i < 4) and score
// columns cg + 16 j (j < 4), then output columns cg + 16 j (j < d / 16), so
// the 16 threads of a row are one half-warp and reduce the row max and sum
// with shuffles.  The products run on the FP32 pipes (no tensor cores yet:
// a later change).  Key tiles wholly above the causal diagonal or below the
// window of the whole query tile are skipped; a row whose m is still the
// sentinel takes p = 1 on a masked tile exactly as the TPU kernel does, and
// the first tile with a valid key wipes that out with alpha = 0; a row with
// no valid key at all gets the TPU kernel's mean of v from a second pass
// that runs only in the query tiles that hold such a row.  Query tiles run
// heaviest first (the causal triangle's long rows).
// ---------------------------------------------------------------------------
constexpr int kFaThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;

template <int D>
constexpr size_t fa_smem_floats() {
  return kBQ * (D + 1) + D * (kBK + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int64_t Tq, int64_t Tk, int causal, int64_t window,
                       float scale, float softcap) {
  constexpr int QS = D + 1, KS = kBK + 1, PS = kBK + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBQ][QS]  q * scale, rounded to T
  float* Kt = Qs + kBQ * QS;         // [D][KS]    K^T
  float* Vs = Kt + D * KS;           // [kBK][D]
  float* Ps = Vs + kBK * D;          // [kBQ][PS]  p, rounded to T

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int64_t bh = blockIdx.y;
  const int64_t ntq = (Tq + kBQ - 1) / kBQ;
  const int64_t q0 = (ntq - 1 - blockIdx.x) * kBQ;
  q += bh * Tq * D;
  out += bh * Tq * D;
  k += bh * Tk * D;
  v += bh * Tk * D;

  for (int e = tid; e < kBQ * D; e += kFaThreads) {
    const int rr = e / D, c = e - rr * D;
    const int64_t qi = q0 + rr;
    const float x = qi < Tq ? widen(q[qi * D + c]) : 0.f;
    Qs[rr * QS + c] = round_to<T>(x * scale);
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // the key tiles that hold a valid key for some row of this query tile
  int64_t k_end = Tk, k_begin = 0;
  if (causal && q0 + kBQ < k_end) k_end = q0 + kBQ;
  if (window > 0 && q0 - window + 1 > 0) k_begin = ((q0 - window + 1) / kBK) * kBK;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // Qs written / the previous tile's Kt, Vs, Ps read
    for (int e = tid; e < kBK * D; e += kFaThreads) {
      const int rr = e / D, c = e - rr * D;
      const int64_t ki = k0 + rr;
      const bool ok = ki < Tk;
      Kt[c * KS + rr] = ok ? widen(k[ki * D + c]) : 0.f;
      Vs[rr * D + c] = ok ? widen(v[ki * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg + 16 * i) * QS + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[dd * KS + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qi = q0 + rg + 16 * i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kj = k0 + cg + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kj < Tk;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        x = ok ? x : kNegInf;
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        Ps[(rg + 16 * i) * PS + cg + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float alpha = expf(m[i] - mn);
      l[i] = alpha * l[i] + ps;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      m[i] = mn;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * D + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // A row with no valid key at all (a window that ends before the keys do)
  // is still at the sentinel.  The TPU kernel gives it p = 1 on every key,
  // so its output is the plain mean of v over all Tk keys: redo it here
  // (the tiles above skipped some keys and counted the ragged tile's padding).
  bool empty = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) empty = empty || (q0 + rg + 16 * i < Tq && m[i] == kNegInf);
  if (__syncthreads_or(empty)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m[i] != kNegInf) continue;
      l[i] = static_cast<float>(Tk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    }
    for (int64_t k0 = 0; k0 < Tk; k0 += kBK) {
      __syncthreads();   // the previous tile's Vs read
      for (int e = tid; e < kBK * D; e += kFaThreads) {
        const int64_t ki = k0 + e / D;
        Vs[e] = ki < Tk ? widen(v[k0 * D + e]) : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < kBK; ++c) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float vv = Vs[c * D + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (m[i] == kNegInf) acc[i][j] += vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qi = q0 + rg + 16 * i;
    if (qi >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[qi * D + cg + 16 * j] = narrow<T>(acc[i][j] / den);
  }
}

template <typename T, int K>
int launch_wkv6_k(const void* r, const void* k, const void* v, const void* w,
                  const void* u, void* out, int64_t BH, int64_t T_len,
                  int64_t V, void* stream) {
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((V + kWkvThreads - 1) / kWkvThreads));
  wkv6_kernel<T, K><<<grid, kWkvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), static_cast<T*>(out),
      T_len, V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wkv6(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* out, int64_t BH, int64_t T_len, int64_t K,
                int64_t V, void* stream) {
  switch (K) {   // rwkv6-3b's head is 64; the tests use 16 and 32
    case 16: return launch_wkv6_k<T, 16>(r, k, v, w, u, out, BH, T_len, V, stream);
    case 32: return launch_wkv6_k<T, 32>(r, k, v, w, u, out, BH, T_len, V, stream);
    case 64: return launch_wkv6_k<T, 64>(r, k, v, w, u, out, BH, T_len, V, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int launch_flash_d(const void* q, const void* k, const void* v, void* out,
                   int64_t BH, int64_t Tq, int64_t Tk, int causal,
                   int64_t window, float scale, float softcap, void* stream) {
  const size_t smem = fa_smem_floats<D>() * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((Tq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(BH));
  flash_attention_kernel<T, D><<<grid, kFaThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Tq, Tk, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int64_t BH, int64_t Tq, int64_t Tk, int64_t d, int causal,
                 int64_t window, double scale, double softcap, void* stream) {
  const float sc = static_cast<float>(scale), cap = static_cast<float>(softcap);
  switch (d) {   // the head dims of configs/archs.py (80, 128, 256) and the tests'
    case 16: return launch_flash_d<T, 16>(q, k, v, out, BH, Tq, Tk, causal, window, sc, cap, stream);
    case 32: return launch_flash_d<T, 32>(q, k, v, out, BH, Tq, Tk, causal, window, sc, cap, stream);
    case 64: return launch_flash_d<T, 64>(q, k, v, out, BH, Tq, Tk, causal, window, sc, cap, stream);
    case 80: return launch_flash_d<T, 80>(q, k, v, out, BH, Tq, Tk, causal, window, sc, cap, stream);
    case 128: return launch_flash_d<T, 128>(q, k, v, out, BH, Tq, Tk, causal, window, sc, cap, stream);
    case 256: return launch_flash_d<T, 256>(q, k, v, out, BH, Tq, Tk, causal, window, sc, cap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

#define MODEL_LAUNCHERS(T, SUFFIX)                                              \
  int wkv6_##SUFFIX(const void* r, const void* k, const void* v, const void* w, \
                    const void* u, void* out, int64_t BH, int64_t T_len,        \
                    int64_t K, int64_t V, void* stream) {                       \
    return launch_wkv6<T>(r, k, v, w, u, out, BH, T_len, K, V, stream);         \
  }                                                                             \
  int flash_attention_##SUFFIX(const void* q, const void* k, const void* v,     \
                               void* out, int64_t BH, int64_t Tq, int64_t Tk,   \
                               int64_t d, int causal, int64_t window,           \
                               double scale, double softcap, void* stream) {    \
    return launch_flash<T>(q, k, v, out, BH, Tq, Tk, d, causal, window, scale,  \
                           softcap, stream);                                    \
  }

MODEL_LAUNCHERS(float, f32)
MODEL_LAUNCHERS(__nv_bfloat16, bf16)

#undef MODEL_LAUNCHERS

}  // extern "C"
