// Hand-written Hopper (sm_90a) kernel of the model op wkv6: K8, the RWKV6
// recurrence.  (K9, flash attention, is in flash_attention.cu.)
//
// The kernel is templated on the element type (float or __nv_bfloat16) and
// on its head dimension, and is launched through an extern "C" function
// that returns the cudaError_t of the launch (cudaGetLastError() right
// after it).  The Python wrapper in repro_torch/kernels/wkv6.py checks
// shapes, dtypes and contiguity, allocates the output and passes the
// current PyTorch stream; the kernel never synchronises and allocates
// nothing.  All arithmetic is float32; bfloat16 inputs are widened on
// load, and the values the TPU kernel rounds to bfloat16 (k v^T and
// u k v^T) are rounded here too.
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

}  // namespace

extern "C" {

#define MODEL_LAUNCHERS(T, SUFFIX)                                              \
  int wkv6_##SUFFIX(const void* r, const void* k, const void* v, const void* w, \
                    const void* u, void* out, int64_t BH, int64_t T_len,        \
                    int64_t K, int64_t V, void* stream) {                       \
    return launch_wkv6<T>(r, k, v, w, u, out, BH, T_len, K, V, stream);         \
  }

MODEL_LAUNCHERS(float, f32)
MODEL_LAUNCHERS(__nv_bfloat16, bf16)

#undef MODEL_LAUNCHERS

}  // extern "C"
