// Hand-written Hopper (sm_90a) kernel of the model op wkv6: K8, the RWKV6
// recurrence.  (K9, flash attention, is in flash_attention.cu.)
//
// The kernel is templated on the element type (float or __nv_bfloat16), the
// head dimension K and the rows and columns of S a thread holds, and is launched
// through an extern "C" function that takes the launch plan of
// repro_torch/kernels/wkv6.py::launch_plan, refuses (cudaErrorInvalidValue)
// any plan it did not build, and returns the cudaError_t of the launch
// (cudaGetLastError() right after it).  The Python wrapper checks shapes,
// dtypes and contiguity, allocates the output and passes the current
// PyTorch stream; the kernel never synchronises and allocates nothing.
// All arithmetic is float32; bfloat16 inputs are widened in registers, and
// k v^T (and u k v^T) are rounded to bfloat16 as the TPU kernel rounds
// them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -Xptxas -v -c model_kernels.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// k * v as the inputs' dtype computes it, returned as float32.  bfloat16: k
// and v are widened bfloat16 values (low 16 bits zero), so one packed
// bfloat16 multiply of the two registers rounds the product of the high
// halves to bfloat16 and multiplies the zero low halves to +0: the result,
// read as a float32, is the rounded product, in one instruction.
template <typename T> __device__ __forceinline__ float mul_kv(float k, float v);
template <> __device__ __forceinline__ float mul_kv<float>(float k, float v) {
  return k * v;
}
template <> __device__ __forceinline__ float mul_kv<__nv_bfloat16>(float k, float v) {
  uint32_t p;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p)
      : "r"(__float_as_uint(k)), "r"(__float_as_uint(v)));
  return __uint_as_float(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one asynchronous copy of `bytes` (16, 8 or 4) from global to shared
// memory; src_bytes = 0 fills the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes,
                                         int src_bytes) {
  const uint32_t d = smem_u32(dst);
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
      break;
    default:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// K8: RWKV6 WKV recurrence.
//
// Replaces the TPU kernel repro/kernels/wkv6.py::wkv6 (its pallas_call body:
// grid (BH, T / 128), S in VMEM scratch carried across the time blocks).
//
// Bound on the H100: the bytes in float32 (r, k, w, v read once, out written
// once: 0.50 ms at rwkv6-3b), the FP32 pipes in bfloat16.  In float32 the
// kernel computes the factored form
//     out_t = r_t^T S_{t-1} + (sum_i r_ti u_i k_ti) v_t,
// one multiply (k v) and two FMAs (r S into the output, w S + kv) an
// element of S and step.  bfloat16 keeps the TPU kernel's rounding of
// u (k v) to bfloat16 element by element, two more instructions an
// element: the factored sum differs from it by more than the bfloat16
// tolerance where the bonus dominates a row and cancels (PERF.md, K8).
//
// On the card the step loop issues at about half the FP32 rate, and the
// shared-memory loads of each step's operands and the shuffles add to it
// (PERF.md, K8), so the design cuts both per element of S:
//   * S (K x V per head) lives in registers, R rows by C columns a thread
//     (4 x 8 in float32, 8 x 4 in bfloat16).  A column's K rows are split
//     over L = K / R neighbouring lanes; lane g of a column group holds
//     rows 4 L q + 4 g + e (q < R / 4, e < 4), so one 16-byte load of r, k
//     or w (8 bytes in bfloat16, widened in registers) feeds 4 C FMAs and
//     the L lanes of a group read L consecutive pieces.  The next step's
//     operands are read before this step's arithmetic.
//   * The partial output sums of a column are reduced over its L lanes with
//     __shfl_xor_sync: while a lane holds more than one column, each stage
//     sends half of them to its partner and keeps the other half (C/2 +
//     C/4 + ... shuffles, not C log2 L).  In float32 each lane adds (sum
//     over its rows of r u k) v_t to its partial sums, so the shuffles add
//     the bonus too, with no pass or load of its own.  Columns past V hold
//     zero data and join every shuffle and barrier.
//   * A block holds `block_cols` columns of one head (the plan's width:
//     a whole head at rwkv6-3b, so r, k and w are copied once a head).
//   * Time tiles of kWkvTile steps of r, k, w and v go to shared memory by
//     cp.async, the next tile in flight while the current one is walked
//     (two stages; the access width, 16, 8 or 4 bytes, is the plan's, from
//     V and the pointers; bfloat16 data whose rows are only 2-byte aligned
//     is copied element by element).
// ---------------------------------------------------------------------------
constexpr int kWkvTile = 32;       // time steps a tile
constexpr int kWkvStages = 2;      // tiles in shared memory: one walked, one loading
constexpr int kWkvMaxThreads = 256;
constexpr int64_t kWkvMaxSmem = 232448;   // shared memory a block can opt in to (H100)
constexpr unsigned kFull = 0xffffffffu;

// shared bytes of a block: the tiles of every stage (r, k, w: kWkvTile x K
// each; v: kWkvTile x block_cols) in the inputs' dtype
__host__ __device__ constexpr int64_t wkv_smem_bytes(int64_t K, int64_t block_cols,
                                                     int64_t itemsize) {
  return kWkvStages * kWkvTile * (3 * K + block_cols) * itemsize;
}

// four consecutive elements of a shared tile as float32 (one 16-byte load
// in float32, one 8-byte load and four bit operations in bfloat16, whose
// widened values have zero low halves)
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(a.x << 16); x[1] = __uint_as_float(a.x & 0xffff0000u);
  x[2] = __uint_as_float(a.y << 16); x[3] = __uint_as_float(a.y & 0xffff0000u);
}

// one step's operands of a thread: r, k, w of its R rows, v of its C columns
template <typename T, int K, int R, int C>
struct StepIn {
  float r[R], k[R], w[R], v[C];
  __device__ __forceinline__ void load(const T* tile, int tt, int Vb, int g, int c0) {
    constexpr int L = K / R;
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int row = tt * K + 4 * L * q + 4 * g;
      load4(tile + row, r + 4 * q);
      load4(tile + kWkvTile * K + row, k + 4 * q);
      load4(tile + 2 * kWkvTile * K + row, w + 4 * q);
    }
    const T* vs = tile + 3 * kWkvTile * K + tt * Vb + c0;
#pragma unroll
    for (int j = 0; j < C; j += 4) load4(vs + j, v + j);
  }
};

// Sums o[0..N) over the L lanes of a column group (OFF: the stage's lane
// distance).  While N > 1 a stage sends the half of its columns that the
// partner keeps (the lane whose bit OFF is set keeps the upper half);
// afterwards o[0..) holds the sums of the columns from column_start(g).
template <int N, int OFF, int L>
__device__ __forceinline__ void lane_sum(float* o, int g) {
  if constexpr (OFF < L) {
    if constexpr (N > 1) {
      constexpr int half = N / 2;
      const bool hi = (g & OFF) != 0;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = hi ? o[j] : o[j + half];
        const float keep = hi ? o[j + half] : o[j];
        o[j] = keep + __shfl_xor_sync(kFull, send, OFF);
      }
      lane_sum<half, OFF * 2, L>(o, g);
    } else {
      o[0] += __shfl_xor_sync(kFull, o[0], OFF);
      lane_sum<1, OFF * 2, L>(o, g);
    }
  }
}

// the first of the columns lane g of a group holds after lane_sum<C, 1, L>
template <int C, int L>
__device__ __forceinline__ int column_start(int g) {
  int start = 0;
#pragma unroll
  for (int off = 1, n = C; off < L && n > 1; off *= 2, n /= 2)
    if (g & off) start += n / 2;
  return start;
}

// one chunk of `bytes` (16, 8, 4 by cp.async; 2, a bfloat16 element, by a
// plain load) from global to shared memory, or zeros where !ok
template <typename T>
__device__ __forceinline__ void copy_chunk(T* d, const T* s, int bytes, bool ok) {
  if (bytes >= 4) {
    cp_async(d, s, bytes, ok ? bytes : 0);
  } else {
    *reinterpret_cast<uint16_t*>(d) = ok ? *reinterpret_cast<const uint16_t*>(s) : 0;
  }
}

// n contiguous elements (a whole number of chunks) into shared memory
template <typename T>
__device__ __forceinline__ void load_flat(T* dst, const T* src, int n, int bytes,
                                          int tid, int nthreads) {
  if (bytes == 16) {                 // the plan's usual width
    constexpr int per = 16 / sizeof(T);
    for (int e = tid * per; e < n; e += nthreads * per) cp_async(dst + e, src + e, 16, 16);
    return;
  }
  const int per = bytes / static_cast<int>(sizeof(T));
  for (int e = tid * per; e < n; e += nthreads * per)
    copy_chunk(dst + e, src + e, bytes, true);
}

// rows x width elements (row stride `stride` in global memory) into a
// dense shared tile; chunks at or past `valid` in a row are zeros
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int rows, int width,
                                          int64_t stride, int valid, int bytes,
                                          int tid, int nthreads) {
  const int per = bytes / static_cast<int>(sizeof(T));
  const int chunks = width / per;
  for (int c = tid; c < rows * chunks; c += nthreads) {
    const int row = c / chunks;
    const int col = (c - row * chunks) * per;
    const bool ok = col < valid;
    copy_chunk(dst + row * width + col, src + row * stride + (ok ? col : 0), bytes, ok);
  }
}

template <typename T, int K, int R, int C>
__global__ void __launch_bounds__(kWkvMaxThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const T* __restrict__ u, T* __restrict__ out, int64_t T_len,
            int64_t V, int64_t H, int block_cols, int nvb, int bytes) {
  constexpr int L = K / R;             // lanes a column
  static_assert(R * L == K && R % 4 == 0 && L >= 2 && L <= 32 && 32 % L == 0 &&
                    C % 4 == 0,
                "a column's rows must split over two or more lanes of one warp");
  constexpr bool kWiden = sizeof(T) == 2;
  constexpr int kHeld = C > L ? C / L : 1;              // columns a lane ends with
  extern __shared__ __align__(16) unsigned char wkv_smem[];

  const int Vb = block_cols;
  const int64_t stage_elems = static_cast<int64_t>(kWkvTile) * (3 * K + Vb);
  T* raw = reinterpret_cast<T*>(wkv_smem);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane & (L - 1);                         // lane in the group
  const int c0 = (warp * (32 / L) + lane / L) * C;      // first column, in the block
  const int64_t bh = blockIdx.x / nvb;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x % nvb) * Vb;
  const int valid = static_cast<int>(V - col0 < Vb ? V - col0 : Vb);
  r += bh * T_len * K;
  k += bh * T_len * K;
  w += bh * T_len * K;
  v += bh * T_len * V + col0;
  u += (bh % H) * K;
  // the columns this lane writes: one lane of each column's group
  const int first = c0 + column_start<C, L>(g);
  const bool writer = g < (C < L ? C : L);
  T* orow = out + bh * T_len * V + col0 + first;
  bool live[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j) live[j] = writer && first + j < valid;

  float ur[R];                                          // u of this lane's rows
#pragma unroll
  for (int i = 0; i < R; ++i) ur[i] = widen(u[4 * L * (i / 4) + 4 * g + i % 4]);

  float S[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) S[i][j] = 0.f;

  auto issue = [&](int64_t t0, int nt, T* st) {
    const int64_t rk = t0 * K;
    load_flat(st, r + rk, nt * K, bytes, tid, nthreads);
    load_flat(st + kWkvTile * K, k + rk, nt * K, bytes, tid, nthreads);
    load_flat(st + 2 * kWkvTile * K, w + rk, nt * K, bytes, tid, nthreads);
    load_rows(st + 3 * kWkvTile * K, v + t0 * V, nt, Vb, V, valid, bytes, tid, nthreads);
    cp_async_commit();
  };

  const int64_t ntiles = (T_len + kWkvTile - 1) / kWkvTile;
  issue(0, static_cast<int>(T_len < kWkvTile ? T_len : kWkvTile), raw);
  for (int64_t n = 0; n < ntiles; ++n) {
    const int64_t t0 = n * kWkvTile;
    const int nt = static_cast<int>(T_len - t0 < kWkvTile ? T_len - t0 : kWkvTile);
    const T* tile = raw + (n & 1) * stage_elems;
    cp_async_wait_all();
    __syncthreads();                 // tile n is in; tile n - 1 has been read
    if (n + 1 < ntiles) {
      const int64_t t1 = t0 + kWkvTile;
      issue(t1, static_cast<int>(T_len - t1 < kWkvTile ? T_len - t1 : kWkvTile),
            raw + ((n + 1) & 1) * stage_elems);
    }
    StepIn<T, K, R, C> cur;
    cur.load(tile, 0, Vb, g, c0);
#pragma unroll 2
    for (int tt = 0; tt < nt; ++tt) {
      // the next step's operands are read before this step's arithmetic
      StepIn<T, K, R, C> nxt;
      nxt.load(tile, tt + 1 < nt ? tt + 1 : tt, Vb, g, c0);
      float o[C];
#pragma unroll
      for (int j = 0; j < C; ++j) o[j] = 0.f;
      if constexpr (kWiden) {
        // bfloat16: the TPU kernel's rounding of u kv, element by element
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const float kv = mul_kv<T>(cur.k[i], cur.v[j]);
            o[j] = fmaf(cur.r[i], S[i][j] + mul_kv<T>(ur[i], kv), o[j]);
            S[i][j] = fmaf(cur.w[i], S[i][j], kv);
          }
        }
      } else {
        // float32, factored: this lane's share of the bonus, the sum over
        // its rows of r u k, times v is added to its partial sums
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          a = fmaf(cur.r[i], ur[i] * cur.k[i], a);
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const float kv = cur.k[i] * cur.v[j];
            o[j] = fmaf(cur.r[i], S[i][j], o[j]);
            S[i][j] = fmaf(cur.w[i], S[i][j], kv);
          }
        }
#pragma unroll
        for (int j = 0; j < C; ++j) o[j] = fmaf(a, cur.v[j], o[j]);
      }
      lane_sum<C, 1, L>(o, g);
#pragma unroll
      for (int j = 0; j < kHeld; ++j)
        if (live[j]) orow[j] = narrow<T>(o[j]);
      orow += V;
      cur = nxt;
    }
  }
}

template <typename T>
using WkvKernel = void (*)(const T*, const T*, const T*, const T*, const T*, T*,
                           int64_t, int64_t, int64_t, int, int, int);

// an instantiation, with its attributes set once per device: dynamic shared
// memory up to the card's opt-in limit and the largest carveout, so that
// the plan's blocks fit an SM together
template <typename T, int K, int R, int C>
cudaError_t wkv_ready(WkvKernel<T>* kernel) {
  static std::atomic<uint64_t> ready{0};  // a bit per device
  *kernel = wkv6_kernel<T, K, R, C>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (err != cudaSuccess || (ready.load(std::memory_order_acquire) & bit))
    return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

// The thread tile the launcher builds for each dtype (kernels/wkv6.py:
// TILES): rows x columns of S a thread holds, for K in {16, 32, 64};
// cudaErrorInvalidValue for any other
template <typename T> struct WkvTile;
template <> struct WkvTile<float> { static constexpr int R = 4, C = 8; };
template <> struct WkvTile<__nv_bfloat16> { static constexpr int R = 8, C = 4; };

template <typename T, int K>
cudaError_t wkv_kernel_k(int64_t rows, int64_t cols, WkvKernel<T>* kernel) {
  constexpr int R = WkvTile<T>::R, C = WkvTile<T>::C;
  if (rows != R || cols != C) return cudaErrorInvalidValue;
  return wkv_ready<T, K, R, C>(kernel);
}

template <typename T>
cudaError_t wkv_kernel(int64_t K, int64_t rows, int64_t cols, WkvKernel<T>* kernel) {
  switch (K) {   // rwkv6-3b's head is 64; the tests use 16 and 32
    case 16: return wkv_kernel_k<T, 16>(rows, cols, kernel);
    case 32: return wkv_kernel_k<T, 32>(rows, cols, kernel);
    case 64: return wkv_kernel_k<T, 64>(rows, cols, kernel);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// Checks the plan against what was built and what these inputs allow (the
// rules of kernels/wkv6.py: launch_plan) before any launch.
template <typename T>
int launch_wkv6(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* out, int64_t BH, int64_t T_len, int64_t K,
                int64_t V, int64_t H, int64_t rows, int64_t cols, int64_t block_cols,
                int64_t threads, int64_t tile, int64_t stages, int64_t smem,
                int64_t bytes, int64_t grid, void* stream) {
  const int64_t isz = sizeof(T);
  if (BH < 1 || T_len < 1 || V < 1 || H < 1 || BH % H != 0 || rows < 1 ||
      cols < 1 || K % rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t lanes = K / rows;
  const int64_t warp_cols = 32 / lanes * cols;
  if (tile != kWkvTile || stages != kWkvStages || block_cols < warp_cols ||
      block_cols % warp_cols != 0 || threads != block_cols / cols * lanes ||
      threads > kWkvMaxThreads || smem != wkv_smem_bytes(K, block_cols, isz) ||
      smem > kWkvMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nvb = (V + block_cols - 1) / block_cols;
  if (grid != BH * nvb || grid > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((bytes != 16 && bytes != 8 && bytes != 4 && bytes != 2) || bytes < isz ||
      (V * isz) % bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {r, k, v, w})
    if (!aligned(p, bytes)) return static_cast<int>(cudaErrorInvalidValue);
  WkvKernel<T> kernel = nullptr;
  const cudaError_t err = wkv_kernel<T>(K, rows, cols, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), static_cast<unsigned>(threads),
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), static_cast<T*>(out), T_len,
      V, H, static_cast<int>(block_cols), static_cast<int>(nvb), static_cast<int>(bytes));
  return static_cast<int>(cudaGetLastError());
}

// blocks of a K8 launch plan that one SM holds at once
template <typename T>
int wkv6_occupancy(int64_t K, int64_t rows, int64_t cols, int64_t threads,
                   int64_t smem, int64_t* blocks) {
  WkvKernel<T> kernel = nullptr;
  cudaError_t err = wkv_kernel<T>(K, rows, cols, &kernel);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, static_cast<int>(threads), static_cast<size_t>(smem));
  *blocks = n;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

#define MODEL_LAUNCHERS(T, SUFFIX)                                                   \
  int wkv6_##SUFFIX(const void* r, const void* k, const void* v, const void* w,      \
                    const void* u, void* out, int64_t BH, int64_t T_len, int64_t K,  \
                    int64_t V, int64_t H, int64_t rows, int64_t cols,                \
                    int64_t block_cols, int64_t threads, int64_t tile,               \
                    int64_t stages, int64_t smem, int64_t bytes, int64_t grid,       \
                    void* stream) {                                                  \
    return launch_wkv6<T>(r, k, v, w, u, out, BH, T_len, K, V, H, rows, cols,        \
                          block_cols, threads, tile, stages, smem, bytes, grid,      \
                          stream);                                                   \
  }                                                                                  \
  int wkv6_occupancy_##SUFFIX(int64_t K, int64_t rows, int64_t cols,                 \
                              int64_t threads, int64_t smem, int64_t* blocks) {      \
    return wkv6_occupancy<T>(K, rows, cols, threads, smem, blocks);                  \
  }

MODEL_LAUNCHERS(float, f32)
MODEL_LAUNCHERS(__nv_bfloat16, bf16)

#undef MODEL_LAUNCHERS

}  // extern "C"
