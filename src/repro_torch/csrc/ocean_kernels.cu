// Hand-written Hopper (sm_90a) kernels of the ocean step and its step
// boundary.
//
// Seven kernels, each templated on float / double, each launched through an
// extern "C" function that returns the cudaError_t of the launch (the value
// of cudaGetLastError() right after it).  The Python wrappers in
// repro_torch/kernels/{matrix_free,column_solve,horizontal_flux,
// cell_transpose,tridiag}.py check shapes, dtypes and contiguity, allocate
// every output and scratch buffer, and pass the current PyTorch stream; the
// kernels never synchronise and allocate nothing.
//
// Layout: K1-K4 and K7 take the stepper's own structure-of-arrays layout
// with the column (triangle) index innermost, so threads of neighbouring
// columns read neighbouring addresses across a warp (coalesced).  K1, K2,
// K4 and K7 run one thread per column and mask a ragged last block with
// `if (idx >= n) return;` instead of 128-column padding; K3 runs six
// threads per column, which meet at barriers, so its ragged tile solves
// identity systems instead of returning.
// K5/K6 convert between that layout and the 128-column cell layout
// (n_cells, rows, 128) of the step boundary.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -o libocean_kernels.so ocean_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;

inline unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// K1 / K2: matrix-free column sweeps for r (top-down) and w (bottom-up).
//
// Replaces the TPU kernels repro/kernels/matrix_free.py::solve_r_cell
// (_r_kernel) and ::solve_w_cell (_w_kernel).
// Bound on the H100: memory.  Each (component, triangle) column reads its
// nl*6 RHS values once and writes nl*6 results once, with ~34 flops per
// layer against 48 bytes (f32): far below the ridge of ~20 flops/byte.
// Design: one thread per (component, triangle); 12/area is read once, the
// 3-value carry stays in registers across the layer loop, and the component
// index is part of the thread index, so no fold/tile copies are needed.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void minv_faces(const T* __restrict__ f, int64_t nt,
                                           T inv, T gt[3], T gb[3]) {
  T x[6];
#pragma unroll
  for (int n = 0; n < 6; ++n) x[n] = f[n * nt];
  const T st = x[0] + x[1] + x[2];
  const T sb = x[3] + x[4] + x[5];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gt[i] = inv * (x[i] - T(0.25) * st);
    gb[i] = inv * (x[3 + i] - T(0.25) * sb);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_r_kernel(const T* __restrict__ F, const T* __restrict__ area,
               const T* __restrict__ r_surf, T* __restrict__ out,
               int64_t K, int64_t nl, int64_t nt) {
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (idx >= K * nt) return;
  const int64_t k = idx / nt;
  const int64_t t = idx - k * nt;
  const T inv = T(12) / area[t];
  T rb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rb[i] = r_surf[(k * 3 + i) * nt + t];
  for (int64_t l = 0; l < nl; ++l) {
    const int64_t base = (k * nl + l) * 6 * nt + t;
    T gt[3], gb[3];
    minv_faces(F + base, nt, inv, gt, gb);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      rb[i] = rb[i] - gt[i] - gb[i];
      out[base + i * nt] = rb[i] + T(2) * gb[i];
      out[base + (3 + i) * nt] = rb[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
solve_w_kernel(const T* __restrict__ F, const T* __restrict__ area,
               const T* __restrict__ w_floor, T* __restrict__ out,
               int64_t K, int64_t nl, int64_t nt) {
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (idx >= K * nt) return;
  const int64_t k = idx / nt;
  const int64_t t = idx - k * nt;
  const T inv = T(12) / area[t];
  T wt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    wt[i] = w_floor ? w_floor[(k * 3 + i) * nt + t] : T(0);
  for (int64_t l = nl - 1; l >= 0; --l) {
    const int64_t base = (k * nl + l) * 6 * nt + t;
    T gt[3], gb[3];
    minv_faces(F + base, nt, inv, gt, gb);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      wt[i] = wt[i] + gt[i] + gb[i];
      out[base + i * nt] = wt[i];
      out[base + (3 + i) * nt] = wt[i] - T(2) * gt[i];
    }
  }
}

// ---------------------------------------------------------------------------
// K3: block-tridiagonal (6x6 blocks) column solve, k right-hand sides.
//
// Replaces the TPU kernel repro/kernels/column_solve.py::block_thomas_cell
// (_block_thomas_kernel, _solve6).
// Bound on the H100: memory.  The compulsory bytes are the blocks the
// solve uses (D_l of every layer, L_l of every layer but the first, U_l
// of every layer but the last; 36 values each) and the k right-hand sides
// read once, and the k solutions written once, per layer and column; the
// ~1.6 kflop per layer and column put it at ~1.5 flops/byte in float64,
// far below the ridge.
// Recurrence: S_l = D_l - L_l C_{l-1}; [C_l | y_l] = S_l^{-1} [U_l | b_l -
// L_l y_{l-1}] by an unpivoted Gauss-Jordan elimination (the operators are
// diagonally dominant); x_{nl-1} = y_{nl-1}, x_l = y_l - C_l x_{l+1}.
// Design, to move only the compulsory bytes:
//  - a block is a tile of TC consecutive columns with 6 * TC threads;
//    thread (r, c) = threadIdx (r * TC + c) serves column c, and a warp's
//    lanes take neighbouring columns, so every load (row r of L_l and D_l,
//    column r of U_l, rhs[., l, r]) is coalesced; the loads and the stores
//    of x stream (evict-first: each byte is touched once), and layer
//    l + 1's loads are issued before layer l's elimination;
//  - [C_l | y_l] of every layer stays in the tile's shared memory (ONCHIP),
//    laid out [l][row][6 + k][TC] so that a warp's lanes hit neighbouring
//    banks; nothing but x goes to device memory, and each x value is
//    stored once.  Where the column is too deep for shared memory, the
//    launch plan takes the same kernel with ONCHIP = false, which keeps
//    [C_l | y_l] in a global scratch that the wrapper allocates, laid out
//    the same way per tile, and exchanges rows in one shared slot;
//  - layer l: thread (r, c) forms row r of S_l and of b_l - L_l y_{l-1}
//    from [C_{l-1} | y_{l-1}] and publishes both, into layer l + 1's slot,
//    which is not written yet (the last layer into its own, behind one
//    more barrier); after one barrier every thread reads all of S_l and
//    runs the elimination in registers on its own columns of the right-hand
//    side: column r of U_l and, for r < k, column r of the y part.  Each
//    thread so repeats the elimination of S_l (6 divisions, ~100 FMAs), but
//    the elimination needs no barrier: a distributed one (each pivot row
//    published by its owner, 6 barriers a layer) was held by that serial
//    chain (PERF.md).  The order of operations on every value is the plain
//    version's (T(1) / S[col][col], then multiplies);
//  - the backward sweep is row-wise: thread (r, c) forms x_l[r] from row r
//    of C_l and x_{l+1}, and writes it over y_l[r] for the layer below;
//  - lo[0] and up[nl-1] are not read (they multiply a zero carry, or give
//    a C_{nl-1} that the backward sweep never uses);
//  - columns past nt take part in every barrier with the identity system
//    (D = I, L = U = 0, b = 0), as the TPU kernel pads; only their loads
//    and stores are masked.
// The launch plan (tile width, variant, shared bytes, grid) is computed in
// Python (kernels/column_solve.py: launch_plan) and checked by the launcher.
// ---------------------------------------------------------------------------
template <typename T, int K>
struct ThomasLoads {   // what thread (r, c) reads of one layer
  T L[6], D[6];        // row r of L_l and D_l
  T U[6];              // column r of U_l
  T B[K];              // rhs[q, l, r]
};

template <typename T, int K, int TC, bool ONCHIP>
__global__ void __launch_bounds__(6 * TC)
block_thomas_kernel(const T* __restrict__ lo, const T* __restrict__ dg,
                    const T* __restrict__ up, const T* __restrict__ rhs,
                    T* __restrict__ x, T* __restrict__ scratch, int nl,
                    int64_t nt) {
  constexpr int W = 6 + K;                     // a row of [C | y]
  constexpr int kSlot = 6 * W * TC;            // one layer's [C | y]
  extern __shared__ __align__(16) unsigned char thomas_smem[];
  const int r = threadIdx.x / TC;
  const int c = threadIdx.x % TC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * TC + c;
  const bool live = t < nt;
  T* const sm = reinterpret_cast<T*>(thomas_smem) + c;
  T* const store =
      ONCHIP ? sm : scratch + static_cast<int64_t>(blockIdx.x) * nl * kSlot + c;
  const int64_t rs = 6 * nt;                   // layer stride of rhs / x
  const int64_t ks = nl * rs;                  // component stride of rhs / x

  ThomasLoads<T, K> n;
  auto load = [&](int l) {
    const int64_t o = static_cast<int64_t>(l) * 36 * nt + t;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      n.L[m] = live && l > 0 ? __ldcs(lo + o + (r * 6 + m) * nt) : T(0);
      n.D[m] = live ? __ldcs(dg + o + (r * 6 + m) * nt) : T(m == r ? 1 : 0);
      n.U[m] = live && l < nl - 1 ? __ldcs(up + o + (m * 6 + r) * nt) : T(0);
    }
#pragma unroll
    for (int q = 0; q < K; ++q)
      n.B[q] = live ? __ldcs(rhs + q * ks + l * rs + r * nt + t) : T(0);
  };

  load(0);
  for (int l = 0; l < nl; ++l) {
    T* const out = store + static_cast<int64_t>(l) * kSlot;
    const bool ahead = l + 1 < nl;             // exchange in the next slot
    T* const work = !ONCHIP ? sm : (ahead ? out + kSlot : out);
    const T* const prev = store + static_cast<int64_t>(l > 0 ? l - 1 : 0) * kSlot;
    // row r of S_l = D_l - L_l C_{l-1} and of b_l - L_l y_{l-1}
    T acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = T(0);
    if (l > 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
#pragma unroll
        for (int m = 0; m < 6; ++m) acc[w] += n.L[m] * prev[(m * W + w) * TC];
      }
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) work[(r * W + j) * TC] = n.D[j] - acc[j];
#pragma unroll
    for (int q = 0; q < K; ++q) work[(r * W + 6 + q) * TC] = n.B[q] - acc[6 + q];
    T Rc[6], Ry[6];                            // column r of U_l and of the y part
#pragma unroll
    for (int i = 0; i < 6; ++i) Rc[i] = n.U[i];
    if (ahead) load(l + 1);                    // in flight during the elimination
    __syncthreads();
    T S[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) S[i][j] = work[(i * W + j) * TC];
      Ry[i] = r < K ? work[(i * W + 6 + r) * TC] : T(0);
    }
    if (ONCHIP && !ahead) __syncthreads();     // the slot is overwritten below
    // unpivoted Gauss-Jordan: S -> I, [Rc | Ry] -> S^{-1} [Rc | Ry]; the
    // entries left of the diagonal never reach C or y and are not updated
#pragma unroll
    for (int col = 0; col < 6; ++col) {
      const T inv = T(1) / S[col][col];
#pragma unroll
      for (int j = col + 1; j < 6; ++j) S[col][j] *= inv;
      Rc[col] *= inv;
      Ry[col] *= inv;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        if (i == col) continue;
        const T f = S[i][col];
#pragma unroll
        for (int j = col + 1; j < 6; ++j) S[i][j] -= f * S[col][j];
        Rc[i] -= f * Rc[col];
        Ry[i] -= f * Ry[col];
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      out[(i * W + r) * TC] = Rc[i];
      if (r < K) out[(i * W + 6 + r) * TC] = Ry[i];
    }
    __syncthreads();
  }
  // backward sweep: x_{nl-1} = y_{nl-1}; x_l = y_l - C_l x_{l+1}, with x_l
  // written over y_l in the store for the layer below
  T xr[K];
  const T* const last = store + static_cast<int64_t>(nl - 1) * kSlot + r * W * TC;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    xr[q] = last[(6 + q) * TC];
    if (live) __stcs(x + q * ks + (nl - 1) * rs + r * nt + t, xr[q]);
  }
  for (int l = nl - 2; l >= 0; --l) {
    const T* const above = store + static_cast<int64_t>(l + 1) * kSlot;
    T* const row = store + static_cast<int64_t>(l) * kSlot + r * W * TC;
    T xa[6][K];
#pragma unroll
    for (int m = 0; m < 6; ++m)
#pragma unroll
      for (int q = 0; q < K; ++q) xa[m][q] = above[(m * W + 6 + q) * TC];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      T acc = T(0);
#pragma unroll
      for (int m = 0; m < 6; ++m) acc += row[m * TC] * xa[m][q];
      xr[q] = row[(6 + q) * TC] - acc;
    }
    if (l > 0) {
#pragma unroll
      for (int q = 0; q < K; ++q) row[(6 + q) * TC] = xr[q];
    }
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (live) __stcs(x + q * ks + l * rs + r * nt + t, xr[q]);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4: fused lateral upwind advective flux term <<phi f_up speed J_l>>.
//
// Replaces the TPU kernel repro/kernels/horizontal_flux.py::lateral_flux_cell
// (_lateral_flux_kernel).
// Bound on the H100: memory.  Per (field, layer, triangle) it reads 6 nodal
// values, 12 pre-gathered neighbour values and 12 flux speeds (shared by
// the k fields), and writes 6 values, with ~300 flops: about 3 flops/byte
// in f32, below the ridge.  Design: one thread per (field, layer,
// triangle): the layers are independent in this term, so k*nl*nt threads
// fill the card; the 12-qp intermediates (zeta interpolation, edge
// interpolation, upwind select, speed multiply, weighted scatter onto the
// 6 nodes) never leave registers.  The speed is indexed without the field
// axis, so it is not tiled.  The quadrature constants come from the
// caller (repro_torch/core/geometry.py), not from this file.
// ---------------------------------------------------------------------------
template <typename T>
struct LatConsts {
  T pz[2][2];  // PHI_ZQ[z][top|bot]
  T pa[2];     // node-a edge basis at the 2 edge Gauss points
  T pb[2];     // node-b edge basis
  T w[2];      // W_GAUSS
  int ea[3];   // EDGE_A
  int eb[3];   // EDGE_B
};

template <typename T>
__device__ __forceinline__ T pick3(const T a[3], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

template <typename T>
__device__ __forceinline__ void add3(T a[3], int i, T v) {
  if (i == 0) a[0] += v;
  else if (i == 1) a[1] += v;
  else a[2] += v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lateral_flux_kernel(const T* __restrict__ f, const T* __restrict__ fext,
                    const T* __restrict__ speed, const T* __restrict__ edge_len,
                    T* __restrict__ out, const LatConsts<T> c,
                    int64_t k, int64_t nl, int64_t nt) {
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (idx >= k * nl * nt) return;
  const int64_t kl = idx / nt;                 // field * nl + layer
  const int64_t t = idx - kl * nt;
  const int64_t l = kl % nl;
  const T* fp = f + kl * 6 * nt + t;
  const T* ep = fext + kl * 12 * nt + t;
  const T* sp = speed + l * 12 * nt + t;
  T ft[3], fb[3];
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    ft[n] = fp[n * nt];
    fb[n] = fp[(3 + n) * nt];
  }
  T acc_t[3] = {T(0), T(0), T(0)};
  T acc_b[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int na = c.ea[e];
    const int nb = c.eb[e];
    const T ft_a = pick3(ft, na), fb_a = pick3(fb, na);
    const T ft_b = pick3(ft, nb), fb_b = pick3(fb, nb);
    const T x0 = ep[(e * 4 + 0) * nt];         // facing a, top
    const T x1 = ep[(e * 4 + 1) * nt];         // facing a, bottom
    const T x2 = ep[(e * 4 + 2) * nt];         // facing b, top
    const T x3 = ep[(e * 4 + 3) * nt];         // facing b, bottom
    const T len = edge_len[e * nt + t];
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const T pzt = c.pz[z][0];
      const T pzb = c.pz[z][1];
      const T fi_a = pzt * ft_a + pzb * fb_a;
      const T fi_b = pzt * ft_b + pzb * fb_b;
      const T fe_a = pzt * x0 + pzb * x1;
      const T fe_b = pzt * x2 + pzb * x3;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const T fi = c.pa[q] * fi_a + c.pb[q] * fi_b;
        const T fe = c.pa[q] * fe_a + c.pb[q] * fe_b;
        const T s = sp[((z * 3 + e) * 2 + q) * nt];
        const T g = (s > T(0) ? fi : fe) * s * (len * c.w[q]);
        const T ca = c.pa[q] * g;
        const T cb = c.pb[q] * g;
        add3(acc_t, na, pzt * ca);
        add3(acc_t, nb, pzt * cb);
        add3(acc_b, na, pzb * ca);
        add3(acc_b, nb, pzb * cb);
      }
    }
  }
  T* op = out + kl * 6 * nt + t;
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    op[n * nt] = acc_t[n];
    op[(3 + n) * nt] = acc_b[n];
  }
}

// ---------------------------------------------------------------------------
// K5 / K6: SoA <-> cell layout (the step-boundary transform, paper §2.1.2).
//
// Replace the TPU kernels repro/kernels/cell_transpose.py::soa_to_cell
// (_to_cell_kernel) and ::cell_to_soa (_from_cell_kernel).
// Bound on the H100: memory.  A pure copy: each element is read once and
// written once, no arithmetic, so the byte bound is the only one.  In memory
// the transform is a block permutation, not a transpose: row r (= layer*6 +
// node) of the SoA field is cut into 128-element runs and run c lands at row
// r of cell c, so a run is contiguous on both sides (512 B in float32, 1 KiB
// in float64).
// What held a one-element-per-thread copy back is bytes in flight: one 4- or
// 8-byte load per thread lets an SM's 2,048 threads keep at most 8 KiB
// (float32) / 16 KiB (float64) of loads in flight, where 3.35 TB/s over
// ~0.7 us of DRAM latency needs ~18 KiB per SM.
// Design: the copy is cut into chunks, the 32 * VEC elements a warp moves
// with one VEC-wide access per lane (a run is 128 / (32 * VEC) chunks),
// numbered in the order of the side written: chunk u = (c * rows + r) *
// chunks_per_run + h for K5, (r * n_cells + c) * chunks_per_run + h for K6,
// so the warps of a block store to neighbouring addresses, and where a
// ragged nt puts SoA runs off the 32-byte sectors, the two halves of a
// sector are written by neighbouring warps at once.  Warp w of block b moves
// chunks b * 8 * N + i * 8 + w, i < N, and each thread issues all N loads
// before its first store.  Two variants, chosen by the launch plan in Python
// (kernels/cell_transpose.py: launch_plan) and checked by the launcher:
//  - vector: 16-byte accesses (float4 / double2), N = 8, so 128 B in flight
//    per thread; taken when nt % VEC == 0 and both pointers are 16-byte
//    aligned, so that every SoA run starts on a 16-byte boundary and the
//    live columns of the last cell are whole vectors.  Its loads and stores
//    stream (evict-first: every byte is touched once, and the float32 field
//    outgrows the 50 MB L2);
//  - scalar: one element per access, N = 16 (float32) / 8 (float64), so
//    64 B in flight per thread; for every other nt (a ragged mesh, a rank's
//    share of one) or pointer.  No cache hints: its runs are off the
//    sectors and lines on one side, whose other parts a neighbouring chunk
//    reads or writes later; evict-first loads slowed K6 by up to 13 % on an
//    H100 (PERF.md).
// The pad lanes of the last cell (column >= nt) are written as zeros by K5
// and neither read nor written by K6.  Chunk numbers are 32-bit (the plan
// keeps the grid's chunks under 2^32), so a chunk's cell and row cost two
// 32-bit divisions.
// ---------------------------------------------------------------------------
constexpr int kCell = 128;
constexpr int kCopyThreads = 256;
constexpr int kCopyWarps = kCopyThreads / 32;

template <typename T, int VEC> struct Access;
template <> struct Access<float, 1> { using type = float; };
template <> struct Access<float, 4> { using type = float4; };
template <> struct Access<double, 1> { using type = double; };
template <> struct Access<double, 2> { using type = double2; };

// the launch plans built (kernels/cell_transpose.py: launch_plan): elements
// per vector access, and accesses each thread issues before its first store
template <typename T> struct CopyPlan {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kVecPerThread = 8;
  static constexpr int kScalarPerThread = sizeof(T) == 4 ? 16 : 8;
};

template <typename V, bool STREAM>
__device__ __forceinline__ V load_v(const V* p) {
  if constexpr (STREAM) return __ldcs(p);
  else return *p;
}

template <typename V, bool STREAM>
__device__ __forceinline__ void store_v(V* p, const V& v) {
  if constexpr (STREAM) __stcs(p, v);
  else *p = v;
}

template <typename T, int VEC, int N, bool TO_CELL>
__device__ __forceinline__ void cell_copy(const T* __restrict__ src,
                                          T* __restrict__ dst, int64_t rows,
                                          int64_t nt, uint32_t units) {
  using V = typename Access<T, VEC>::type;
  constexpr uint32_t kChunk = 32 * VEC;
  constexpr uint32_t kPerRun = kCell / kChunk;
  constexpr bool kStream = VEC > 1;
  const uint32_t lane = threadIdx.x % 32;
  // chunks per cell (K5) or per SoA row (K6): the outer index of the order
  const uint32_t outer = static_cast<uint32_t>(TO_CELL ? rows : (nt + kCell - 1) / kCell);
  const uint32_t per_outer = outer * kPerRun;
  const uint32_t first = blockIdx.x * (kCopyWarps * N) + threadIdx.x / 32;
  V v[N];
  int64_t to[N];
  bool put[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t u = first + i * kCopyWarps;
    const uint32_t a = u / per_outer, rem = u - a * per_outer;
    const uint32_t b = rem / kPerRun, h = rem - b * kPerRun;
    const uint32_t c = TO_CELL ? a : b, r = TO_CELL ? b : a;
    const int64_t off = h * kChunk + lane * VEC;
    const int64_t col = static_cast<int64_t>(c) * kCell + off;
    const int64_t cell_i = (static_cast<int64_t>(c) * rows + r) * kCell + off;
    const int64_t soa_i = r * nt + col;
    const bool live = u < units && col < nt;
    v[i] = live ? load_v<V, kStream>(
                      reinterpret_cast<const V*>(src + (TO_CELL ? soa_i : cell_i)))
                : V{};
    to[i] = TO_CELL ? cell_i : soa_i;
    put[i] = TO_CELL ? u < units : live;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (put[i]) store_v<V, kStream>(reinterpret_cast<V*>(dst + to[i]), v[i]);
}

template <typename T, int VEC, int N>
__global__ void __launch_bounds__(kCopyThreads)
soa_to_cell_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t rows,
                   int64_t nt, uint32_t units) {
  cell_copy<T, VEC, N, true>(x, out, rows, nt, units);
}

template <typename T, int VEC, int N>
__global__ void __launch_bounds__(kCopyThreads)
cell_to_soa_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t rows,
                   int64_t nt, uint32_t units) {
  cell_copy<T, VEC, N, false>(x, out, rows, nt, units);
}

// ---------------------------------------------------------------------------
// K7: scalar tridiagonal (Thomas) solve per column, nl layers.
//
// Replaces the TPU kernel repro/kernels/tridiag.py::tridiag_cell
// (_tridiag_kernel).
// Bound on the H100: memory.  The compulsory bytes are dl, d, du and b read
// once and x written once, 5 nl C values (51,200,000 bytes in float32 at
// the step's 16 x 160,000); ~8 flops a layer and column, far below the
// ridge.
// Arithmetic: thomas_solve's (core/turbulence.py), op for op, each rounded
// on its own (no FMA contraction, no reciprocal):
//   denom = d - dl cp;  cp = du / denom;  dp = (b - dl dp) / denom;
//   x = dp - cp x, from x = 0 below the last layer,
// so the kernel equals the plain version bitwise.  dl[0] and du[nl-1] are
// read and multiply a zero carry, as there.
// Design, to move only the compulsory bytes and keep enough in flight:
//  - one thread a column, kTriThreads columns a block; a warp's lanes take
//    neighbouring columns of each (nl, C) operand, so every access is
//    coalesced, and the ragged last block is masked;
//  - the loads do not depend on the recurrence: the four operands of the
//    next kTriWindow layers wait in a ring of registers ahead of the layer
//    being eliminated, so a thread keeps 4 kTriWindow loads in flight, not
//    the 4 of one layer (streaming: each value is read once); they go in
//    layer order, from four pointers that step by C, which costs fewer
//    registers than 64-bit index arithmetic a load;
//  - ONCHIP: cp and dp of every layer stay in shared memory, [l][thread]
//    (conflict-free), and x is the only store to device memory, once a
//    value, in the backward sweep.  Shared memory, not registers, holds
//    them so that registers (45 in float32, 72 in float64) do not cap the
//    blocks a SM: cp and dp in registers, loops unrolled over the depth,
//    ran slower on an H100 at 16 layers (PERF.md, K7);
//  - deeper columns leave too few blocks a SM to keep the loads in flight
//    (or do not fit at all): the same kernel with ONCHIP = false keeps cp
//    in a global scratch (nl, C) that the wrapper allocates and dp in x,
//    both read back by the backward sweep (9 values a layer and column,
//    not 5), at the occupancy of its registers.
// The launch plan (variant, shared bytes, grid) is computed in Python
// (kernels/tridiag.py: launch_plan) and checked by the launcher.
// ---------------------------------------------------------------------------
constexpr int kTriThreads = 128;
constexpr int kTriWindow = 4;          // layers loaded ahead of the recurrence

__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
struct TriLayer { T a, d, u, b; };     // dl, d, du, b of one layer

// the four operands of this thread's column at the next layer to load
template <typename T>
struct TriStream {
  const T *a, *d, *u, *b;
  int64_t C;
  __device__ __forceinline__ TriLayer<T> next() {
    const TriLayer<T> q{__ldcs(a), __ldcs(d), __ldcs(u), __ldcs(b)};
    a += C;
    d += C;
    u += C;
    b += C;
    return q;
  }
};

template <typename T, bool ONCHIP>
__global__ void __launch_bounds__(kTriThreads)
tridiag_kernel(const T* __restrict__ dl, const T* __restrict__ d,
               const T* __restrict__ du, const T* __restrict__ b,
               T* __restrict__ x, T* __restrict__ cp_s, int nl, int64_t C) {
  constexpr int W = kTriWindow;
  extern __shared__ __align__(16) unsigned char tri_smem[];
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kTriThreads + threadIdx.x;
  if (t >= C) return;
  const int64_t stride = ONCHIP ? kTriThreads : C;
  T* const cps = ONCHIP ? reinterpret_cast<T*>(tri_smem) + threadIdx.x : cp_s + t;
  T* const dps = ONCHIP ? cps + static_cast<int64_t>(nl) * kTriThreads : x + t;
  TriStream<T> in{dl + t, d + t, du + t, b + t, C};
  TriLayer<T> ring[W];                 // layer l waits in slot l % W
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (j < nl) ring[j] = in.next();
  T cp = T(0), dp = T(0);
  for (int l0 = 0; l0 < nl; l0 += W) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int l = l0 + j;
      if (l < nl) {
        const TriLayer<T>& q = ring[j];
        const T denom = rn_sub(q.d, rn_mul(q.a, cp));
        cp = rn_div(q.u, denom);
        dp = rn_div(rn_sub(q.b, rn_mul(q.a, dp)), denom);
        cps[l * stride] = cp;
        dps[l * stride] = dp;
        if (l + W < nl) ring[j] = in.next();
      }
    }
  }
  // backward, W layers at a time: their cp and dp are read before the first
  // of them is needed (without ONCHIP, dp is overwritten by x)
  T xn = T(0);
  for (int l1 = nl - 1; l1 >= 0; l1 -= W) {
    T c[W], p[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (l1 - j >= 0) {
        c[j] = cps[(l1 - j) * stride];
        p[j] = dps[(l1 - j) * stride];
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (l1 - j >= 0) {
        xn = rn_sub(p[j], rn_mul(c[j], xn));
        x[(l1 - j) * C + t] = xn;
      }
    }
  }
}

template <typename T>
int launch_solve_r(const void* F, const void* area, const void* r_surf,
                   void* out, int64_t K, int64_t nl, int64_t nt, void* stream) {
  solve_r_kernel<T><<<grid_for(K * nt), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(area),
      static_cast<const T*>(r_surf), static_cast<T*>(out), K, nl, nt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve_w(const void* F, const void* area, const void* w_floor,
                   void* out, int64_t K, int64_t nl, int64_t nt, void* stream) {
  solve_w_kernel<T><<<grid_for(K * nt), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(area),
      static_cast<const T*>(w_floor), static_cast<T*>(out), K, nl, nt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
using ThomasKernel = void (*)(const T*, const T*, const T*, const T*, T*, T*,
                              int, int64_t);

// the widest tile built: launch_plan's PREFERRED_TC (kernels/column_solve.py)
template <typename T>
constexpr int kThomasWidest = sizeof(T) == 4 ? 32 : 16;

// ``kernel`` with its attributes set once per device (a bit of ``ready``
// per device): dynamic shared memory up to the card's opt-in limit and,
// where ``carveout``, the largest carveout, so that a launch does not call
// cudaFuncSetAttribute again
template <typename T>
cudaError_t smem_ready(ThomasKernel<T> kernel, bool carveout,
                       std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (err != cudaSuccess || (ready.load(std::memory_order_acquire) & bit))
    return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess && carveout)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

// a K3 instantiation, ready to launch; on chip with the largest carveout
template <typename T, int K, int TC, bool ONCHIP>
cudaError_t thomas_ready(ThomasKernel<T>* kernel) {
  static std::atomic<uint64_t> ready{0};
  *kernel = block_thomas_kernel<T, K, TC, ONCHIP>;
  return smem_ready<T>(*kernel, ONCHIP, ready);
}

// only the instantiations a launch plan can take: on chip every width up
// to the widest, the global variant at the widest
template <typename T, int K, int TC>
cudaError_t thomas_tile(bool onchip, ThomasKernel<T>* kernel) {
  if constexpr (TC > kThomasWidest<T>) {
    return cudaErrorInvalidValue;
  } else {
    if (onchip) return thomas_ready<T, K, TC, true>(kernel);
    if constexpr (TC == kThomasWidest<T>) return thomas_ready<T, K, TC, false>(kernel);
    return cudaErrorInvalidValue;
  }
}

// the instantiation of a launch plan, ready to launch, or
// cudaErrorInvalidValue where none was built
template <typename T>
cudaError_t thomas_kernel(int64_t k, int64_t tc, bool onchip, ThomasKernel<T>* kernel) {
  switch (k * 100 + tc) {  // the step solves k = 2 (u, v and T, S); k = 4 is tested
    case 232: return thomas_tile<T, 2, 32>(onchip, kernel);
    case 216: return thomas_tile<T, 2, 16>(onchip, kernel);
    case 208: return thomas_tile<T, 2, 8>(onchip, kernel);
    case 432: return thomas_tile<T, 4, 32>(onchip, kernel);
    case 416: return thomas_tile<T, 4, 16>(onchip, kernel);
    case 408: return thomas_tile<T, 4, 8>(onchip, kernel);
    default: return cudaErrorInvalidValue;
  }
}

// K3 with the launch plan computed in Python: the launcher refuses a plan
// it did not build (tile width, threads, shared bytes, grid, and a scratch
// exactly for the global variant)
template <typename T>
int launch_block_thomas(const void* lo, const void* dg, const void* up,
                        const void* rhs, void* x, void* scratch, int64_t k,
                        int64_t nl, int64_t nt, int64_t onchip, int64_t tc,
                        int64_t threads, int64_t smem, int64_t grid,
                        void* stream) {
  const int64_t rows = (onchip ? nl : 1) * 6 * (6 + k);
  if (nl < 1 || nl > (int64_t(1) << 24) || nt < 1 ||
      (onchip != 0 && onchip != 1) || threads != 6 * tc ||
      smem != rows * tc * static_cast<int64_t>(sizeof(T)) ||
      grid != (nt + tc - 1) / tc || grid >= (int64_t(1) << 31) ||
      (onchip == 1) != (scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ThomasKernel<T> kernel = nullptr;
  const cudaError_t err = thomas_kernel<T>(k, tc, onchip != 0, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), static_cast<unsigned>(threads),
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(lo), static_cast<const T*>(dg),
      static_cast<const T*>(up), static_cast<const T*>(rhs), static_cast<T*>(x),
      static_cast<T*>(scratch), static_cast<int>(nl), nt);
  return static_cast<int>(cudaGetLastError());
}

// tiles of a K3 launch plan that one SM holds at once
template <typename T>
int block_thomas_occupancy(int64_t k, int64_t onchip, int64_t tc, int64_t smem,
                           int64_t* tiles) {
  ThomasKernel<T> kernel = nullptr;
  cudaError_t err = thomas_kernel<T>(k, tc, onchip != 0, &kernel);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, static_cast<int>(6 * tc), static_cast<size_t>(smem));
  *tiles = n;
  return static_cast<int>(err);
}

template <typename T>
int launch_lateral_flux(const void* f, const void* fext, const void* speed,
                        const void* edge_len, void* out, const double* consts,
                        const int64_t* edges, int64_t k, int64_t nl,
                        int64_t nt, void* stream) {
  LatConsts<T> c;
  for (int z = 0; z < 2; ++z)
    for (int v = 0; v < 2; ++v) c.pz[z][v] = static_cast<T>(consts[z * 2 + v]);
  for (int q = 0; q < 2; ++q) {
    c.pa[q] = static_cast<T>(consts[4 + q]);
    c.pb[q] = static_cast<T>(consts[6 + q]);
    c.w[q] = static_cast<T>(consts[8 + q]);
  }
  for (int e = 0; e < 3; ++e) {
    c.ea[e] = static_cast<int>(edges[e]);
    c.eb[e] = static_cast<int>(edges[3 + e]);
  }
  lateral_flux_kernel<T><<<grid_for(k * nl * nt), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f), static_cast<const T*>(fext),
      static_cast<const T*>(speed), static_cast<const T*>(edge_len),
      static_cast<T*>(out), c, k, nl, nt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int N>
void launch_copy(bool to_cell, const void* x, void* out, int64_t rows, int64_t nt,
                 uint32_t units, int64_t grid, cudaStream_t stream) {
  if (to_cell)
    soa_to_cell_kernel<T, VEC, N><<<static_cast<unsigned>(grid), kCopyThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), rows, nt, units);
  else
    cell_to_soa_kernel<T, VEC, N><<<static_cast<unsigned>(grid), kCopyThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), rows, nt, units);
}

// K5 / K6 with the launch plan computed in Python: the launcher refuses a
// plan that is not the one it builds for these rows, nt and pointers
template <typename T>
int launch_cell_transpose(bool to_cell, const void* x, void* out, int64_t rows,
                          int64_t nt, int64_t vec, int64_t per_thread,
                          int64_t threads, int64_t grid, void* stream) {
  using P = CopyPlan<T>;
  if (rows < 1 || nt < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vector = nt % P::kVec == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t v = vector ? P::kVec : 1;
  const int64_t n = vector ? P::kVecPerThread : P::kScalarPerThread;
  const int64_t units = (nt + kCell - 1) / kCell * rows * (kCell / (32 * v));
  const int64_t per_block = kCopyWarps * n;
  const int64_t blocks = (units + per_block - 1) / per_block;
  if (vec != v || per_thread != n || threads != kCopyThreads || grid != blocks ||
      blocks * per_block >= (int64_t(1) << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t u = static_cast<uint32_t>(units);
  if (vector)
    launch_copy<T, P::kVec, P::kVecPerThread>(to_cell, x, out, rows, nt, u, grid, s);
  else
    launch_copy<T, 1, P::kScalarPerThread>(to_cell, x, out, rows, nt, u, grid, s);
  return static_cast<int>(cudaGetLastError());
}

// K7 with the launch plan computed in Python: the launcher refuses a plan
// it did not build (shared bytes exactly for ONCHIP's cp and dp, a scratch
// exactly for the global variant, the block and the grid)
template <typename T>
int launch_tridiag(const void* dl, const void* d, const void* du, const void* b,
                   void* x, void* cp, int64_t nl, int64_t C, int64_t onchip,
                   int64_t threads, int64_t smem, int64_t grid, void* stream) {
  if (nl < 1 || nl > (int64_t(1) << 24) || C < 1 || (onchip != 0 && onchip != 1) ||
      threads != kTriThreads || grid != (C + kTriThreads - 1) / kTriThreads ||
      grid >= (int64_t(1) << 31) ||
      smem != (onchip ? 2 * nl * kTriThreads * static_cast<int64_t>(sizeof(T)) : 0) ||
      (onchip == 1) != (cp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<uint64_t> ready{0};
  ThomasKernel<T> kernel = tridiag_kernel<T, false>;
  if (onchip) {
    kernel = tridiag_kernel<T, true>;
    const cudaError_t err = smem_ready<T>(kernel, true, ready);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(grid), kTriThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dl), static_cast<const T*>(d),
      static_cast<const T*>(du), static_cast<const T*>(b), static_cast<T*>(x),
      static_cast<T*>(cp), static_cast<int>(nl), C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ocean_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define OCEAN_LAUNCHERS(T, SUFFIX)                                              \
  int solve_r_##SUFFIX(const void* F, const void* area, const void* r_surf,     \
                       void* out, int64_t K, int64_t nl, int64_t nt,            \
                       void* stream) {                                          \
    return launch_solve_r<T>(F, area, r_surf, out, K, nl, nt, stream);          \
  }                                                                             \
  int solve_w_##SUFFIX(const void* F, const void* area, const void* w_floor,    \
                       void* out, int64_t K, int64_t nl, int64_t nt,            \
                       void* stream) {                                          \
    return launch_solve_w<T>(F, area, w_floor, out, K, nl, nt, stream);         \
  }                                                                             \
  int block_thomas_##SUFFIX(const void* lo, const void* dg, const void* up,     \
                            const void* rhs, void* x, void* scratch, int64_t k, \
                            int64_t nl, int64_t nt, int64_t onchip, int64_t tc, \
                            int64_t threads, int64_t smem, int64_t grid,        \
                            void* stream) {                                     \
    return launch_block_thomas<T>(lo, dg, up, rhs, x, scratch, k, nl, nt,       \
                                  onchip, tc, threads, smem, grid, stream);     \
  }                                                                             \
  int block_thomas_occupancy_##SUFFIX(int64_t k, int64_t onchip, int64_t tc,    \
                                      int64_t smem, int64_t* tiles) {           \
    return block_thomas_occupancy<T>(k, onchip, tc, smem, tiles);               \
  }                                                                             \
  int lateral_flux_##SUFFIX(const void* f, const void* fext, const void* speed, \
                            const void* edge_len, void* out,                    \
                            const double* consts, const int64_t* edges,         \
                            int64_t k, int64_t nl, int64_t nt, void* stream) {  \
    return launch_lateral_flux<T>(f, fext, speed, edge_len, out, consts,        \
                                  edges, k, nl, nt, stream);                    \
  }                                                                             \
  int soa_to_cell_##SUFFIX(const void* x, void* out, int64_t rows, int64_t nt,  \
                           int64_t vec, int64_t per_thread, int64_t threads,    \
                           int64_t grid, void* stream) {                        \
    return launch_cell_transpose<T>(true, x, out, rows, nt, vec, per_thread,    \
                                    threads, grid, stream);                     \
  }                                                                             \
  int cell_to_soa_##SUFFIX(const void* x, void* out, int64_t rows, int64_t nt,  \
                           int64_t vec, int64_t per_thread, int64_t threads,    \
                           int64_t grid, void* stream) {                        \
    return launch_cell_transpose<T>(false, x, out, rows, nt, vec, per_thread,   \
                                    threads, grid, stream);                     \
  }                                                                             \
  int tridiag_##SUFFIX(const void* dl, const void* d, const void* du,           \
                       const void* b, void* x, void* cp, int64_t nl, int64_t C, \
                       int64_t onchip, int64_t threads, int64_t smem,           \
                       int64_t grid, void* stream) {                            \
    return launch_tridiag<T>(dl, d, du, b, x, cp, nl, C, onchip, threads,       \
                             smem, grid, stream);                               \
  }

OCEAN_LAUNCHERS(float, f32)
OCEAN_LAUNCHERS(double, f64)

#undef OCEAN_LAUNCHERS

}  // extern "C"
