// Hopper (sm_90a) tall-skinny Gram of CholeskyQR: G[b] = V_b^T V_b.
//
// Replaces: repro/kernels/gram_qr.py  gram_qr_pallas  (G = V^T V, the
// CholeskyQR matmul). One launch serves a batch of B matrices (d, r),
// row-major, f32 or bf16; G is (B, r, r) f32. B = 1 is the reference's
// kernel; the port's CholeskyQR2 sends every node's (or slab's) Gram of one
// pass through one launch.
//
// What bounds it on the H100, by shape:
//  * The main path's r = 7 (S-DOT (20, 1024, 7), F-DOT (20, 55, 7), B-DOT
//    (4, 256, 7)): d * r values read for d r (r + 1) flops, 8 flops a 4-byte
//    value, and at most 573 KB a launch, which the card's 3.35 TB/s moves in
//    0.2 us. What is left is latency: the launch (the card's floor for an
//    empty kernel is 2 us), the round trip to device memory, the sums and
//    the write of G.
//  * (16384, 128) f32: 129 flops a value, 32 a byte: the 67 TFLOP/s of f32
//    FMA on the CUDA cores. TF32 stays off: it would move the Gram of f32
//    inputs.
//  * (16384, 128) bf16: the products of two bf16 values are exact in f32,
//    so bf16 inputs go through the tensor cores (mma.sync m16n8k16, f32
//    accumulation) and only the order of the sums changes; what bounds it
//    is the 4 MB of V, the partial sums and the latency of the fold.
//
// Design (one launch at every shape):
//  * G is symmetric: only tile pairs (ti, tj), ti <= tj, of the T x T output
//    tiles are computed, and each sum G[i][j], i <= j, is written to both
//    G[i][j] and G[j][i]: G is exactly symmetric.
//  * A block owns one tile pair of one matrix and one fixed range of rows;
//    the wrapper's plan (gram_qr.py, a pure function of the shapes and the
//    card's SM count) cuts each matrix into as many ranges as fill one wave.
//  * r <= 8 (the PSA families' r = 7 and 5): no staging, and one block a
//    matrix up to 4096 rows; each thread reads whole rows straight into
//    registers (four rows' loads before their FMAs) and sums all their
//    products, and a warp reduce-scatter and the warps' sums in order give
//    the tile. At S-DOT's shape the one pass beats a split into row ranges
//    staged in shared memory and folded (PERF.md).
//  * Above r = 8, staging: a block copies its rows (all r columns; the rows
//    of a matrix are contiguous) into shared memory with 16-byte cp.async
//    copies, every copy of a chunk issued before one wait. Each value is
//    loaded once.
//    Where r is a multiple of a 16-byte unit each row is placed at a padded
//    stride (aligned rows, no bank conflicts); else the range is copied flat
//    from the 16-byte unit that holds its first value. A range larger than
//    a chunk streams through two buffers: chunk c + 1 is in flight while
//    chunk c is summed.
//  * CUDA cores (f32 above r = 8, and bf16 up to r = 16 or not a multiple
//    of 8): a thread keeps an M x M micro-tile of sums (M = T / 8: up to
//    8 x 8, read with 16-byte loads where rows are aligned) over every 4th
//    row; the 4 row phases are added in order.
//  * Tensor cores (bf16, r a multiple of 8 and above 16): 64 x 64 tiles,
//    warp w owns a 16 x 32 piece; V^T (the A operand) and V (the B operand)
//    both come from the same row-major staged rows through ldmatrix.trans.
//    The running sums stay on the CUDA cores (see mma_bf16).
//  * The ranges of a tile pair are folded in the same launch: each block
//    writes its range's sum, fences and takes a ticket (an atomic counter,
//    never an atomic sum); the last sums the ranges' partials in range
//    order (hopper::fold_partials, in two levels past 16 ranges) and writes
//    both triangles, then resets the ticket. No second launch, no atomics
//    on the sums: every launch gives the same bits, which the bitwise
//    resume of a checkpointed run relies on.
//  * Ragged edges: rows past a range or d, and columns past r, are masked;
//    any d >= 1 and r >= 1 are taken (no padding of d, unlike ops.py's TPU
//    path).
//
// The cluster route (few matrices above r = 8 on the CUDA cores, the PSA
// trainer's refresh Grams: one or two matrices of d = 3584-18944 by r = 64):
// there the staged route's time was its fold's, two serial levels of
// tickets and ordered sums on one SM each (PERF.md, row 4). Here a tile
// pair is taken by thread block clusters of C = 16 blocks
// (cudaLaunchKernelEx with a cluster dimension, past the portable 8):
//  * the pair's micro-tiles on or above the diagonal (36 of a diagonal
//    pair's 8 x 8) are cut into P parts; each part is summed over all rows
//    by its own K clusters, block k of row cluster kk taking range kk C + k
//    of the rows (K = 1, no fold, unless a block would take more than 512
//    rows). An H100 holds 7 clusters of 16 at once: a matrix alone gets P
//    = 7 parts of 5-6 micro-tiles;
//  * a block stages its range as above; thread t keeps one micro-tile's
//    sums over every phases-th row (``Tri``: 256 / per phases of per
//    threads, so every warp but the last is busy) and the phases are added
//    in order through shared memory, padded so that no load conflicts;
//  * each block pushes slice k of its part's sums into the shared memory
//    of block k (distributed shared memory), then one cluster barrier, and
//    block k adds the C copies of slice k in rank order: no global
//    partials, tickets or fences inside a cluster. The barrier that makes
//    the pushes safe (every block started) is arrived at on entry and
//    waited on after the sums, so its latency hides behind them;
//  * K = 1: block k writes its slice of G. K > 1: it writes its slice as
//    the row cluster's partial, takes the slice's ticket, and the last of
//    the K sums the partials in cluster order and writes that slice of G:
//    one level, spread over C SMs.
// Every launch gives the same bits; G is written from the upper triangle's
// sums to both triangles, as above.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct QrArgs {
  const void* v;                 // (batch, d, r), f32 or bf16
  float* g;                      // (batch, r, r)
  float* partial;                // (slots, T, T) scratch
  int* tickets;                  // (groups + units,) zero before and after
  const int* items;              // (blocks, 6): unit, range of the unit,
                                 // + 1, 1, partial slot, group
  const int* groups;             // (groups, 3), see hopper::fold_partials
  const int* unit_groups;        // (units + 1,)
  int n_groups;
  int d, r;
  int pairs;                     // tile pairs a matrix
  int ranges;                    // ranges a tile pair (one: no fold)
  int rows_per_range;
  int chunk_rows;                // rows staged at once, a multiple of 16
  int stride;                    // elements between staged rows
  int buf_elems;                 // elements of one staging buffer
  size_t total;                  // batch * d * r
  int cluster;                   // blocks a cluster (cluster route), else 1
  int clusters;                  // row clusters a part (cluster route)
  int parts;                     // parts of a tile pair (cluster route)
  int recv_offset;               // bytes: the slices' copies (cluster route)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (ti, tj), ti <= tj: the p-th tile pair of the upper triangle, row by row.
__device__ __forceinline__ void tile_pair(int p, int nt, int& ti, int& tj) {
  ti = 0;
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  tj = ti + p;
}

// Issue the copies of rows [k0, k1) of matrix b into ``buf``; returns the
// element of ``buf`` that holds (k0, 0). Padded (stride != r): one unit a
// copy, row k at k * stride, rows up to the next multiple of 16 zero-filled.
// Flat: the units from the one holding (k0, 0) on, the last clipped at the
// end of the tensor.
template <typename In>
__device__ __forceinline__ int stage_rows(const QrArgs& a, int b, int k0,
                                          int k1, In* buf) {
  constexpr int U = 16 / sizeof(In);
  const In* v = static_cast<const In*>(a.v);
  const size_t first = ((size_t)b * a.d + k0) * a.r;
  if (a.stride != a.r) {
    const int upr = a.r / U;
    const int n = ((k1 - k0 + 15) & ~15) * upr;
    for (int u = threadIdx.x; u < n; u += kThreads) {
      const int k = u / upr, c = (u - k * upr) * U;
      const bool ok = k0 + k < k1;
      hopper::cp_async_16(hopper::smem_u32(buf + k * a.stride + c),
                          v + first + (ok ? (size_t)k * a.r + c : 0),
                          ok ? 16 : 0);
    }
    return 0;
  }
  const size_t s0 = first & ~(size_t)(U - 1);
  const size_t end = ((size_t)b * a.d + k1) * a.r;
  const int n = (int)((end - s0 + U - 1) / U);
  for (int u = threadIdx.x; u < n; u += kThreads) {
    const size_t at = s0 + (size_t)u * U;
    const size_t left = a.total - at;
    hopper::cp_async_16(hopper::smem_u32(buf + u * U), v + at,
                        left >= (size_t)U ? 16 : (int)(left * sizeof(In)));
  }
  return (int)(first - s0);
}

// -- CUDA cores --------------------------------------------------------------
template <typename In, int M, bool VEC>
__device__ __forceinline__ void load_micro(const In* p, float (&x)[M]) {
  if constexpr (VEC) {
#pragma unroll
    for (int m = 0; m < M; m += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + m);
      x[m] = q.x; x[m + 1] = q.y; x[m + 2] = q.z; x[m + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) x[m] = to_f32(p[m]);
  }
}

// r <= 8: thread t takes rows t, t + 256, ... of the range straight from
// device memory into registers (four rows' loads before their FMAs) and
// keeps all 8 x 8 products of a row, the upper triangle's summed; a warp
// reduce-scatters the 64 sums (lane l: 2 l and 2 l + 1) and the 8 warps'
// sums are added in warp order. Each value is loaded once, no shared-memory
// staging, and every thread does the FMAs of whole rows.
template <typename In>
struct Rows {
  static constexpr bool kDirect = true;
  float p[64];

  __device__ void init(int, int, int) {
#pragma unroll
    for (int i = 0; i < 64; ++i) p[i] = 0.f;
  }

  template <int U>
  __device__ __forceinline__ void take(const In* v, int r, int k) {
    float x[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        x[u][c] = c < r ? to_f32(v[(size_t)(k + u * kThreads) * r + c]) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = i; j < 8; ++j)
          p[i * 8 + j] = fmaf(x[u][i], x[u][j], p[i * 8 + j]);
  }

  __device__ void direct(const QrArgs& a, int b, int k0, int k1) {
    const In* v = static_cast<const In*>(a.v) + (size_t)b * a.d * a.r;
    int k = k0 + threadIdx.x;
    for (; k + 3 * kThreads < k1; k += 4 * kThreads) take<4>(v, a.r, k);
    for (; k < k1; k += kThreads) take<1>(v, a.r, k);
  }

  __device__ void finish(float* tile, int, int) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    hopper::halve<32>(p, lane, 16);
    hopper::halve<16>(p, lane, 8);
    hopper::halve<8>(p, lane, 4);
    hopper::halve<4>(p, lane, 2);
    hopper::halve<2>(p, lane, 1);
    float* red = tile + 64;
    red[warp * 64 + 2 * lane] = p[0];
    red[warp * 64 + 2 * lane + 1] = p[1];
    __syncthreads();
    if (threadIdx.x < 64) {
      float s = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) s += red[w * 64 + threadIdx.x];
      tile[threadIdx.x] = s;
    }
    __syncthreads();
  }
};

// Thread e of a phase owns micro-tile (e / 8, e % 8) of the 8 x 8 micro-
// tiles of a T x T tile; 4 phases of 64 threads take every 4th row. Below a
// diagonal pair's diagonal the micro-tiles idle.
template <typename In, int T, bool VEC>
struct Simt {
  static constexpr bool kDirect = false;
  static constexpr int M = T / 8;
  static constexpr int kPer = 64;                 // threads a phase
  static constexpr int kPhases = kThreads / kPer;
  float acc[M][M];
  int i0, j0;
  bool active;

  __device__ void init(int r, int ti, int tj) {
    const int e = threadIdx.x % kPer;
    const int ta = e / 8, tb = e % 8;
    i0 = ti * T + ta * M;
    j0 = tj * T + tb * M;
    active = i0 < r && j0 < r && (ti != tj || ta <= tb);
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < M; ++n) acc[m][n] = 0.f;
  }

  // every kPhases-th row from the thread's phase; four rows' values are
  // loaded before their FMAs
  __device__ void rows(const In* buf, int stride, int rows) {
    if (!active) return;
    int k = threadIdx.x / kPer;
    for (; k + 3 * kPhases < rows; k += 4 * kPhases) {
      float x[4][M], y[4][M];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        load_micro<In, M, VEC>(buf + (k + u * kPhases) * stride + i0, x[u]);
        load_micro<In, M, VEC>(buf + (k + u * kPhases) * stride + j0, y[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int n = 0; n < M; ++n)
            acc[m][n] = fmaf(x[u][m], y[u][n], acc[m][n]);
    }
    for (; k < rows; k += kPhases) {
      float x[M], y[M];
      load_micro<In, M, VEC>(buf + k * stride + i0, x);
      load_micro<In, M, VEC>(buf + k * stride + j0, y);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < M; ++n) acc[m][n] = fmaf(x[m], y[n], acc[m][n]);
    }
  }

  // the tile's sums into tile[T][T] (shared), the phases added in order;
  // the phases' sums go after the tile, a micro-tile a thread
  __device__ void finish(float* tile, int, int) {
    float* red = tile + T * T;
    float* mine = red + threadIdx.x * M * M;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < M; ++n) mine[m * M + n] = active ? acc[m][n] : 0.f;
    __syncthreads();
    for (int x = threadIdx.x; x < T * T; x += kThreads) {
      const int ii = x / T, jj = x % T;
      const float* at = red + ((ii / M) * 8 + jj / M) * M * M +
                        (ii % M) * M + jj % M;
      float s = at[0];
#pragma unroll
      for (int ph = 1; ph < kPhases; ++ph) s += at[ph * kPer * M * M];
      tile[x] = s;
    }
    __syncthreads();
  }
};

// Cluster route: the micro-tiles on or above the diagonal only, and of
// those one part, micro-tiles [e0, e1) (row by row along the upper
// triangle of the 8 x 8 micro-tiles: a diagonal tile pair has 36, an
// off-diagonal pair 64). Thread t owns micro-tile e0 + t % per (per = e1 -
// e0) over every phases-th row from phase t / per (phases = 256 / per: 7
// of 36 threads for a whole diagonal pair, 42 of 6 for a sixth of one), so
// every warp but the last is busy. The sums stay in micro-tile order: sum w
// = (m M + n) per + e - e0 is (m, n) of micro-tile e (``element``), count()
// = per M M of them.
template <typename In, int T, bool VEC>
struct Tri {
  static constexpr bool kDirect = false;
  static constexpr int M = T / 8;
  float acc[M][M];
  int i0, j0, phase, phases, per, e0;
  bool active, diag;

  // micro-tile e of the upper triangle (diagonal pair) or of all 64
  __device__ __forceinline__ void micro(int e, int& ta, int& tb) const {
    ta = 0;
    if (diag) {
      while (e >= 8 - ta) {
        e -= 8 - ta;
        ++ta;
      }
      tb = ta + e;
    } else {
      ta = e / 8;
      tb = e % 8;
    }
  }

  __device__ __forceinline__ int count() const { return per * M * M; }

  // (ii, jj) in the T x T tile of sum w
  __device__ __forceinline__ void element(int w, int& ii, int& jj) const {
    const int q = w / per;
    int ta, tb;
    micro(e0 + w - q * per, ta, tb);
    ii = ta * M + q / M;
    jj = tb * M + q % M;
  }

  __device__ void init(int r, int ti, int tj, int first, int end) {
    diag = ti == tj;
    e0 = first;
    per = end - first;
    phases = kThreads / per;
    phase = threadIdx.x / per;
    int ta, tb;
    micro(e0 + threadIdx.x - phase * per, ta, tb);
    i0 = ti * T + ta * M;
    j0 = tj * T + tb * M;
    active = phase < phases && i0 < r && j0 < r;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < M; ++n) acc[m][n] = 0.f;
  }

  // every phases-th row from the thread's phase; four rows' values are
  // loaded before their FMAs
  __device__ void rows(const In* buf, int stride, int rows) {
    if (!active) return;
    int k = phase;
    for (; k + 3 * phases < rows; k += 4 * phases) {
      float x[4][M], y[4][M];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        load_micro<In, M, VEC>(buf + (k + u * phases) * stride + i0, x[u]);
        load_micro<In, M, VEC>(buf + (k + u * phases) * stride + j0, y[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int n = 0; n < M; ++n)
            acc[m][n] = fmaf(x[u][m], y[u][n], acc[m][n]);
    }
    for (; k < rows; k += phases) {
      float x[M], y[M];
      load_micro<In, M, VEC>(buf + k * stride + i0, x);
      load_micro<In, M, VEC>(buf + k * stride + j0, y);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < M; ++n) acc[m][n] = fmaf(x[m], y[n], acc[m][n]);
    }
  }

  // the threads' sums into shared memory, (m, n) of thread t at (m M + n)
  // (kThreads + per) + t: a warp's stores run along consecutive words, and
  // so do ``phase_sum``'s loads, (m M + n) (kThreads + per) + e - e0 +
  // phase per = (m M + n) kThreads + w + phase per (no bank conflicts)
  __device__ void store(float* red) const {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < M; ++n)
        red[(m * M + n) * (kThreads + per) + threadIdx.x] =
            active ? acc[m][n] : 0.f;
  }

  // sum w over the phases, added in phase order; eight phases' loads are
  // in flight before their adds
  __device__ __forceinline__ float phase_sum(const float* red, int w) const {
    const float* at = red + (w / per) * kThreads + w;
    float s = at[0];
    for (int ph = 1; ph < phases; ph += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = ph + u < phases ? at[(ph + u) * per] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (ph + u < phases) s += v[u];
    }
    return s;
  }
};

// -- tensor cores (bf16) -----------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

// acc += a (16 x 16, row-major) b (16 x 8, column-major), bf16 in. The
// tensor cores sum each element's 16 products from zero, and the CUDA cores
// add that to acc: summed inside the mma, acc is cut to the tensor cores'
// width at every step, a bias that grows with the rows of a range (5.4e-6
// of max |G| at (3, 16384, 128), tools/gram_qr_accuracy.py).
__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] += d[c];
}

// T = 64: warp w owns rows 16 (w % 4) .. + 16 and columns 32 (w / 4) .. + 32
// of the tile, four m16n8 pieces. Rows of the staged chunk are k, columns
// of V are both the tile's i (A = V^T, m) and j (B = V, n).
struct Tc {
  static constexpr bool kDirect = false;
  static constexpr int T = 64;
  float acc[4][4];
  int mw, nw, ia, jb;
  bool active;

  __device__ void init(int, int ti, int tj) {
    const int warp = threadIdx.x / 32;
    mw = warp % 4;
    nw = warp / 4;
    ia = ti * T + 16 * mw;
    jb = tj * T + 32 * nw;
    active = !(ti == tj && mw >= 2 * nw + 2);   // wholly below the diagonal
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;
  }

  // rows: the chunk's rows; the staging zero-filled them up to a multiple
  // of 16.
  __device__ void rows(const __nv_bfloat16* buf, int stride, int rows) {
    if (!active) return;
    const int lane = threadIdx.x % 32, q8 = lane / 8, r8 = lane % 8;
    // A: matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15,
    // m 8-15); B: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), ...
    const __nv_bfloat16* pa = buf + (r8 + 8 * (q8 / 2)) * stride + ia +
                              8 * (q8 % 2);
    const __nv_bfloat16* pb = buf + (r8 + 8 * (q8 % 2)) * stride + jb +
                              8 * (q8 / 2);
    for (int k = 0; k < rows; k += 16) {
      uint32_t a[4], b0[4], b1[4];
      ldmatrix_x4_trans(a, pa + k * stride);
      ldmatrix_x4_trans(b0, pb + k * stride);
      ldmatrix_x4_trans(b1, pb + k * stride + 16);
      mma_bf16(acc[0], a, b0[0], b0[1]);
      mma_bf16(acc[1], a, b0[2], b0[3]);
      mma_bf16(acc[2], a, b1[0], b1[1]);
      mma_bf16(acc[3], a, b1[2], b1[3]);
    }
  }

  __device__ void finish(float* tile, int, int) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ii = 16 * mw + g, jj = 32 * nw + 8 * q + 2 * t;
      tile[ii * T + jj] = active ? acc[q][0] : 0.f;
      tile[ii * T + jj + 1] = active ? acc[q][1] : 0.f;
      tile[(ii + 8) * T + jj] = active ? acc[q][2] : 0.f;
      tile[(ii + 8) * T + jj + 1] = active ? acc[q][3] : 0.f;
    }
    __syncthreads();
  }
};

// tile (T x T, shared) -> G[b], upper-triangle sums to both triangles:
// the rows of the tile, then its columns as rows of the mirror, so both
// passes write whole rows of G
template <int T>
__device__ __forceinline__ void write_gram(const float* tile, float* gb,
                                           int r, int ti, int tj) {
  for (int x = threadIdx.x; x < T * T; x += kThreads) {
    const int ii = x / T, jj = x - ii * T;
    const int i = ti * T + ii, j = tj * T + jj;
    if (i < r && j < r && (ti < tj || ii <= jj))
      gb[(size_t)i * r + j] = tile[x];
  }
  for (int x = threadIdx.x; x < T * T; x += kThreads) {
    const int jj = x / T, ii = x - jj * T;
    const int i = ti * T + ii, j = tj * T + jj;
    if (i < r && j < r && (ti < tj || ii < jj))
      gb[(size_t)j * r + i] = tile[ii * T + jj];
  }
}

// Rows [k_begin, k_end) of matrix b into ``route``'s sums (initialised),
// staged at the start of shared memory (``smem``), by all threads.
template <typename In, class Route>
__device__ __forceinline__ void range_rows(const QrArgs& a, int b,
                                           int k_begin, int k_end,
                                           Route& route, unsigned char* smem) {
  if constexpr (Route::kDirect) {
    route.direct(a, b, k_begin, k_end);
  } else {
    In* const buf0 = reinterpret_cast<In*>(smem);   // two buffers in turn
    const int chunks = k_end > k_begin
        ? (k_end - k_begin + a.chunk_rows - 1) / a.chunk_rows : 0;
    int off = chunks ? stage_rows(a, b, k_begin,
                                  min(k_end, k_begin + a.chunk_rows), buf0)
                     : 0;
    hopper::cp_async_commit();
    for (int c = 0; c < chunks; ++c) {
      const int k0 = k_begin + c * a.chunk_rows;
      const int k1 = min(k_end, k0 + a.chunk_rows);
      int next_off = 0;
      if (c + 1 < chunks) {
        next_off = stage_rows(a, b, k1, min(k_end, k1 + a.chunk_rows),
                              buf0 + ((c + 1) & 1) * a.buf_elems);
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      __syncthreads();
      route.rows(buf0 + (c & 1) * a.buf_elems + off, a.stride, k1 - k0);
      __syncthreads();               // the buffer is free for chunk c + 2
      off = next_off;
    }
  }
}

template <typename In, int T, class Route>
__global__ void __launch_bounds__(kThreads) gram_qr_kernel(QrArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flag;
  const int it = blockIdx.x;                      // = items[it]: (unit,
  const int unit = it / a.ranges;                 // range of the unit)
  const int range = it - unit * a.ranges;
  const int b = unit / a.pairs;
  int ti, tj;
  tile_pair(unit - b * a.pairs, (a.r + T - 1) / T, ti, tj);
  const int k_begin = range * a.rows_per_range;
  const int k_end = min(a.d, k_begin + a.rows_per_range);
  Route route;
  route.init(a.r, ti, tj);
  range_rows<In>(a, b, k_begin, k_end, route, smem);

  float* tile = reinterpret_cast<float*>(smem);
  route.finish(tile, ti, tj);
  float* gb = a.g + (size_t)b * a.r * a.r;
  if (a.ranges == 1) {               // the tile pair's only range
    write_gram<T>(tile, gb, a.r, ti, tj);
    return;
  }
  const int slot = a.items[6 * it + 4];
  float4* part = reinterpret_cast<float4*>(a.partial + (size_t)slot * T * T);
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  for (int x = threadIdx.x; x < T * T / 4; x += kThreads) part[x] = t4[x];
  hopper::fold_partials(a.items, a.groups, a.unit_groups, a.tickets,
                        a.n_groups, a.partial, (size_t)T * T, T * T, tile,
                        1.f, it, &flag);
  if (!flag) return;                 // not the unit's last range
  __syncthreads();
  write_gram<T>(tile, gb, a.r, ti, tj);
}

// -- cluster route -------------------------------------------------------------
constexpr int kMaxCluster = 16;

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Sum w of ``route``'s part (value s) -> G[b], to both triangles (a sum
// below a diagonal pair's diagonal to neither: its mirror is written from
// above).
template <int T, class Route>
__device__ __forceinline__ void write_sum(const Route& route, float s,
                                          float* gb, int r, int ti, int tj,
                                          int w) {
  int ii, jj;
  route.element(w, ii, jj);
  const int i = ti * T + ii, j = tj * T + jj;
  if (i >= r || j >= r || (ti == tj && ii > jj)) return;
  gb[(size_t)i * r + j] = s;
  if (ti < tj || ii < jj) gb[(size_t)j * r + i] = s;
}

// Block (unit, part p, row cluster kk, rank k) of a cluster route launch,
// blocks of a cluster consecutive: a tile pair's micro-tiles are cut into
// ``parts`` parts, each taken by ``clusters`` clusters of C blocks, block k
// of row cluster kk summing range kk C + k of the matrix's rows for its
// part. The part's sums go, slice by slice, to the shared memory of the
// block that owns the slice (distributed shared memory); after one cluster
// barrier block k adds the C blocks' copies of slice k in rank order. See
// the file's note.
template <typename In, int T, class Route>
__global__ void __launch_bounds__(kThreads)
    gram_qr_cluster_kernel(QrArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flag;
  cluster_arrive_relaxed();          // this block has started (see below)
  const int C = a.cluster, per_unit = a.parts * a.ranges;
  const int unit = blockIdx.x / per_unit;
  int at = blockIdx.x - unit * per_unit;
  const int part = at / a.ranges;
  const int range = at - part * a.ranges;      // kk C + rank
  const int rank = range % C, kk = range / C;
  const int b = unit / a.pairs;
  int ti, tj;
  tile_pair(unit - b * a.pairs, (a.r + T - 1) / T, ti, tj);
  const int micro = ti == tj ? 36 : 64;
  Route route;
  route.init(a.r, ti, tj, part * micro / a.parts,
             (part + 1) * micro / a.parts);
  // the matrix's groups of 8 rows cut as evenly as whole groups allow
  // (gram_qr.py ``cluster_range``); rows_per_range is the most a range
  // takes
  const long long groups = (a.d + 7) / 8;
  const int k_begin = min(a.d, (int)(8 * (range * groups / a.ranges)));
  const int k_end = min(a.d, (int)(8 * ((range + 1) * groups / a.ranges)));
  range_rows<In>(a, b, k_begin, k_end, route, smem);

  float* red = reinterpret_cast<float*>(smem);
  float* recv = reinterpret_cast<float*>(smem + a.recv_offset);
  route.store(red);
  __syncthreads();
  // slice k: sums [k n, k n + n) of the part's count (the last may be
  // short, or empty)
  const int count = route.count(), n = (count + C - 1) / C;
  const int mine = max(0, min(n, count - rank * n));
  // every block of the cluster has started, so its shared memory may be
  // written (the arrival at the top; its wait is hidden behind the sums)
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();
  for (int w = threadIdx.x; w < count; w += kThreads) {
    const int owner = w / n;
    cluster.map_shared_rank(recv, owner)[rank * n + w - owner * n] =
        route.phase_sum(red, w);
  }
  cluster_arrive();                  // this block's copies are out
  cluster_wait();                    // and every block's are in
  // slice ``rank`` of the cluster's sum: the blocks' copies in rank order
  float* gb = a.g + (size_t)b * a.r * a.r;
  float* part_sums = a.partial +
                     (size_t)(unit * a.parts + part) * a.clusters * T * T;
  for (int x = threadIdx.x; x < mine; x += kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      v[q] = q < C ? recv[q * n + x] : 0.f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < C) s += v[q];
    if (a.clusters == 1)
      write_sum<T>(route, s, gb, a.r, ti, tj, rank * n + x);
    else
      part_sums[(size_t)kk * T * T + rank * n + x] = s;
  }
  if (a.clusters == 1) return;
  // the row clusters' partials of this slice, then the slice's ticket: the
  // last of the part's clusters sums the partials in cluster order
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (unit * a.parts + part) * C + rank;
  if (threadIdx.x == 0) flag = atomicAdd(ticket, 1) == a.clusters - 1;
  __syncthreads();
  if (!flag) return;
  __threadfence();
  hopper::ordered_sum<2>(part_sums + rank * n, (size_t)T * T, a.clusters,
                         mine, recv, 1.f);
  if (threadIdx.x == 0) *ticket = 0;
  __syncthreads();
  for (int x = threadIdx.x; x < mine; x += kThreads)
    write_sum<T>(route, recv[x], gb, a.r, ti, tj, rank * n + x);
}

// Launch (occupancy == nullptr) or ask how many clusters of the launch's
// size fit the card at once (into *occupancy).
template <typename In, int T, class Route>
cudaError_t launch_cluster(const QrArgs& a, int blocks, int smem,
                           cudaStream_t s, int* occupancy) {
  auto kernel = gram_qr_cluster_kernel<In, T, Route>;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = a.cluster;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveClusters(occupancy, kernel, &cfg);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename In>
cudaError_t dispatch_cluster(const QrArgs& a, int tile, int vec, int blocks,
                             int smem, cudaStream_t s, int* occupancy) {
  switch (tile) {
    case 16:
      return launch_cluster<In, 16, Tri<In, 16, false>>(a, blocks, smem, s,
                                                        occupancy);
    case 32:
      return vec ? launch_cluster<In, 32, Tri<In, 32, true>>(
                       a, blocks, smem, s, occupancy)
                 : launch_cluster<In, 32, Tri<In, 32, false>>(
                       a, blocks, smem, s, occupancy);
    case 64:
      return vec ? launch_cluster<In, 64, Tri<In, 64, true>>(
                       a, blocks, smem, s, occupancy)
                 : launch_cluster<In, 64, Tri<In, 64, false>>(
                       a, blocks, smem, s, occupancy);
    default: return cudaErrorInvalidValue;
  }
}

template <typename In, int T, class Route>
cudaError_t launch(const QrArgs& a, int blocks, int smem, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_qr_kernel<In, T, Route>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  gram_qr_kernel<In, T, Route><<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename In>
cudaError_t dispatch_simt(const QrArgs& a, int tile, int vec, int blocks,
                          int smem, cudaStream_t s) {
  switch (tile) {
    case 8:
      return launch<In, 8, Rows<In>>(a, blocks, smem, s);
    case 16:
      return launch<In, 16, Simt<In, 16, false>>(a, blocks, smem, s);
    case 32:
      return vec ? launch<In, 32, Simt<In, 32, true>>(a, blocks, smem, s)
                 : launch<In, 32, Simt<In, 32, false>>(a, blocks, smem, s);
    case 64:
      return vec ? launch<In, 64, Simt<In, 64, true>>(a, blocks, smem, s)
                 : launch<In, 64, Simt<In, 64, false>>(a, blocks, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// G[b] = V_b^T V_b for b < batch. v: (batch, d, r) f32 or bf16; g: (batch,
// r, r) f32; partial and tickets: the fold's scratch; table: the plan's
// work items, groups and unit groups, one int32 run on the card. params (on
// the host, in this order): is_bf16, batch, d, r, tile, tc (tensor cores,
// bf16 only, tile 64; else CUDA cores with tiles of ``tile``), vec (16-byte
// shared-memory reads), pairs, ranges (a tile pair), rows_per_range,
// chunk_rows, stride, buf_elems, blocks, smem, n_groups, the offsets of the
// groups and the unit groups in table, cluster (the cluster route's blocks
// a cluster, 2-16; 1: the staged or direct route), clusters (the row
// clusters of a part; ranges = cluster * clusters), parts (of a tile
// pair's micro-tiles) and recv_offset (bytes of shared memory before the
// slices' copies, a multiple of 16). One
// array, so a launch converts few arguments on the host. Returns the CUDA
// error code of the launch (0 on success): a cluster launch the card
// refuses is an error, never another route.
static int qr_run(const void* v, float* g, float* partial, int* tickets,
                  const int* table, const int* params, cudaStream_t s,
                  int* occupancy) {
  const int is_bf16 = params[0], batch = params[1], d = params[2],
            r = params[3], tile = params[4], tc = params[5], vec = params[6],
            pairs = params[7], ranges = params[8];
  const int blocks = params[13], smem = params[14];
  const int cluster = params[18], clusters = params[19], parts = params[20],
            recv_offset = params[21];
  if (batch < 1 || d < 1 || r < 1 || blocks < 1 || params[10] % 16 != 0 ||
      ranges < 1 || parts < 1 || blocks != batch * pairs * parts * ranges ||
      (tc && (!is_bf16 || tile != 64 || r % 8 != 0)) ||
      (vec && (is_bf16 || tile < 32 || r % 4 != 0)) || cluster < 1 ||
      (cluster > 1 && (tc || tile < 16 || cluster > kMaxCluster ||
                       (cluster & (cluster - 1)) != 0 || clusters < 1 ||
                       ranges != cluster * clusters || parts > 36 ||
                       recv_offset % 16 != 0 ||
                       recv_offset + tile * tile * 4 > smem)) ||
      (cluster == 1 && (parts != 1 || occupancy != nullptr)))
    return (int)cudaErrorInvalidValue;
  QrArgs a{v, g, partial, tickets, table,
           table ? table + params[16] : nullptr,
           table ? table + params[17] : nullptr, params[15], d, r, pairs,
           ranges, params[9], params[10], params[11], params[12],
           (size_t)batch * d * r, cluster, clusters, parts, recv_offset};
  if (cluster > 1)
    return (int)(is_bf16 ? dispatch_cluster<__nv_bfloat16>(
                               a, tile, vec, blocks, smem, s, occupancy)
                         : dispatch_cluster<float>(a, tile, vec, blocks,
                                                   smem, s, occupancy));
  if (tc) return (int)launch<__nv_bfloat16, 64, Tc>(a, blocks, smem, s);
  return (int)(is_bf16 ? dispatch_simt<__nv_bfloat16>(a, tile, vec, blocks,
                                                       smem, s)
                       : dispatch_simt<float>(a, tile, vec, blocks, smem, s));
}

int gram_qr_launch(const void* v, float* g, float* partial, int* tickets,
                   const int* table, const int* params, void* stream_ptr) {
  return qr_run(v, g, partial, tickets, table, params,
                static_cast<cudaStream_t>(stream_ptr), nullptr);
}

// How many clusters of a cluster route plan (``params`` as above) the card
// holds at once, into *out (cudaOccupancyMaxActiveClusters). Returns the
// CUDA error code.
int gram_qr_cluster_occupancy(const int* params, int* out) {
  return qr_run(nullptr, nullptr, nullptr, nullptr, nullptr, params, 0, out);
}

}  // extern "C"
