// Hopper (sm_90a) slab and grid products of F-DOT and B-DOT.
//
// Replaces: repro/kernels/slab_ops.py
//   batched_slab_tq_pallas     Z[i]    = X_i^T Q_i    (F-DOT step 1)
//   grid_block_tq_pallas       Z[i, j] = X_ij^T Q_i   (B-DOT stage 1)
//   batched_slab_apply_pallas  V[i]    = X_i S_i      (F-DOT step 3)
//   grid_block_apply_pallas    V[i, j] = X_ij S_j     (B-DOT stage 2)
//
// Both kernels take a stack of B = I * J blocks of X, each (d, n) row-major,
// flattened in grid order (b = i * J + j). In the tq kernel block b reads
// Q[b / J] (Q follows the grid row); in the apply kernel it reads S[b % J]
// (S follows the grid column). The slab kernels are the grids (I, J) =
// (N, 1) for tq and (1, N) for apply, so one source serves all four.
//
// What bounds them on the H100: bytes. Each streams X once (d * n floats a
// block) and does 2 r flops per element of X: at r = 7 that is 3.5 flop per
// byte of X, far below the ~20 flop/byte where the 67 TFLOP/s of f32 FMA on
// the CUDA cores would overtake the 3.35 TB/s of HBM. f32 FMAs on CUDA
// cores, no TF32 (the reference is float32 throughout).
//
// tq (Z = X^T Q, output (n, r) per block, no reduction across blocks):
//  * one thread per column of X: a warp reads 32 consecutive floats of a row
//    of X (coalesced), 8 rows in flight per thread (the ragged last group
//    of fewer than 8 rows too); the sum over d runs in order in registers.
//  * Q[b / J] is staged in shared memory (rows padded to a multiple of 4
//    floats, read as float4 broadcasts); a tall Q is staged in chunks of
//    rows.
//  * the (256, r) output tile is contiguous in Z but a thread's r floats sit
//    at stride r: the tile is staged in shared memory and stored by the
//    block in one coalesced sweep.
//
// apply (V = X S, output (d, r) per block, a sum over the long sample axis),
// one launch:
//  * a persistent grid, at most one block an SM; the work is the (unit,
//    tile) pairs, a unit being a block b of the stack and a chunk of at most
//    8 x ROWS of its rows (F-DOT's 55 rows: 1 chunk; B-DOT's 256: 4), a tile
//    C (<= 256) columns. The wrapper (``_apply_plan`` in slab_ops.py) cuts
//    them, unit-major, into one contiguous range a block, from the shapes
//    alone.
//  * each tile, the chunk's rows x C columns of X and the matching C x r
//    floats of S[b % J], streams into a ring of 2-8 stages in shared memory
//    under one mbarrier a stage: X as a TMA box of a 3-D tensor map over (n,
//    d, B), S (rows of r floats, no 16-byte row stride) as one 1-D bulk copy.
//    Thread 0 refills a stage as soon as the block has consumed it, so the
//    other stages (~130 KB) are in flight while a tile is computed. Where n
//    % 4 != 0 (the row stride of X and the offsets into S are not 16-byte
//    aligned) every thread fills the same ring with 4-byte cp.async copies
//    instead, counted on the same mbarriers.
//  * the chunk's rows are dealt out evenly to the 8 warps (at d = 55: seven
//    warps of 7 rows and one of 6, so no warp idles); a warp's lanes walk
//    the tile's columns, 4 at a time for r <= 8 (x a float4 a row, S r
//    float4s, both without bank conflicts at odd r), and keep ROWS x r
//    sums in registers for the whole work item. At the item's end a
//    butterfly of shuffles combines the lanes' sums (fixed order).
//  * the sample axis of a unit is split over several blocks: each block
//    writes its partial, fences and takes a ticket (an atomic counter, never
//    an atomic sum); the last block sums the partials in a fixed order (in
//    two levels where a unit has many blocks) and resets the ticket
//    (hopper::fold_partials). The same bits on every run, and no second
//    launch.
//
// Ragged edges: a tile past n and rows past d are masked; any d, n >= 1 and
// 1 <= r <= 64 are taken. The zero padding of the reference's stacks is data
// like any other.
//
// The packed route (both products, for stacks of many small blocks: B-DOT's
// 4 x 4,096 grid of 196 x 16 blocks). The kernels above are cut for a long
// sample axis: at n = 16 the tq grid is one block of 256 threads for each
// grid block, 16 of them holding a column, each staging Q anew; the apply
// plan lands 49 x 256 tiles of which 16 columns are data. Both are bound by
// latency there, not bytes. The packed kernel, one launch a call:
//  * a persistent grid, at most one block an SM; block g walks the grid
//    blocks [starts[g], starts[g + 1]) (the wrapper's ``packed_plan``, from
//    the shapes alone). X_b is contiguous (d n floats), so a stage of G
//    consecutive grid blocks is one contiguous run: one 1-D bulk copy under
//    one mbarrier (apply: and S of the G blocks' grid columns, one or two
//    bulk copies, since the columns wrap at J). A ring of 2-8 stages keeps
//    ~100-200 KB in flight an SM. Where a run or its start is not a 16-byte
//    multiple, every thread fills the same ring with 4-byte cp.async copies.
//  * tq: a warp takes a grid block's group of U column units (U <= 32, the
//    plan's, narrower where a stage holds fewer blocks than there are
//    warps): its lanes are (column unit, row phase) pairs, a unit being
//    a float4 of columns (n % 4 == 0, r <= 16) or one column; each lane sums
//    its rows of d in order, the phases are added by xor shuffles in one
//    fixed order. Q of a grid row is staged in shared memory once for each
//    grid row a block's range meets (two slots, G <= J, so a stage meets at
//    most two rows).
//  * apply: a warp takes a grid block (or a slice of its rows where a stage
//    holds fewer blocks than there are warps); its lanes are (row, column
//    unit) pairs, each holding its unit's rows of S_j in registers, so a
//    row of X is read once as float4s (consecutive lanes on consecutive 16
//    bytes: no bank conflict) and the row's units are added by xor shuffles
//    in one fixed order. Each output element is summed by one lane group:
//    no partials, no tickets, no fold.
// Still bytes: 2 r flops per element of X (2.5 flop a byte at r = 5), f32
// FMAs on the CUDA cores; tensor cores would buy nothing. No atomics: the
// same bits on every run.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQChunkFloats = 8192;   // Q rows staged at once: 32 KB
constexpr int kUnroll = 8;            // rows of X in flight per tq thread
constexpr int kApplyVals = 64;        // ROWS * RMAX sums a lane of apply
constexpr int kMaxStages = 8;

inline int tq_chunk_rows(int d, int r) {
  const int r4 = (r + 3) / 4;
  const int rows = kQChunkFloats / (4 * r4);
  return d < rows ? d : rows;
}

inline size_t tq_smem_bytes(int d, int r) {
  const int r4 = (r + 3) / 4;
  return sizeof(float) * ((size_t)tq_chunk_rows(d, r) * 4 * r4 +
                          (size_t)kThreads * r);
}

// A ring stage of apply: the X tile (rows x cols), then the S chunk (cols x
// r), padded to 1024 bytes.
__host__ __device__ inline size_t apply_stage_bytes(int rows, int cols,
                                                    int r) {
  return ((size_t)4 * cols * (rows + r) + 1023) & ~(size_t)1023;
}

// Dynamic shared memory of apply: alignment slack, the ring, the mbarriers.
inline size_t apply_smem_bytes(int rows, int cols, int r, int stages) {
  return 1024 + stages * apply_stage_bytes(rows, cols, r) + 8 * (size_t)stages;
}

// acc += X[k : k + count, c] (count <= U rows) times the staged Q rows.
template <int R4, int U>
__device__ __forceinline__ void tq_rows(const float* xk, const float4* qs,
                                        int n, int r4, int k, int count,
                                        float* acc) {
  float xv[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    xv[u] = u < count ? __ldg(xk + (size_t)(k + u) * n) : 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < count) {                       // staged rows past the chunk are stale
      const float4* qrow = qs + (k + u) * r4;
#pragma unroll
      for (int j4 = 0; j4 < R4; ++j4) {
        if (j4 < r4) {
          const float4 qv = qrow[j4];
          acc[4 * j4] = fmaf(xv[u], qv.x, acc[4 * j4]);
          acc[4 * j4 + 1] = fmaf(xv[u], qv.y, acc[4 * j4 + 1]);
          acc[4 * j4 + 2] = fmaf(xv[u], qv.z, acc[4 * j4 + 2]);
          acc[4 * j4 + 3] = fmaf(xv[u], qv.w, acc[4 * j4 + 3]);
        }
      }
    }
  }
}

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
slab_tq_kernel(const float* __restrict__ x, const float* __restrict__ q,
               float* __restrict__ z, int J, int d, int n, int r, int kc) {
  constexpr int R4 = RMAX / 4;
  extern __shared__ float4 smem4[];
  const int r4 = (r + 3) / 4;
  float4* qs = smem4;                                     // kc * r4 float4
  float* zs = reinterpret_cast<float*>(smem4 + kc * r4);  // kThreads * r
  float* qsf = reinterpret_cast<float*>(smem4);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kThreads;
  const int c = c0 + threadIdx.x;
  const bool valid = c < n;
  const float* xc = x + (size_t)b * d * n + (valid ? c : 0);
  const float* qb = q + (size_t)(b / J) * d * r;

  float acc[RMAX];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kc) {
    const int rows = d - k0 < kc ? d - k0 : kc;
    __syncthreads();                     // previous chunk fully consumed
    const int width = 4 * r4;
    for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
      const int k = idx / width, j = idx - k * width;
      qsf[idx] = j < r ? qb[(size_t)(k0 + k) * r + j] : 0.f;
    }
    __syncthreads();
    if (valid) {
      const float* xk = xc + (size_t)k0 * n;
      // kUnroll rows at a time: every load of a group is issued before the
      // first FMA waits on one
      int k = 0;
      for (; k + kUnroll <= rows; k += kUnroll)
        tq_rows<R4, kUnroll>(xk, qs, n, r4, k, kUnroll, acc);
      // the ragged tail, one group too (a predicated loop is slower code, so
      // the full groups above stay unpredicated)
      if (k < rows) tq_rows<R4, kUnroll>(xk, qs, n, r4, k, rows - k, acc);
    }
  }

  // the (cols, r) tile is contiguous in Z: stage it, then store coalesced
  if (valid) {
#pragma unroll
    for (int j = 0; j < RMAX; ++j)
      if (j < r) zs[threadIdx.x * r + j] = acc[j];
  }
  __syncthreads();
  const int cols = n - c0 < kThreads ? n - c0 : kThreads;
  float* zt = z + ((size_t)b * n + c0) * r;
  for (int idx = threadIdx.x; idx < cols * r; idx += kThreads) zt[idx] = zs[idx];
}

struct ApplyArgs {
  const float* x;                   // (B, d, n)
  const float* s;                   // (J, n, r)
  float* partial;                   // (slots, rows, r) scratch
  float* v;                         // (B, d, r) output
  int* tickets;                     // (groups + units,) zero before and after
  const int* items;                 // (items, 6): unit, first tile, end tile,
                                    // tile step, partial slot (-1: the
                                    // unit's sole item), group
  const int* block_items;           // (grid + 1,): a block's first item
  const int* groups;                // (groups, 3): see hopper::fold_partials
  const int* unit_groups;           // (units + 1,): a unit's first group
  int J, d, n, r, chunks, rows, rpw, cols, stages, tma, n_groups;
};

// Put tile ``tile`` of unit ``unit`` (X rows and S columns) into a stage.
__device__ __forceinline__ void apply_load(const ApplyArgs& a,
                                           const CUtensorMap* map,
                                           uint32_t stage, uint32_t bar,
                                           int unit, int tile, int tid) {
  const int b = unit / a.chunks, k0 = (unit - b * a.chunks) * a.rows;
  const int c0 = tile * a.cols;
  const int cols = a.n - c0 < a.cols ? a.n - c0 : a.cols;
  const float* sc = a.s + ((size_t)(b % a.J) * a.n + c0) * a.r;
  const uint32_t s_dst = stage + 4 * a.rows * a.cols;
  if (a.tma) {
    if (tid == 0) {
      const uint32_t s_bytes = 4u * ((cols + 3) & ~3) * a.r;
      hopper::mbar_expect_tx(bar, 4u * a.rows * a.cols + s_bytes);
      hopper::tma_load_3d(stage, map, bar, c0, k0, b);
      hopper::bulk_load(s_dst, sc, s_bytes, bar);
    }
    return;
  }
  const float* xb = a.x + (size_t)b * a.d * a.n;
  for (int idx = tid; idx < a.rows * a.cols; idx += kThreads) {
    const int row = idx / a.cols, c = idx - row * a.cols;
    const bool valid = k0 + row < a.d && c < cols;
    hopper::cp_async_4(stage + 4 * idx,
                       valid ? xb + (size_t)(k0 + row) * a.n + c0 + c : a.x,
                       valid);
  }
  for (int idx = tid; idx < cols * a.r; idx += kThreads)
    hopper::cp_async_4(s_dst + 4 * idx, sc + idx, true);
  hopper::cp_async_arrive(bar);
}

// acc[m][j] += x[row0 + m, c] S[c, j] over the tile's columns c < cols.
// EXACT (r == R, R <= 8): a lane takes 4 columns at a time, x of each row
// as one float4 and the 4 x R floats of S as R float4s (conflict-free for
// odd R), the columns of a ragged last group masked to 0 in S; else (r <=
// R) one column at a time with scalar reads.
template <int R, bool EXACT, int ROWS>
__device__ __forceinline__ void apply_tile(const float* xs, const float* ss,
                                           int stride, int r, int cols,
                                           int row0, int mine, int lane,
                                           float (&acc)[ROWS][R]) {
  if constexpr (EXACT) {
    for (int c4 = 4 * lane; c4 < cols; c4 += 128) {
      float sv[4 * R];
      const float4* s4 = reinterpret_cast<const float4*>(ss + c4 * R);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float4 w = s4[k];
        sv[4 * k] = w.x;
        sv[4 * k + 1] = w.y;
        sv[4 * k + 2] = w.z;
        sv[4 * k + 3] = w.w;
      }
      if (c4 + 4 > cols) {               // S past cols is stale: mask it
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < R; ++j)
            sv[q * R + j] = c4 + q < cols ? sv[q * R + j] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        if (m < mine) {
          const float4 w = *reinterpret_cast<const float4*>(
              xs + (row0 + m) * stride + c4);
          const float xq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < R; ++j)
              acc[m][j] = fmaf(xq[q], sv[q * R + j], acc[m][j]);
        }
      }
    }
  } else {
    for (int cc = lane; cc < cols; cc += 32) {
      float sv[R];
#pragma unroll
      for (int j = 0; j < R; ++j) sv[j] = j < r ? ss[cc * r + j] : 0.f;
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        if (m < mine) {
          const float xv = xs[(row0 + m) * stride + cc];
#pragma unroll
          for (int j = 0; j < R; ++j) acc[m][j] = fmaf(xv, sv[j], acc[m][j]);
        }
      }
    }
  }
}

template <int R, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
slab_apply_kernel(const __grid_constant__ CUtensorMap xmap, const ApplyArgs a) {
  constexpr int RMAX = R;
  constexpr int ROWS = kApplyVals / (R <= 8 ? 8 : R);  // rows a warp, at most
  extern __shared__ unsigned char smem_raw[];
  __shared__ int is_last;
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* basep = smem_raw + (base - raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = a.r, stages = a.stages;
  const uint32_t stage_bytes = (uint32_t)apply_stage_bytes(a.rows, a.cols, r);
  const uint32_t bar0 = base + stages * stage_bytes;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      hopper::mbar_init(bar0 + 8 * s, a.tma ? 1 : kThreads);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int first = a.block_items[blockIdx.x];
  const int last = a.block_items[blockIdx.x + 1];
  // the producer's walk over (item, tile): items are never empty
  int p_item = first, p_tile = first < last ? a.items[6 * first + 1] : 0;
  int pseq = 0;
  auto issue = [&]() {
    if (p_item >= last) return;
    const int ps = pseq % stages;
    apply_load(a, &xmap, base + ps * stage_bytes, bar0 + 8 * ps,
               a.items[6 * p_item], p_tile, tid);
    ++pseq;
    p_tile += a.items[6 * p_item + 3];
    if (p_tile >= a.items[6 * p_item + 2] && ++p_item < last)
      p_tile = a.items[6 * p_item + 1];
  };
  for (int s = 0; s < stages; ++s) issue();

  int seq = 0;
  for (int it = first; it < last; ++it) {
    const int unit = a.items[6 * it];
    const int b = unit / a.chunks, k0 = (unit - b * a.chunks) * a.rows;
    const int unit_rows = a.d - k0 < a.rows ? a.d - k0 : a.rows;
    const int row0 = warp * a.rpw;
    int mine = unit_rows - row0 < a.rpw ? unit_rows - row0 : a.rpw;
    mine = mine < 0 ? 0 : mine;

    float acc[ROWS][RMAX];
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
#pragma unroll
      for (int j = 0; j < RMAX; ++j) acc[m][j] = 0.f;

    for (int tile = a.items[6 * it + 1]; tile < a.items[6 * it + 2];
         tile += a.items[6 * it + 3], ++seq) {
      const int s = seq % stages;
      hopper::mbar_wait(bar0 + 8 * s, (seq / stages) & 1);
      const float* xs =
          reinterpret_cast<const float*>(basep + s * stage_bytes);
      const float* ss = xs + a.rows * a.cols;
      const int c0 = tile * a.cols;
      const int cols = a.n - c0 < a.cols ? a.n - c0 : a.cols;
      apply_tile<R, EXACT, ROWS>(xs, ss, a.cols, r, cols, row0, mine, lane,
                                 acc);
      __syncthreads();                  // stage s consumed by every warp
      issue();
    }

    // lanes' sums -> one per (row, j): a butterfly, the same order every
    // run; a unit's sole item writes V, any other its partial
    const int slot = a.items[6 * it + 4];
    float* out = slot < 0 ? a.v + ((size_t)b * a.d + k0) * r
                          : a.partial + (size_t)slot * a.rows * r;
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
#pragma unroll
      for (int j = 0; j < RMAX; ++j) {
        if (j < r) {
          float t = acc[m][j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            t += __shfl_xor_sync(0xffffffffu, t, off);
          if (lane == 0 && m < mine) out[(row0 + m) * r + j] = t;
        }
      }
    }
    if (slot >= 0)
      hopper::fold_partials(a.items, a.groups, a.unit_groups, a.tickets,
                            a.n_groups, a.partial, (size_t)a.rows * r,
                            unit_rows * r, a.v + ((size_t)b * a.d + k0) * r,
                            1.f, it, &is_last);
  }
}

// -- the packed route -------------------------------------------------------
constexpr int kPackedAlign = 128;     // a stage's alignment in shared memory
constexpr int kPackedMaxStages = 8;

// A stage of the packed ring: G grid blocks of X (d x n each), then for
// apply their G chunks of S (n x r each), padded to 128 bytes.
__host__ __device__ inline size_t packed_stage_bytes(int apply, int G, int d,
                                                     int n, int r) {
  const size_t per = (size_t)d * n + (apply ? (size_t)n * r : 0);
  return (4 * (size_t)G * per + kPackedAlign - 1) &
         ~(size_t)(kPackedAlign - 1);
}

// tq's two Q slots: d rows of r floats padded to float4s.
__host__ __device__ inline size_t packed_q_bytes(int apply, int d, int r) {
  return apply ? 0 : 2 * (size_t)d * 16 * ((r + 3) / 4);
}

// Dynamic shared memory of a packed block: alignment slack, the ring, the
// Q slots (tq), the mbarriers.
__host__ __device__ inline size_t packed_smem_bytes(int apply, int G, int d,
                                                    int n, int r,
                                                    int stages) {
  return kPackedAlign + stages * packed_stage_bytes(apply, G, d, n, r) +
         packed_q_bytes(apply, d, r) + 8 * (size_t)stages;
}

struct PackedArgs {
  const float* x;                   // (B, d, n)
  const float* y;                   // tq: Q (B / J, d, r); apply: S (J, n, r)
  float* out;                       // tq: Z (B, n, r); apply: V (B, d, r)
  const int* starts;                // (grid + 1,): a block's first grid block
  int J, d, n, r, G, H, U, stages, bulk;  // U: lanes a row / a row phase
};

// Put grid blocks [b0, b0 + cnt) into the stage at ``dst``: X, then (apply)
// S of their grid columns b % J, which run from b0 % J and wrap at J once at
// most (cnt <= G <= J).
template <bool APPLY>
__device__ __forceinline__ void packed_load(const PackedArgs& a, uint32_t dst,
                                            uint32_t bar, int b0, int cnt,
                                            int tid) {
  const int xf = cnt * a.d * a.n;
  const float* xsrc = a.x + (size_t)b0 * a.d * a.n;
  const int per_s = a.n * a.r;
  const int j0 = APPLY ? b0 % a.J : 0;
  const int before = APPLY ? min(cnt, a.J - j0) : 0;   // blocks before the wrap
  const uint32_t s_dst = dst + 4u * xf;
  if (a.bulk) {
    if (tid == 0) {
      hopper::mbar_expect_tx(bar, 4u * (xf + (APPLY ? cnt * per_s : 0)));
      hopper::bulk_load(dst, xsrc, 4u * xf, bar);
      if constexpr (APPLY) {
        hopper::bulk_load(s_dst, a.y + (size_t)j0 * per_s,
                          4u * before * per_s, bar);
        if (cnt > before)
          hopper::bulk_load(s_dst + 4u * before * per_s, a.y,
                            4u * (cnt - before) * per_s, bar);
      }
    }
    return;
  }
  for (int i = tid; i < xf; i += kThreads)
    hopper::cp_async_4(dst + 4u * i, xsrc + i, true);
  if constexpr (APPLY) {
    for (int i = tid; i < cnt * per_s; i += kThreads) {
      const int g = i / per_s, j = j0 + g < a.J ? j0 + g : j0 + g - a.J;
      hopper::cp_async_4(s_dst + 4u * i,
                         a.y + (size_t)j * per_s + (i - g * per_s), true);
    }
  }
  hopper::cp_async_arrive(bar);
}

// Q of grid row ``row`` into a slot: d rows padded to float4s with zeros.
__device__ __forceinline__ void packed_stage_q(const PackedArgs& a,
                                               float* slot, int row,
                                               int tid) {
  const int width = 4 * ((a.r + 3) / 4);
  const float* src = a.y + (size_t)row * a.d * a.r;
  for (int i = tid; i < a.d * width; i += kThreads) {
    const int k = i / width, j = i - k * width;
    slot[i] = j < a.r ? __ldg(src + k * a.r + j) : 0.f;
  }
}

// x[k, cu VEC : cu VEC + VEC] from the stage (VEC = 4: a float4; n % 4 == 0).
template <int VEC>
__device__ __forceinline__ void packed_x(const float* row, int cu,
                                         float (&xv)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 w = *reinterpret_cast<const float4*>(row + 4 * cu);
    xv[0] = w.x;
    xv[1] = w.y;
    xv[2] = w.z;
    xv[3] = w.w;
  } else {
    xv[0] = row[cu];
  }
}

// tq on a landed stage: Z[b] = X_b^T Q[b / J] for its cnt grid blocks.
template <int R, bool EXACT, int VEC>
__device__ __forceinline__ void packed_tq_stage(const PackedArgs& a,
                                                const float* xs,
                                                const float4* qs, int b0,
                                                int cnt, int lane, int warp) {
  constexpr int R4 = (R + 3) / 4;
  const int d = a.d, n = a.n, r = a.r, r4 = (r + 3) / 4;
  const int units = (n + VEC - 1) / VEC, width = a.U;
  const int phases = 32 / width, groups = (units + width - 1) / width;
  const int p = lane / width, u = lane & (width - 1);
  for (int task = warp; task < cnt * groups; task += kWarps) {
    const int g = task / groups, b = b0 + g;
    const int cu = (task - g * groups) * width + u;
    const bool valid = cu < units;
    const float* xb = xs + (size_t)g * d * n;
    const float4* qb = qs + (size_t)((b / a.J) & 1) * d * r4;
    float acc[VEC][R];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[e][j] = 0.f;
    if (valid) {
#pragma unroll 4
      for (int k = p; k < d; k += phases) {
        float xv[VEC];
        packed_x<VEC>(xb + k * n, cu, xv);
        const float4* qrow = qb + k * r4;
#pragma unroll
        for (int j4 = 0; j4 < R4; ++j4) {
          if (EXACT || j4 < r4) {
            const float4 w = qrow[j4];
            const float qv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              if (4 * j4 + t < R) {
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                  acc[e][4 * j4 + t] =
                      fmaf(xv[e], qv[t], acc[e][4 * j4 + t]);
              }
            }
          }
        }
      }
    }
    // the row phases, added in one fixed order (every lane of a unit ends
    // with the same sums)
    for (int off = width; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int j = 0; j < R; ++j)
          acc[e][j] += __shfl_xor_sync(0xffffffffu, acc[e][j], off);
    }
    if (valid) {                        // the phases share the stores
      float* zb = a.out + ((size_t)b * n + cu * VEC) * r;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int j = 0; j < R; ++j)
          if ((EXACT || j < r) && (e * R + j) % phases == p)
            zb[e * r + j] = acc[e][j];
    }
  }
}

// apply on a landed stage: V[b] = X_b S[b % J] for its cnt grid blocks, a
// task being a grid block's slice of rows (H slices a block).
template <int R, bool EXACT, int VEC, int UPL>
__device__ __forceinline__ void packed_apply_stage(const PackedArgs& a,
                                                   const float* xs, int b0,
                                                   int cnt, int lane,
                                                   int warp) {
  const int d = a.d, n = a.n, r = a.r, H = a.H;
  const float* ss = xs + (size_t)cnt * d * n;
  const int units = (n + VEC - 1) / VEC, width = a.U;
  const int rows = 32 / width, rs = lane / width, u = lane & (width - 1);
  for (int task = warp; task < cnt * H; task += kWarps) {
    const int g = task / H, h = task - g * H, b = b0 + g;
    const int k_lo = h * d / H, k_hi = (h + 1) * d / H;
    const float* xb = xs + (size_t)g * d * n;
    const float* sb = ss + (size_t)g * n * r;
    // this lane's units of S_j, in registers for the whole task
    float sv[UPL][VEC][R];
#pragma unroll
    for (int s = 0; s < UPL; ++s)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int cu = u + s * width;
          sv[s][e][j] = cu < units && (EXACT || j < r)
                            ? sb[(cu * VEC + e) * r + j] : 0.f;
        }
#pragma unroll 2
    for (int k0 = k_lo; k0 < k_hi; k0 += rows) {
      const int k = k0 + rs;
      const bool row_ok = k < k_hi;
      float acc[R];
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j] = 0.f;
      if (row_ok) {
#pragma unroll
        for (int s = 0; s < UPL; ++s) {
          const int cu = u + s * width;
          if (cu < units) {
            float xv[VEC];
            packed_x<VEC>(xb + k * n, cu, xv);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
#pragma unroll
              for (int j = 0; j < R; ++j)
                acc[j] = fmaf(xv[e], sv[s][e][j], acc[j]);
          }
        }
      }
      // the row's column units, added in one fixed order
      for (int off = 1; off < width; off <<= 1) {
#pragma unroll
        for (int j = 0; j < R; ++j)
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      }
      if (row_ok) {                     // the units share the stores
        float* vb = a.out + ((size_t)b * d + k) * r;
#pragma unroll
        for (int j = 0; j < R; ++j)
          if ((EXACT || j < r) && (j & (width - 1)) == u) vb[j] = acc[j];
      }
    }
  }
}

template <bool APPLY, int R, bool EXACT, int VEC, int UPL>
__global__ void __launch_bounds__(kThreads, 1)
slab_packed_kernel(const PackedArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + kPackedAlign - 1) & ~(uint32_t)(kPackedAlign - 1);
  unsigned char* basep = smem_raw + (base - raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, stages = a.stages;
  const uint32_t stage_bytes =
      (uint32_t)packed_stage_bytes(APPLY, G, a.d, a.n, a.r);
  const uint32_t q_at = stages * stage_bytes;
  const uint32_t bar0 = base + q_at + (uint32_t)packed_q_bytes(APPLY, a.d, a.r);
  float* qsf = reinterpret_cast<float*>(basep + q_at);
  const int q_slot = 4 * ((a.r + 3) / 4) * a.d;          // floats a Q slot

  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      hopper::mbar_init(bar0 + 8 * s, a.bulk ? 1 : kThreads);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int first = a.starts[blockIdx.x], end = a.starts[blockIdx.x + 1];
  const int n_seq = (end - first + G - 1) / G;
  auto issue = [&](int seq) {
    if (seq >= n_seq) return;
    const int s = seq % stages, b0 = first + seq * G;
    packed_load<APPLY>(a, base + s * stage_bytes, bar0 + 8 * s, b0,
                       min(G, end - b0), tid);
  };
  for (int s = 0; s < stages; ++s) issue(s);

  int staged0 = -1, staged1 = -1;       // the grid rows in the Q slots
  for (int seq = 0; seq < n_seq; ++seq) {
    const int s = seq % stages, b0 = first + seq * G;
    const int cnt = min(G, end - b0);
    if constexpr (!APPLY) {
      // Q of the grid rows this stage meets, each once a range (slot row %
      // 2); the slot's old row was last read before the previous stage's
      // __syncthreads
      const int lo = b0 / a.J, hi = (b0 + cnt - 1) / a.J;
      bool fresh = false;
      for (int row = lo; row <= hi; ++row) {
        if ((row & 1) ? staged1 != row : staged0 != row) {
          packed_stage_q(a, qsf + (row & 1) * q_slot, row, tid);
          if (row & 1) staged1 = row; else staged0 = row;
          fresh = true;
        }
      }
      if (fresh) __syncthreads();
    }
    hopper::mbar_wait(bar0 + 8 * s, (seq / stages) & 1);
    const float* xs = reinterpret_cast<const float*>(basep + s * stage_bytes);
    if constexpr (APPLY)
      packed_apply_stage<R, EXACT, VEC, UPL>(a, xs, b0, cnt, lane, warp);
    else
      packed_tq_stage<R, EXACT, VEC>(a, xs, reinterpret_cast<float4*>(qsf),
                                     b0, cnt, lane, warp);
    __syncthreads();                    // stage s consumed by every warp
    issue(seq + stages);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int RMAX>
cudaError_t launch_tq(const float* x, const float* q, float* z, int blocks,
                      int J, int d, int n, int r, cudaStream_t stream) {
  const size_t smem = tq_smem_bytes(d, r);
  cudaError_t err = set_smem(slab_tq_kernel<RMAX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kThreads - 1) / kThreads, blocks);
  slab_tq_kernel<RMAX><<<grid, kThreads, smem, stream>>>(
      x, q, z, J, d, n, r, tq_chunk_rows(d, r));
  return cudaGetLastError();
}

template <int R, bool EXACT>
cudaError_t launch_apply(const CUtensorMap& map, const ApplyArgs& a, int grid,
                         size_t smem, cudaStream_t stream) {
  cudaError_t err = set_smem(slab_apply_kernel<R, EXACT>, smem);
  if (err != cudaSuccess) return err;
  slab_apply_kernel<R, EXACT><<<grid, kThreads, smem, stream>>>(map, a);
  return cudaGetLastError();
}

template <bool APPLY, int R, bool EXACT, int VEC, int UPL>
cudaError_t launch_packed(const PackedArgs& a, int grid, size_t smem,
                          cudaStream_t stream) {
  cudaError_t err =
      set_smem(slab_packed_kernel<APPLY, R, EXACT, VEC, UPL>, smem);
  if (err != cudaSuccess) return err;
  slab_packed_kernel<APPLY, R, EXACT, VEC, UPL>
      <<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// float4 units, one a lane (UPL = 1): r exact up to 8, else 16 columns
template <bool APPLY, int UPL>
cudaError_t launch_packed_vec4(const PackedArgs& a, int grid, size_t smem,
                               cudaStream_t s) {
  if constexpr (UPL == 2)   // n up to 256: two units a lane, r <= 16
    return a.r <= 8 ? launch_packed<APPLY, 8, false, 4, UPL>(a, grid, smem, s)
                    : launch_packed<APPLY, 16, false, 4, UPL>(a, grid, smem, s);
  switch (a.r) {
    case 1: return launch_packed<APPLY, 1, true, 4, UPL>(a, grid, smem, s);
    case 2: return launch_packed<APPLY, 2, true, 4, UPL>(a, grid, smem, s);
    case 3: return launch_packed<APPLY, 3, true, 4, UPL>(a, grid, smem, s);
    case 4: return launch_packed<APPLY, 4, true, 4, UPL>(a, grid, smem, s);
    case 5: return launch_packed<APPLY, 5, true, 4, UPL>(a, grid, smem, s);
    case 6: return launch_packed<APPLY, 6, true, 4, UPL>(a, grid, smem, s);
    case 7: return launch_packed<APPLY, 7, true, 4, UPL>(a, grid, smem, s);
    case 8: return launch_packed<APPLY, 8, true, 4, UPL>(a, grid, smem, s);
    default: return launch_packed<APPLY, 16, false, 4, UPL>(a, grid, smem, s);
  }
}

// one column a unit: any r up to 64
template <bool APPLY>
cudaError_t launch_packed_vec1(const PackedArgs& a, int grid, size_t smem,
                               cudaStream_t s) {
  if (a.r <= 8) return launch_packed<APPLY, 8, false, 1, 1>(a, grid, smem, s);
  if (a.r <= 16)
    return launch_packed<APPLY, 16, false, 1, 1>(a, grid, smem, s);
  if (a.r <= 32)
    return launch_packed<APPLY, 32, false, 1, 1>(a, grid, smem, s);
  return launch_packed<APPLY, 64, false, 1, 1>(a, grid, smem, s);
}

}  // namespace

extern "C" {

// Z[b] = X_b^T Q[b / J]. x: (blocks, d, n), q: (blocks / J, d, r),
// z: (blocks, n, r), all f32. Returns the CUDA error code (0 on success).
int slab_tq_launch(const float* x, const float* q, float* z, int blocks,
                   int J, int d, int n, int r, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (r <= 8)
    err = launch_tq<8>(x, q, z, blocks, J, d, n, r, stream);
  else if (r <= 16)
    err = launch_tq<16>(x, q, z, blocks, J, d, n, r, stream);
  else if (r <= 32)
    err = launch_tq<32>(x, q, z, blocks, J, d, n, r, stream);
  else if (r <= 64)
    err = launch_tq<64>(x, q, z, blocks, J, d, n, r, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// Bytes of dynamic shared memory apply needs for (rows, cols, r, stages).
size_t slab_apply_smem_bytes(int rows, int cols, int r, int stages) {
  return apply_smem_bytes(rows, cols, r, stages);
}

// V[b] = X_b S[b % J]. x: (blocks, d, n), s: (J, n, r), v: (blocks, d, r),
// all f32; partial: (slots, rows, r) f32 scratch; tickets: (groups + blocks *
// chunks,) int32, zero; items / block_items / groups / unit_groups: the
// wrapper's plan (chunks
// of ``rows`` rows, ``rpw`` of them a warp, tiles of ``cols`` columns). tma =
// 1 reads X through a tensor map and S by bulk copies (n % 4 == 0, x and s
// 16-byte aligned), else cp.async. Returns the CUDA error code of the launch
// (0 on success).
int slab_apply_launch(const float* x, const float* s, float* partial, float* v,
                      int* tickets, const int* items, const int* block_items,
                      const int* groups, const int* unit_groups, int blocks,
                      int J, int d, int n, int r, int chunks, int rows,
                      int rpw, int cols, int stages, int grid, int smem,
                      int tma, int n_groups, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int r_max = r <= 8 ? 8 : (r <= 16 ? 16 : (r <= 32 ? 32 : 64));
  if (r < 1 || r > 64 || rows < 1 || rows > 256 || rpw * kWarps < rows ||
      rpw > kApplyVals / r_max || cols < 4 || cols > 256 || cols % 4 ||
      stages < 2 || stages > kMaxStages || chunks * rows < d ||
      (size_t)smem < apply_smem_bytes(rows, cols, r, stages))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma && !hopper::f32_map_3d(&map, x, (uint64_t)n, (uint64_t)d,
                                 (uint64_t)blocks, (uint32_t)cols,
                                 (uint32_t)rows, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorNotSupported;
  const ApplyArgs a{x, s, partial, v, tickets, items, block_items, groups,
                    unit_groups, J, d, n, r, chunks, rows, rpw, cols, stages,
                    tma, n_groups};
  cudaError_t err;
  switch (r) {
    case 1: err = launch_apply<1, true>(map, a, grid, smem, stream); break;
    case 2: err = launch_apply<2, true>(map, a, grid, smem, stream); break;
    case 3: err = launch_apply<3, true>(map, a, grid, smem, stream); break;
    case 4: err = launch_apply<4, true>(map, a, grid, smem, stream); break;
    case 5: err = launch_apply<5, true>(map, a, grid, smem, stream); break;
    case 6: err = launch_apply<6, true>(map, a, grid, smem, stream); break;
    case 7: err = launch_apply<7, true>(map, a, grid, smem, stream); break;
    case 8: err = launch_apply<8, true>(map, a, grid, smem, stream); break;
    default:
      err = r_max == 16 ? launch_apply<16, false>(map, a, grid, smem, stream)
            : r_max == 32
                ? launch_apply<32, false>(map, a, grid, smem, stream)
                : launch_apply<64, false>(map, a, grid, smem, stream);
  }
  return (int)err;
}

// Bytes of dynamic shared memory a packed block needs (apply = 0: tq).
size_t slab_packed_smem_bytes(int apply, int G, int d, int n, int r,
                              int stages) {
  return packed_smem_bytes(apply, G, d, n, r, stages);
}

// The packed route, one launch: apply = 0 computes Z[b] = X_b^T Q[b / J]
// (y: Q (blocks / J, d, r), out: Z (blocks, n, r)), apply = 1 computes V[b]
// = X_b S[b % J] (y: S (J, n, r), out: V (blocks, d, r)); x: (blocks, d, n),
// all f32. starts: (grid + 1,) int32, block g's grid blocks; the wrapper's
// plan: G grid blocks a stage (G <= J), H row slices a grid block (apply),
// U lanes a row (apply: the units' power of two, at most 32) or a row phase
// (tq: a power of two up to it), ``stages`` ring stages, units of vec = 4
// or 1 columns, upl units a lane (apply). bulk = 1 copies by cp.async.bulk (d n % 4 == 0, for apply n r %
// 4 == 0 too, x and y 16-byte aligned), else by 4-byte cp.async. Returns the
// CUDA error code of the launch (0 on success).
int slab_packed_launch(int apply, const float* x, const float* y, float* out,
                       const int* starts, int blocks, int J, int d, int n,
                       int r, int G, int H, int U, int stages, int grid,
                       int smem, int bulk, int vec, int upl,
                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int units = vec == 4 ? n / 4 : n;
  const int upl_want = apply ? (units + 31) / 32 : 1;
  int lanes = 1;                        // the units' power of two, <= 32
  while (lanes < units && lanes < 32) lanes <<= 1;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  if (r < 1 || r > 64 || d < 1 || n < 1 || blocks < 1 || J < 1 ||
      blocks % J || G < 1 || G > J || H < 1 || H > d || grid < 1 ||
      grid > blocks || stages < 2 || stages > kPackedMaxStages ||
      (vec != 1 && vec != 4) || (vec == 4 && (n % 4 || r > 16)) ||
      upl != upl_want || upl > (vec == 4 ? 2 : 1) || U < 1 || U > lanes ||
      (U & (U - 1)) || (apply && U != lanes) ||
      (bulk && (!aligned || (d * n) % 4 || (apply && (n * r) % 4))) ||
      (size_t)smem < packed_smem_bytes(apply, G, d, n, r, stages))
    return (int)cudaErrorInvalidValue;
  const PackedArgs a{x, y, out, starts, J, d, n, r, G, H, U, stages, bulk};
  cudaError_t err;
  if (apply)
    err = vec == 1 ? launch_packed_vec1<true>(a, grid, smem, stream)
          : upl == 2 ? launch_packed_vec4<true, 2>(a, grid, smem, stream)
                     : launch_packed_vec4<true, 1>(a, grid, smem, stream);
  else
    err = vec == 1 ? launch_packed_vec1<false>(a, grid, smem, stream)
                   : launch_packed_vec4<false, 1>(a, grid, smem, stream);
  return (int)err;
}

}  // extern "C"
