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

}  // extern "C"
