// Hopper (sm_90a) gram-apply: V[i] = X_i (X_i^T Q_i) / n_i over stacked nodes.
//
// Replaces: repro/kernels/gram_update.py  batched_gram_apply_pallas (and
// gram_apply_pallas, which is the N = 1 launch of this kernel).
//
// What bounds it on the H100: bytes. Per node it reads X_i (d x n f32) once
// and does 4*d*n*r flops, i.e. r flops per byte. For the paper's r <= 16 that
// is far below the ~20 flop/byte where the card's 67 TFLOP/s of f32 FMA
// (CUDA cores) overtake its 3.35 TB/s of HBM, so the least time is the time
// to stream X once.
//
// What the design does about it (one launch, X read from device memory once):
//  * A persistent grid, at most one block an SM, each block walking a fixed
//    list of work items (node, tiles) made by the wrapper from the shapes
//    alone (``plan`` in gram_update.py). Where the nodes fit on the SMs a
//    node's tiles are dealt round-robin to blocks of its own, so blocks
//    running side by side read neighbouring columns of the same rows.
//  * What holds it back: the TMA engine streams a tile of 64-byte row
//    segments (1024 rows x 16 columns) at ~15-19 GB/s an SM, ~1.8 TB/s in
//    all, and the kernel takes no longer than that stream alone. Wider rows
//    need more shared memory than the ring has; L2 promotion, 32-byte rows,
//    L2 prefetch and another row stride did not help (PERF.md).
//  * Tiles of X (all d rows x bn columns) stream into a ring of 2-8 stages
//    in shared memory, each stage completing on its own mbarrier: TMA boxes
//    of 256 rows x bn columns of a 3-D tensor map over (n, d, N), swizzled
//    so that the row reads below are free of bank conflicts. Thread 0 issues
//    tile t + stages - 1 as soon as tile t - 1 is consumed, so all but one
//    stage are in flight while a tile is computed. Where the row stride of X
//    is not 16-byte aligned (n % 4 != 0) TMA cannot take it: the same ring is
//    filled by every thread with 4-byte cp.async copies into the same layout,
//    counted on the same mbarriers (cp.async.mbarrier.arrive.noinc).
//  * Thread-owned rows: thread t owns rows t, t + 256, ... of the node. It
//    holds Q_i[k, :] and its V[k, :] sums in registers for the whole item;
//    Q and V never touch shared memory, and every element of X is read
//    from shared memory once. For a batch of CB columns (CB * RMAX = 64
//    values) each thread forms its partial of z_c = x_c^T Q over its rows,
//    the warp reduce-scatters the 64 values with a shuffle butterfly (each
//    step halves the values a lane holds), the 8 warps' sums are added in
//    warp order through shared memory, and each thread adds x[k, c] z_c to
//    its rows of V from the x values it already holds.
//  * The column sum of a node is split over several blocks. Each block
//    writes its (d x r) partial, fences, and takes a ticket (an atomic
//    counter, never an atomic sum); the last block sums the partials in a
//    fixed order and divides by n_true, then resets the ticket, so no memset
//    launch is needed. The same bits on every run. Where a node has many
//    blocks (N = 1 spreads one node over every SM) the partials are summed
//    in two levels, groups of about sqrt(blocks), so that no last block
//    reads them all (hopper::fold_partials).
//  * Columns past ceil(n_true[i]) are padding: whole tiles past them are not
//    loaded, and in the straddling tile the value is masked with a select,
//    so padding that holds NaN cannot leak.
//  * f32 FMAs on CUDA cores, no TF32 (the reference is float32 throughout).
//
// Shared memory: stages x ceil(d / 256) boxes of (min(d, 256) x bn) floats,
// each box 1024-byte aligned; 8 x 64 floats for the warps' sums, 64 for z,
// one mbarrier a stage. gram_update.py's ``smem_bytes`` is the same sum.
//
// The packed route (nodes of few samples: sdot_sparse's 4,096 nodes of 784 x
// 16, r = 5). There a node is one tile of 64-byte rows, and the stream above
// pays for each node what it spreads over many tiles at large n: Q_i loaded
// into registers outside the ring, a butterfly and a cross-warp sum a column
// batch, ~31 nodes walked one after another, each TMA box a run of 64-byte
// segments. Yet X_i (d n floats) and Q_i (d r) are each one contiguous run
// of memory. The packed kernel, one launch a call:
//  * a persistent grid, at most one block an SM; block g walks the nodes
//    [starts[g], starts[g + 1]) (the wrapper's ``packed_plan``, from the
//    shapes alone). A ring stage holds one node whole: X_i and Q_i, each
//    taken by one 1-D bulk copy (cp.async.bulk) completing on the stage's
//    full mbarrier. The 8 consumer warps are two groups of 4, group g
//    taking the range's nodes g, g + 2, ...: while one group waits at its
//    own barriers (named 1 and 2) the other computes, so two nodes are in
//    the SM at a time. A producer warp refills a stage as soon as the 4
//    warps of its group have each arrived on its empty mbarrier, so no
//    warp waits for another at the end of a node.
//  * z = X_i^T Q_i from the stage: the group's warps take 4 ranges of the
//    d rows, a warp's lanes being (column unit, row phase) pairs, a unit a
//    float4 of columns (n % 4 == 0, r <= 16) or one column; each lane sums
//    its rows in order, the row phases are added by xor shuffles in one
//    fixed order, and the warps' sums in warp order through shared memory
//    (two slots a group, by the parity of its nodes), divided by n_true:
//    z'.
//  * V_i = X_i z' from the same stage: a thread takes a row, holds z' (n <=
//    32 rows, up to 128 values; wider r in passes) in registers and sums
//    the row of X against it (no shuffle; the row's loads issued with no
//    branch between them, their chunks rotated over the lanes so that a
//    quarter warp reads 8 different banks); consecutive lanes store
//    consecutive rows of V. X and Q are read from device memory once and V
//    written once. A node is whole in one block: no partials, no tickets,
//    the same bits on every run.
//  * Columns past ceil(n_true[i]) are masked with a select in both
//    products, so padding that holds NaN cannot leak. f32 FMAs on the CUDA
//    cores.
//  * What holds it back (PERF.md): with one group of 8 warps a node's
//    compute (z, the two barriers and the warp-order sum between them, z'
//    into registers, V) took longer than its bytes; two groups bring the
//    compute alone under the ring alone, but 227 KB hold 3 stages, two of
//    them computed on, so one node's bytes are in flight at a time.
// Shared memory: stages x (d (n + r) floats, 128-byte aligned), the warps'
// sums of z (2 slots of 4 n r floats a group), a full and an empty mbarrier
// a stage (``packed_smem_bytes`` in gram_update.py).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBoxRows = 256;       // rows of a TMA box = rows a thread step
constexpr int kVals = 64;           // values reduced a column batch
constexpr int kMaxStages = 8;
constexpr int kMaxRowVals = 128;    // ROWS * RMAX: Q and V held in registers

struct GramArgs {
  const float* x;                   // (nodes, d, n)
  const float* q;                   // (nodes, d, r)
  const float* n_true;              // (nodes,)
  float* partial;                   // (slots, d, r) scratch
  float* v;                         // (nodes, d, r) output
  int* tickets;                     // (groups + nodes,) zero before and after
  const int* items;                 // (items, 6): node, first tile, end tile,
                                    // tile step, partial slot (-1: the
                                    // node's sole item), group
  const int* block_items;           // (grid + 1,): a block's first item
  const int* groups;                // (groups, 3): see hopper::fold_partials
  const int* node_groups;           // (nodes + 1,): a node's first group
  int d, n, r, bn, stages, box_rows, tma, n_groups;
};

__host__ __device__ inline uint32_t box_stride_bytes(int box_rows, int bn) {
  return ((uint32_t)box_rows * bn * 4 + 1023u) & ~1023u;
}

__host__ __device__ inline int swizzle_bits(int bn) {
  return bn == 32 ? 3 : (bn == 16 ? 2 : 1);
}

// Bytes of dynamic shared memory for (d, bn, stages): the 1024-byte
// alignment slack, the ring, the reduction buffers, the mbarriers.
inline size_t smem_bytes(int d, int bn, int stages) {
  const int box_rows = d < kBoxRows ? d : kBoxRows;
  const int boxes = (d + box_rows - 1) / box_rows;
  return 1024 + (size_t)stages * boxes * box_stride_bytes(box_rows, bn) +
         sizeof(float) * (kWarps * kVals + kVals) + 8 * (size_t)stages;
}

// Columns [cb, cb + CB) of one staged row, 16-byte chunks swizzled by ``swz``.
template <int CB>
__device__ __forceinline__ void load_cols(const unsigned char* row, int cb,
                                          int swz, float (&out)[CB]) {
  if constexpr (CB >= 4) {
#pragma unroll
    for (int h = 0; h < CB / 4; ++h) {
      const float4 w = *reinterpret_cast<const float4*>(
          row + (((cb >> 2) + h) ^ swz) * 16);
      out[4 * h] = w.x;
      out[4 * h + 1] = w.y;
      out[4 * h + 2] = w.z;
      out[4 * h + 3] = w.w;
    }
  } else if constexpr (CB == 2) {
    const float2 w = *reinterpret_cast<const float2*>(
        row + ((cb >> 2) ^ swz) * 16 + (cb & 3) * 4);
    out[0] = w.x;
    out[1] = w.y;
  } else {
    out[0] = *reinterpret_cast<const float*>(row + ((cb >> 2) ^ swz) * 16 +
                                             (cb & 3) * 4);
  }
}

// Item ``it``'s node, the node's columns below ceil(n_true) (``ncols``) and
// the end of the item's tiles clipped to them.
__device__ __forceinline__ int item_tiles(const GramArgs& a, int it,
                                          int* node, int* ncols) {
  *node = a.items[6 * it];
  const float nt = ceilf(a.n_true[*node]);
  *ncols = nt <= 0.f ? 0 : (nt >= (float)a.n ? a.n : (int)nt);
  const int t_end = (*ncols + a.bn - 1) / a.bn;
  const int e = a.items[6 * it + 2];
  return e < t_end ? e : t_end;
}

// The tiles of one block, in order: item by item, each item's tiles clipped
// to its node's columns (items left with none are skipped).
struct TileWalk {
  int item, end, tile, tile_end, node;

  __device__ void settle(const GramArgs& a) {
    int ncols;
    while (item < end) {
      tile_end = item_tiles(a, item, &node, &ncols);
      if (tile < tile_end) return;
      ++item;
      if (item < end) tile = a.items[6 * item + 1];
    }
  }

  __device__ void start(const GramArgs& a, int first, int last) {
    item = first;
    end = last;
    tile = first < last ? a.items[6 * first + 1] : 0;
    settle(a);
  }

  __device__ bool valid() const { return item < end; }

  __device__ void next(const GramArgs& a) {
    tile += a.items[6 * item + 3];
    if (tile >= tile_end) {
      ++item;
      if (item < end) tile = a.items[6 * item + 1];
      settle(a);
    }
  }
};

// Put the tile (node, tile) of X into ring stage ``s``.
__device__ __forceinline__ void load_tile(const GramArgs& a,
                                          const CUtensorMap* map,
                                          uint32_t stage, uint32_t bar,
                                          int node, int tile, int tid) {
  const int boxes = (a.d + a.box_rows - 1) / a.box_rows;
  const uint32_t stride = box_stride_bytes(a.box_rows, a.bn);
  const int c0 = tile * a.bn;
  if (a.tma) {
    if (tid == 0) {
      hopper::mbar_expect_tx(bar, (uint32_t)boxes * a.box_rows * a.bn * 4);
      for (int b = 0; b < boxes; ++b)
        hopper::tma_load_3d(stage + b * stride, map, bar, c0,
                            b * a.box_rows, node);
    }
    return;
  }
  // cp.async: element (k, c) of the tile to the place TMA would put it
  const int sb = swizzle_bits(a.bn);
  const int lg = sb + 2;                          // log2(bn)
  const float* xn = a.x + (size_t)node * a.d * a.n;
  for (int idx = tid; idx < a.d * a.bn; idx += kThreads) {
    const int k = idx >> lg, c = idx & (a.bn - 1);
    const int b = k / a.box_rows, rr = k - b * a.box_rows;
    const uint32_t dst = stage + b * stride + rr * a.bn * 4 +
                         hopper::swizzle_chunk(c >> 2, rr, sb) * 16 +
                         (c & 3) * 4;
    const bool valid = c0 + c < a.n;
    hopper::cp_async_4(dst, valid ? xn + (size_t)k * a.n + c0 + c : a.x,
                       valid);
  }
  hopper::cp_async_arrive(bar);
}

template <int RMAX, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
gram_apply_kernel(const __grid_constant__ CUtensorMap xmap, const GramArgs a) {
  constexpr int CB = kVals / RMAX;          // columns a batch
  extern __shared__ unsigned char smem_raw[];
  __shared__ int is_last;
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* basep = smem_raw + (base - raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d, r = a.r, bn = a.bn, stages = a.stages;
  const int boxes = (d + a.box_rows - 1) / a.box_rows;
  const uint32_t box_stride = box_stride_bytes(a.box_rows, bn);
  const uint32_t stage_bytes = boxes * box_stride;
  float* red = reinterpret_cast<float*>(basep + stages * stage_bytes);
  float* zs = red + kWarps * kVals;
  const uint32_t bar0 = hopper::smem_u32(zs + kVals);
  const int rowbytes = bn * 4;
  // a thread's row of every box is its own index: one swizzle for all
  const int swz = hopper::swizzle_chunk(0, tid, swizzle_bits(bn));

  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      hopper::mbar_init(bar0 + 8 * s, a.tma ? 1 : kThreads);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int first = a.block_items[blockIdx.x];
  const int last = a.block_items[blockIdx.x + 1];
  TileWalk prod;
  prod.start(a, first, last);
  int pseq = 0;
  for (; pseq < stages - 1 && prod.valid(); ++pseq, prod.next(a))
    load_tile(a, &xmap, base + pseq * stage_bytes, bar0 + 8 * pseq,
              prod.node, prod.tile, tid);

  int seq = 0;
  for (int it = first; it < last; ++it) {
    int node, ncols;
    const int t_end = item_tiles(a, it, &node, &ncols);

    float qr[ROWS][RMAX], vacc[ROWS][RMAX];
    const float* qn = a.q + (size_t)node * d * r;
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const int k = tid + m * kBoxRows;
#pragma unroll
      for (int j = 0; j < RMAX; ++j) {
        qr[m][j] = (k < d && j < r) ? __ldg(qn + (size_t)k * r + j) : 0.f;
        vacc[m][j] = 0.f;
      }
    }

    const int step = a.items[6 * it + 3];
    for (int tile = a.items[6 * it + 1]; tile < t_end; tile += step, ++seq) {
      const int s = seq % stages;
      hopper::mbar_wait(bar0 + 8 * s, (seq / stages) & 1);
      const unsigned char* st = basep + s * stage_bytes + tid * rowbytes;
      const int col0 = tile * bn;
      for (int cb = 0; cb < bn; cb += CB) {
        const int lim = ncols - col0 - cb;      // columns of the batch < ncols
        float xv[ROWS][CB];
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const int k = tid + m * kBoxRows;
          float w[CB];
#pragma unroll
          for (int c = 0; c < CB; ++c) w[c] = 0.f;
          if (k < d) load_cols<CB>(st + m * box_stride, cb, swz, w);
#pragma unroll
          for (int c = 0; c < CB; ++c) xv[m][c] = (k < d && c < lim) ? w[c] : 0.f;
        }
        // this thread's partial of z_c = x_c^T Q over its rows
        float p[kVals];
#pragma unroll
        for (int c = 0; c < CB; ++c)
#pragma unroll
          for (int j = 0; j < RMAX; ++j) {
            float t = xv[0][c] * qr[0][j];
#pragma unroll
            for (int m = 1; m < ROWS; ++m) t = fmaf(xv[m][c], qr[m][j], t);
            p[c * RMAX + j] = t;
          }
        // reduce-scatter over the warp, bit 4 of the lane first: lane l
        // ends with values 2 l and 2 l + 1, summed over all 32 lanes
        hopper::halve<32>(p, lane, 16);
        hopper::halve<16>(p, lane, 8);
        hopper::halve<8>(p, lane, 4);
        hopper::halve<4>(p, lane, 2);
        hopper::halve<2>(p, lane, 1);
        const int idx = 2 * lane;
        red[warp * kVals + idx] = p[0];
        red[warp * kVals + idx + 1] = p[1];
        __syncthreads();
        // tile seq - 1 is consumed by all: its stage takes the next tile
        if (cb == 0 && prod.valid()) {
          const int ps = pseq % stages;
          load_tile(a, &xmap, base + ps * stage_bytes, bar0 + 8 * ps,
                    prod.node, prod.tile, tid);
          ++pseq;
          prod.next(a);
        }
        if (tid < kVals) {
          float z = red[tid];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) z += red[w * kVals + tid];
          zs[tid] = z;
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          float zc[RMAX];
#pragma unroll
          for (int j4 = 0; j4 < RMAX / 4; ++j4) {
            const float4 w =
                reinterpret_cast<const float4*>(zs + c * RMAX)[j4];
            zc[4 * j4] = w.x;
            zc[4 * j4 + 1] = w.y;
            zc[4 * j4 + 2] = w.z;
            zc[4 * j4 + 3] = w.w;
          }
#pragma unroll
          for (int m = 0; m < ROWS; ++m)
#pragma unroll
            for (int j = 0; j < RMAX; ++j)
              vacc[m][j] = fmaf(xv[m][c], zc[j], vacc[m][j]);
        }
      }
    }

    const float div = a.n_true[node];
    float* vn = a.v + (size_t)node * d * r;
    const int slot = a.items[6 * it + 4];
    // the node's sole item writes V; any other its partial, to be summed
    // in order by the last blocks (hopper::fold_partials)
    float* out = slot < 0 ? vn : a.partial + (size_t)slot * d * r;
    const float scale = slot < 0 ? div : 1.f;
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const int k = tid + m * kBoxRows;
      if (k < d) {
#pragma unroll
        for (int j = 0; j < RMAX; ++j)
          if (j < r) out[(size_t)k * r + j] = vacc[m][j] / scale;
      }
    }
    if (slot >= 0)
      hopper::fold_partials(a.items, a.groups, a.node_groups, a.tickets,
                            a.n_groups, a.partial, (size_t)d * r, d * r, vn,
                            div, it, &is_last);
  }
}

template <int RMAX, int ROWS>
cudaError_t launch(const CUtensorMap& map, const GramArgs& a, int grid,
                   size_t smem, cudaStream_t stream) {
  auto kernel = gram_apply_kernel<RMAX, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(map, a);
  return cudaGetLastError();
}

template <int RMAX, int ROWS>
cudaError_t launch_fits(const CUtensorMap& map, const GramArgs& a, int grid,
                        size_t smem, cudaStream_t stream) {
  if constexpr (ROWS * RMAX <= kMaxRowVals)
    return launch<RMAX, ROWS>(map, a, grid, smem, stream);
  return cudaErrorInvalidValue;
}

template <int RMAX>
cudaError_t launch_rows(int rows, const CUtensorMap& map, const GramArgs& a,
                        int grid, size_t smem, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_fits<RMAX, 1>(map, a, grid, smem, stream);
    case 2: return launch_fits<RMAX, 2>(map, a, grid, smem, stream);
    case 4: return launch_fits<RMAX, 4>(map, a, grid, smem, stream);
    case 8: return launch_fits<RMAX, 8>(map, a, grid, smem, stream);
    case 16: return launch_fits<RMAX, 16>(map, a, grid, smem, stream);
  }
  return cudaErrorInvalidValue;
}

// -- the packed route -------------------------------------------------------
constexpr int kPackedAlign = 128;     // a stage's alignment in shared memory
constexpr int kPackedMaxStages = 8;
constexpr int kPackedMaxN = 32;       // columns of z' a lane holds (NCOL)
constexpr int kPackedWarps = 8;       // a packed block's consumer warps
constexpr int kPackedGroups = 2;      // groups of them, each on its own nodes
constexpr int kGroupWarps = kPackedWarps / kPackedGroups;
constexpr int kPackedThreads = 32 * (kPackedWarps + 1);   // + the producer

// A stage of the packed ring: X_i (d x n), then Q_i (d x r), 128-byte aligned.
__host__ __device__ inline size_t packed_stage_bytes(int d, int n, int r) {
  return (4 * (size_t)d * (n + r) + kPackedAlign - 1) &
         ~(size_t)(kPackedAlign - 1);
}

// Dynamic shared memory of a packed block: alignment slack, the ring, the
// consumer warps' sums of z in two slots a group (by the parity of the
// group's nodes), a full and an empty mbarrier a stage.
inline size_t packed_smem_bytes(int d, int n, int r, int stages) {
  return kPackedAlign + stages * packed_stage_bytes(d, n, r) +
         2 * 4 * (size_t)kPackedWarps * n * r + 16 * (size_t)stages;
}

struct PackedArgs {
  const float* x;                   // (nodes, d, n)
  const float* q;                   // (nodes, d, r)
  const float* n_true;              // (nodes,)
  float* v;                         // (nodes, d, r) output
  const int* starts;                // (grid + 1,): a block's first node
  int d, n, r, U, stages;           // U: lanes a row (a power of two <= 32)
};

// x[k, cu VEC : cu VEC + VEC] from a staged row, columns at or past ``ncols``
// read as 0 (a select: NaN in the padding does not leak).
template <int VEC>
__device__ __forceinline__ void packed_row(const float* row, int cu, int ncols,
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
#pragma unroll
  for (int e = 0; e < VEC; ++e) xv[e] = cu * VEC + e < ncols ? xv[e] : 0.f;
}

// A consumer group's own barrier (named 1 + group; the producer warp and
// the other group are not in it).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "n"(kGroupWarps * 32)
               : "memory");
}

template <int R, bool EXACT, int VEC, int NCOL>
__global__ void __launch_bounds__(kPackedThreads, 1)
gram_apply_packed_kernel(const PackedArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base =
      (raw + kPackedAlign - 1) & ~(uint32_t)(kPackedAlign - 1);
  unsigned char* basep = smem_raw + (base - raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d, n = a.n, r = a.r, stages = a.stages, U = a.U;
  const uint32_t stage_bytes = (uint32_t)packed_stage_bytes(d, n, r);
  const int slot_floats = kGroupWarps * n * r;
  float* red0 = reinterpret_cast<float*>(basep + stages * stage_bytes);
  const uint32_t full0 =
      base + stages * stage_bytes + 8u * kPackedWarps * n * r;
  const uint32_t empty0 = full0 + 8 * stages;
  const uint32_t x_bytes = 4u * d * n, q_bytes = 4u * d * r;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, kGroupWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int first = a.starts[blockIdx.x], count =
      a.starts[blockIdx.x + 1] - first;
  if (warp == kPackedWarps) {
    // the producer: node seq into stage seq % stages once the consumers
    // are done with the node before it there
    if (lane == 0) {
      for (int seq = 0; seq < count; ++seq) {
        const int s = seq % stages;
        if (seq >= stages)
          hopper::mbar_wait(empty0 + 8 * s, (seq / stages - 1) & 1);
        const size_t node = first + seq;
        const uint32_t dst = base + s * stage_bytes, bar = full0 + 8 * s;
        hopper::mbar_expect_tx(bar, x_bytes + q_bytes);
        hopper::bulk_load(dst, a.x + node * d * n, x_bytes, bar);
        hopper::bulk_load(dst + x_bytes, a.q + node * d * r, q_bytes, bar);
      }
    }
    return;
  }

  // group g takes the range's nodes g, g + kPackedGroups, ...
  const int group = warp / kGroupWarps, gwarp = warp % kGroupWarps;
  const int gtid = tid - group * kGroupWarps * 32;
  const int units = (n + VEC - 1) / VEC, P = 32 / U;
  const int p = lane / U, u = lane & (U - 1);
  const bool unit_ok = u < units;
  const int k_lo = gwarp * d / kGroupWarps;
  const int k_hi = (gwarp + 1) * d / kGroupWarps;
  // columns of V a pass: their rows of z' (NCOL x JB) in registers
  constexpr int JB = R * NCOL <= 128 ? R : 128 / NCOL;
  // V's chunk order: a row's chunks (float4s, or single columns) are read
  // from chunk ``rot`` on, rot spreading the 8 lanes of a quarter warp over
  // the banks
  const int nch = VEC == 4 ? n / 4 : n;
  const int rot = VEC == 4 && (nch & (nch - 1)) == 0
                      ? (lane * nch / 8) % nch : 0;

  // n_true a node ahead: its load is in flight while a node is computed
  float div_next = count > group ? __ldg(a.n_true + first + group) : 0.f;
  for (int seq = group; seq < count; seq += kPackedGroups) {
    const int s = seq % stages, node = first + seq;
    const float div = div_next;
    if (seq + kPackedGroups < count)
      div_next = __ldg(a.n_true + node + kPackedGroups);
    const float nt = ceilf(div);
    const int ncols = nt <= 0.f ? 0 : (nt >= (float)n ? n : (int)nt);
    float* red =
        red0 + (2 * group + ((seq / kPackedGroups) & 1)) * slot_floats;
    hopper::mbar_wait(full0 + 8 * s, (seq / stages) & 1);
    const float* xs = reinterpret_cast<const float*>(basep + s * stage_bytes);
    const float* qs = xs + (size_t)d * n;

    // z = X^T Q: this lane's unit over its row phase of the warp's rows
    float acc[VEC][R];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[e][j] = 0.f;
    if (unit_ok) {
#pragma unroll 4
      for (int k = k_lo + p; k < k_hi; k += P) {
        float xv[VEC];
        packed_row<VEC>(xs + (size_t)k * n, u, ncols, xv);
        const float* qrow = qs + (size_t)k * r;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (EXACT || j < r) {
            const float qv = qrow[j];
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[e][j] = fmaf(xv[e], qv, acc[e][j]);
          }
        }
      }
    }
    // the row phases, added in one fixed order (every lane of a unit ends
    // with the same sums); the phases share the stores of the warp's sums
    for (int off = U; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int j = 0; j < R; ++j)
          acc[e][j] += __shfl_xor_sync(0xffffffffu, acc[e][j], off);
    }
    if (unit_ok) {
      float* rw = red + (size_t)gwarp * n * r;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int j = 0; j < R; ++j)
          if ((EXACT || j < r) && u * VEC + e < n && (e * R + j) % P == p)
            rw[(u * VEC + e) * r + j] = acc[e][j];
    }
    group_sync(group);
    // the group's warps' sums, in warp order, divided by n_true: z' into
    // its warp 0's part of the slot
    for (int i = gtid; i < n * r; i += kGroupWarps * 32) {
      float z = red[i];
#pragma unroll
      for (int w = 1; w < kGroupWarps; ++w) z += red[w * n * r + i];
      red[i] = z / div;
    }
    group_sync(group);

    // V = X z': a thread a row (rows gtid, gtid + 128, ...), JB columns of V
    // a pass with their rows of z' in registers, in the lane's chunk order;
    // the loads carry no branch (chunks past n, and columns at or past
    // ncols, read as 0). Consecutive rows go to consecutive lanes.
    float* vn = a.v + (size_t)node * d * r;
    for (int jb = 0; jb < r; jb += JB) {
      float zr[NCOL][JB];
      int ch = rot;
#pragma unroll
      for (int cc = 0; cc < NCOL / VEC; ++cc) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
#pragma unroll
          for (int j = 0; j < JB; ++j)
            zr[VEC * cc + e][j] = cc < nch && jb + j < r
                                      ? red[(VEC * ch + e) * r + jb + j]
                                      : 0.f;
        ch = ch + 1 == nch ? 0 : ch + 1;
      }
      for (int k = gtid; k < d; k += kGroupWarps * 32) {
        const float* xr = xs + (size_t)k * n;
        float acc2[JB];
#pragma unroll
        for (int j = 0; j < JB; ++j) acc2[j] = 0.f;
        ch = rot;
#pragma unroll
        for (int cc = 0; cc < NCOL / VEC; ++cc) {
          float xv[VEC];
          if constexpr (VEC == 4) {
            const float4 w = cc < nch
                ? *reinterpret_cast<const float4*>(xr + 4 * ch)
                : make_float4(0.f, 0.f, 0.f, 0.f);
            xv[0] = w.x;
            xv[1] = w.y;
            xv[2] = w.z;
            xv[3] = w.w;
          } else {
            xv[0] = cc < nch ? xr[ch] : 0.f;
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float x = VEC * ch + e < ncols ? xv[e] : 0.f;
#pragma unroll
            for (int j = 0; j < JB; ++j)
              acc2[j] = fmaf(x, zr[VEC * cc + e][j], acc2[j]);
          }
          ch = ch + 1 == nch ? 0 : ch + 1;
        }
#pragma unroll
        for (int j = 0; j < JB; ++j)
          if (jb + j < r) vn[(size_t)k * r + jb + j] = acc2[j];
      }
    }
    // this warp is done with stage s: the producer may refill it
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty0 + 8 * s);
  }
}

template <int R, bool EXACT, int VEC>
cudaError_t launch_packed(const PackedArgs& a, int grid, size_t smem,
                          cudaStream_t stream) {
  auto kernel = a.n <= 16 ? gram_apply_packed_kernel<R, EXACT, VEC, 16>
                          : gram_apply_packed_kernel<R, EXACT, VEC, 32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kPackedThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// float4 units: r exact up to 8, else 16 columns
cudaError_t launch_packed_vec4(const PackedArgs& a, int grid, size_t smem,
                               cudaStream_t s) {
  switch (a.r) {
    case 1: return launch_packed<1, true, 4>(a, grid, smem, s);
    case 2: return launch_packed<2, true, 4>(a, grid, smem, s);
    case 3: return launch_packed<3, true, 4>(a, grid, smem, s);
    case 4: return launch_packed<4, true, 4>(a, grid, smem, s);
    case 5: return launch_packed<5, true, 4>(a, grid, smem, s);
    case 6: return launch_packed<6, true, 4>(a, grid, smem, s);
    case 7: return launch_packed<7, true, 4>(a, grid, smem, s);
    case 8: return launch_packed<8, true, 4>(a, grid, smem, s);
    default: return launch_packed<16, false, 4>(a, grid, smem, s);
  }
}

// one column a unit: any r up to 64
cudaError_t launch_packed_vec1(const PackedArgs& a, int grid, size_t smem,
                               cudaStream_t s) {
  if (a.r <= 8) return launch_packed<8, false, 1>(a, grid, smem, s);
  if (a.r <= 16) return launch_packed<16, false, 1>(a, grid, smem, s);
  if (a.r <= 32) return launch_packed<32, false, 1>(a, grid, smem, s);
  return launch_packed<64, false, 1>(a, grid, smem, s);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the kernel needs for (d, bn, stages).
size_t gram_apply_smem_bytes(int d, int bn, int stages) {
  return smem_bytes(d, bn, stages);
}

// x: (nodes, d, n), q: (nodes, d, r), n_true: (nodes,), all f32; partial:
// (slots, d, r) f32 scratch; v: (nodes, d, r) f32 output; tickets: (groups +
// nodes,) int32, zero; items / block_items / groups / node_groups: the
// wrapper's plan. rmax and rows pick the instantiation (r <= rmax, d <= 256
// x rows, rows x rmax <= 128). tma = 1 takes X through a tensor map (n % 4
// == 0, x 16-byte aligned), else cp.async. Returns the CUDA error code of
// the launch (0 on success).
int gram_apply_launch(const float* x, const float* q, const float* n_true,
                      float* partial, float* v, int* tickets, const int* items,
                      const int* block_items, const int* groups,
                      const int* node_groups, int nodes, int d, int n, int r,
                      int rmax, int rows, int bn, int stages, int grid,
                      int smem, int tma, int n_groups, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((bn != 8 && bn != 16 && bn != 32) || stages < 2 ||
      stages > kMaxStages || r > rmax || d > rows * kBoxRows ||
      rows * rmax > kMaxRowVals ||
      (size_t)smem < smem_bytes(d, bn, stages))
    return (int)cudaErrorInvalidValue;
  const int box_rows = d < kBoxRows ? d : kBoxRows;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    const CUtensorMapSwizzle swz =
        bn == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (bn == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B);
    if (!hopper::f32_map_3d(&map, x, (uint64_t)n, (uint64_t)d,
                            (uint64_t)nodes, (uint32_t)bn,
                            (uint32_t)box_rows, swz))
      return (int)cudaErrorNotSupported;
  }
  const GramArgs a{x, q, n_true, partial, v, tickets, items, block_items,
                   groups, node_groups, d, n, r, bn, stages, box_rows, tma,
                   n_groups};
  cudaError_t err;
  switch (rmax) {
    case 8: err = launch_rows<8>(rows, map, a, grid, smem, stream); break;
    case 16: err = launch_rows<16>(rows, map, a, grid, smem, stream); break;
    case 32: err = launch_rows<32>(rows, map, a, grid, smem, stream); break;
    case 64: err = launch_rows<64>(rows, map, a, grid, smem, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// Bytes of dynamic shared memory a packed block needs for (d, n, r, stages).
size_t gram_packed_smem_bytes(int d, int n, int r, int stages) {
  return packed_smem_bytes(d, n, r, stages);
}

// The packed route, one launch: V[i] = X_i (X_i^T Q_i) / n_true[i], a node
// whole in a ring stage. x: (nodes, d, n), q: (nodes, d, r), n_true:
// (nodes,), v: (nodes, d, r), all f32, x and q 16-byte aligned with d n and
// d r multiples of 4 (bulk copies); starts: (grid + 1,) int32, block g's
// nodes; U lanes a row (the units' power of two, at most 32), ``stages``
// ring stages, units of vec = 4 (n % 4 == 0, r <= 16) or 1 columns. Returns
// the CUDA error code of the launch (0 on success).
int gram_packed_launch(const float* x, const float* q, const float* n_true,
                       float* v, const int* starts, int nodes, int d, int n,
                       int r, int U, int stages, int grid, int smem, int vec,
                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int units = vec == 4 ? n / 4 : n;
  int lanes = 1;                        // the units' power of two
  while (lanes < units) lanes <<= 1;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  if (r < 1 || r > 64 || d < 1 || n < 1 || n > kPackedMaxN || nodes < 1 ||
      grid < 1 ||
      grid > nodes || stages < 2 || stages > kPackedMaxStages ||
      (vec != 1 && vec != 4) || (vec == 4 && (n % 4 || r > 16)) ||
      lanes > 32 || U != lanes || !aligned || (d * n) % 4 || (d * r) % 4 ||
      (size_t)smem < packed_smem_bytes(d, n, r, stages))
    return (int)cudaErrorInvalidValue;
  const PackedArgs a{x, q, n_true, v, starts, d, n, r, U, stages};
  return (int)(vec == 4 ? launch_packed_vec4(a, grid, smem, stream)
                        : launch_packed_vec1(a, grid, smem, stream));
}

}  // extern "C"
