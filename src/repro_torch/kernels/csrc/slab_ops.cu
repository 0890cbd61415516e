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
// apply (V = X S, output (d, r) per block, a sum over the long sample axis):
//  * the TPU kernel carries V across a sequential grid over sample blocks;
//    Hopper blocks run in parallel. The sample axis is split into ranges:
//    pass 1 writes one (d, r) partial per (block, range), pass 2 sums the
//    partials in a fixed order. No atomics: repeated runs give the same
//    bits. The wrapper sizes the split from the card's occupancy.
//  * a warp owns ROWS rows of X and its lanes walk the range's columns, so
//    each load of a row is 32 consecutive floats (coalesced); the lane
//    keeps ROWS x r sums in registers (8 x 8 at r <= 8: ROWS loads in
//    flight a step) and each S value it reads from shared memory serves
//    ROWS rows. At the end of the range the lanes' sums are combined by a
//    butterfly of shuffles (fixed order).
//  * S is staged 256 columns at a time with an odd row stride, so lanes on
//    consecutive columns read distinct banks. Where a block has at most half
//    as many row groups as warps (a short d), the spare warps split the
//    columns with the others and their sums are added in a fixed order.
//  * a third grid axis splits tall blocks into chunks of 8 warps x ROWS
//    rows (F-DOT's 55 rows: 1 chunk; B-DOT's 256: 4).
//
// Ragged edges: a tile or range past n and rows past d are masked; any d,
// n >= 1 and 1 <= r <= 64 are taken. The zero padding of the reference's
// stacks is data like any other.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQChunkFloats = 8192;   // Q rows staged at once: 32 KB
constexpr int kApplyChunk = 256;      // columns of S staged at once
constexpr int kUnroll = 8;            // rows of X in flight per tq thread

template <int RMAX>
struct ApplyRows {
  // rows a warp accumulates at once: ROWS * RMAX sums in registers
  static constexpr int value = RMAX <= 8 ? 8 : (RMAX <= 16 ? 4 : (RMAX <= 32 ? 2 : 1));
};

inline int apply_rows(int r) {
  return r <= 8 ? 8 : (r <= 16 ? 4 : (r <= 32 ? 2 : 1));
}

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

inline size_t apply_smem_bytes(int r) {
  return sizeof(float) * ((size_t)kApplyChunk * (r | 1) +
                          (size_t)kWarps * apply_rows(r) * r);
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

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
slab_apply_partial_kernel(const float* __restrict__ x,
                          const float* __restrict__ s,
                          float* __restrict__ partial, int J, int d, int n,
                          int r, int cols_per_split, int splits) {
  constexpr int ROWS = ApplyRows<RMAX>::value;
  extern __shared__ float smem[];
  const int rp = r | 1;                    // odd stride: conflict-free lanes
  float* ss = smem;                        // kApplyChunk * rp
  float* red = ss + kApplyChunk * rp;      // kWarps * ROWS * r

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int groups = (d + ROWS - 1) / ROWS;
  const int g0 = blockIdx.y * kWarps;      // first row group of this block
  const int gb = groups - g0 < kWarps ? groups - g0 : kWarps;
  const int phases = kWarps / gb;          // warps that share a row group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp % gb, p = warp / gb;  // warp = p * gb + g
  const bool active = p < phases;
  const int k0 = (g0 + g) * ROWS;

  const float* xb = x + (size_t)b * d * n;
  const float* sb = s + (size_t)(b % J) * n * r;
  const int c_begin = split * cols_per_split;
  int c_end = c_begin + cols_per_split;
  c_end = c_end < n ? c_end : n;

  float acc[ROWS][RMAX];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int j = 0; j < RMAX; ++j) acc[m][j] = 0.f;

  for (int c0 = c_begin; c0 < c_end; c0 += kApplyChunk) {
    const int cols = c_end - c0 < kApplyChunk ? c_end - c0 : kApplyChunk;
    __syncthreads();                       // previous chunk fully consumed
    const float* sc = sb + (size_t)c0 * r; // cols * r contiguous floats
    for (int idx = threadIdx.x; idx < cols * r; idx += kThreads) {
      const int cc = idx / r, j = idx - cc * r;
      ss[cc * rp + j] = __ldg(sc + idx);
    }
    __syncthreads();
    if (active) {
      for (int cc = p * 32 + lane; cc < cols; cc += phases * 32) {
        float sv[RMAX];
#pragma unroll
        for (int j = 0; j < RMAX; ++j) sv[j] = j < r ? ss[cc * rp + j] : 0.f;
        float xv[ROWS];
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const int k = k0 + m;
          xv[m] = k < d ? __ldg(xb + (size_t)k * n + c0 + cc) : 0.f;
        }
#pragma unroll
        for (int m = 0; m < ROWS; ++m)
#pragma unroll
          for (int j = 0; j < RMAX; ++j) acc[m][j] = fmaf(xv[m], sv[j], acc[m][j]);
      }
    }
  }

  // lanes' sums -> one per (row, j): a butterfly, the same order every run
  if (active) {
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
#pragma unroll
      for (int j = 0; j < RMAX; ++j) {
        if (j < r) {
          float v = acc[m][j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) red[(warp * ROWS + m) * r + j] = v;
        }
      }
    }
  }
  __syncthreads();

  // phases of a row group summed in order; this block's rows of the partial
  float* pb = partial + ((size_t)b * splits + split) * d * r;
  for (int idx = threadIdx.x; idx < gb * ROWS * r; idx += kThreads) {
    const int gg = idx / (ROWS * r);
    const int rem = idx - gg * ROWS * r;
    const int m = rem / r, j = rem - m * r;
    const int k = (g0 + gg) * ROWS + m;
    if (k < d) {
      float t = 0.f;
      for (int ph = 0; ph < phases; ++ph) t += red[((ph * gb + gg) * ROWS + m) * r + j];
      pb[(size_t)k * r + j] = t;
    }
  }
}

// Pass 2: V[b] = sum over splits of the partials, in order.
__global__ void slab_apply_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ v, int blocks,
                                         int dr, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)blocks * dr) return;
  const int b = (int)(idx / dr);
  const int e = (int)(idx - (size_t)b * dr);
  const float* p = partial + (size_t)b * splits * dr + e;
  float t = 0.f;
  for (int sp = 0; sp < splits; ++sp) t += p[(size_t)sp * dr];
  v[idx] = t;
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

template <int RMAX>
cudaError_t launch_apply(const float* x, const float* s, float* partial,
                         int blocks, int J, int d, int n, int r,
                         int cols_per_split, int splits, cudaStream_t stream) {
  const size_t smem = apply_smem_bytes(r);
  cudaError_t err = set_smem(slab_apply_partial_kernel<RMAX>, smem);
  if (err != cudaSuccess) return err;
  const int groups = (d + ApplyRows<RMAX>::value - 1) / ApplyRows<RMAX>::value;
  const dim3 grid(splits, (groups + kWarps - 1) / kWarps, blocks);
  slab_apply_partial_kernel<RMAX><<<grid, kThreads, smem, stream>>>(
      x, s, partial, J, d, n, r, cols_per_split, splits);
  return cudaGetLastError();
}

template <int RMAX>
int apply_blocks_per_sm(size_t smem) {
  if (set_smem(slab_apply_partial_kernel<RMAX>, smem) != cudaSuccess) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, slab_apply_partial_kernel<RMAX>, kThreads, smem) != cudaSuccess)
    return 0;
  return per_sm;
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

// Grid rows (the y axis) of the apply kernel for (d, r).
int slab_apply_row_chunks(int d, int r) {
  const int groups = (d + apply_rows(r) - 1) / apply_rows(r);
  return (groups + kWarps - 1) / kWarps;
}

// Columns a range of the sample axis is a multiple of.
int slab_apply_chunk(void) { return kApplyChunk; }

// Blocks of pass 1 that fit on one SM at once for r; 0 on error.
int slab_apply_blocks_per_sm(int r) {
  const size_t smem = apply_smem_bytes(r);
  if (r <= 8) return apply_blocks_per_sm<8>(smem);
  if (r <= 16) return apply_blocks_per_sm<16>(smem);
  if (r <= 32) return apply_blocks_per_sm<32>(smem);
  if (r <= 64) return apply_blocks_per_sm<64>(smem);
  return 0;
}

// V[b] = X_b S[b % J]. x: (blocks, d, n), s: (J, n, r), partial:
// (blocks, splits, d, r) scratch, v: (blocks, d, r), all f32.
// Returns the CUDA error code of the launches (0 on success).
int slab_apply_launch(const float* x, const float* s, float* partial, float* v,
                      int blocks, int J, int d, int n, int r,
                      int cols_per_split, int splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (r <= 8)
    err = launch_apply<8>(x, s, partial, blocks, J, d, n, r, cols_per_split,
                          splits, stream);
  else if (r <= 16)
    err = launch_apply<16>(x, s, partial, blocks, J, d, n, r, cols_per_split,
                           splits, stream);
  else if (r <= 32)
    err = launch_apply<32>(x, s, partial, blocks, J, d, n, r, cols_per_split,
                           splits, stream);
  else if (r <= 64)
    err = launch_apply<64>(x, s, partial, blocks, J, d, n, r, cols_per_split,
                           splits, stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)blocks * d * r;
  const int threads = 256;
  const unsigned grid = (unsigned)((total + threads - 1) / threads);
  slab_apply_reduce_kernel<<<grid, threads, 0, stream>>>(partial, v, blocks,
                                                         d * r, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
