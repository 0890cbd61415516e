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
// What the design does about it:
//  * X is read from device memory ONCE. A block owns (node i, a range of
//    columns). For each tile of BN columns it stages the d x BN tile of X in
//    shared memory, computes S = X_b^T Q (BN x r, a reduction over d) from
//    the staged tile, then accumulates V += X_b S (d x r) from the same
//    staged tile. Q_i is staged in shared memory once per block: read
//    through the cache it missed L1 (which shares the SM's 256 KB with the
//    tiles) and paid an L2 round trip per FMA.
//  * The TPU kernel carries V across a sequential grid over column blocks.
//    Hopper blocks run in parallel and in no order, so the column axis is
//    split into `splits` ranges: pass 1 writes one (d x r) partial per
//    (node, range), and pass 2 sums the partials in a fixed order and divides
//    by n_true. No atomics: repeated runs give the same bits.
//  * The tile is staged with cp.async, so all of its loads are in flight at
//    once; two blocks fit on an SM at the paper's shapes, so one block's
//    loads overlap the other's arithmetic. The wrapper sizes the column
//    split from the card's occupancy so that all blocks run in one wave.
//  * In V += X_b S each thread updates several rows per read of S from
//    shared memory (4 rows for r <= 8).
//  * Columns past ceil(n_true[i]) are padding: they are not read. The ragged
//    last tile of a range is zero-filled in shared memory.
//  * f32 FMAs on CUDA cores, no TF32 (the reference is float32 throughout).
//    wgmma/TMA and a double-buffered pipeline over tiles are later work.
//
// Shared memory: X tile d*(BN+1) floats (odd row stride: conflict-free for
// both the column reduction and the row sweep), Q_i d*r floats, the V
// partial r*d floats, S BN*r floats and a reduction buffer of kThreads
// floats. The wrapper picks BN so that two blocks fit on an SM where it can.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// 4-byte global -> shared copy that does not wait for the data; with
// valid = false it writes 0 and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ x, const float* __restrict__ q,
                    const float* __restrict__ n_true, float* __restrict__ partial,
                    int d, int n, int r, int bn, int cols_per_split, int splits) {
  // rows per thread that share one read of S in the V update
  constexpr int ROWS = RMAX <= 8 ? 4 : (RMAX <= 16 ? 2 : 1);
  extern __shared__ float smem[];
  const int xs_stride = bn + 1;
  float* xs = smem;                        // d * (bn + 1)
  float* qs = xs + d * xs_stride;          // d * r   (Q_i, row-major)
  float* vs = qs + d * r;                  // r * d   (vs[j * d + k])
  float* ss = vs + r * d;                  // bn * r  (ss[c * r + j])
  float* red = ss + bn * r;                // kThreads

  const int node = blockIdx.y;
  const int split = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xi = x + (size_t)node * d * n;
  const float* qi = q + (size_t)node * d * r;

  int ncols = (int)ceilf(n_true[node]);
  ncols = ncols < n ? ncols : n;
  const int c_begin = split * cols_per_split;
  int c_end = c_begin + cols_per_split;
  c_end = c_end < ncols ? c_end : ncols;

  for (int idx = tid; idx < r * d; idx += kThreads) {
    vs[idx] = 0.f;
    cp_async_f32(qs + idx, qi + idx, true);
  }
  cp_async_wait_all();

  const int out = bn * r;                  // S outputs per tile
  const int ksplit = out <= kThreads ? kThreads / out : 1;

  // this thread's column of every tile, and its rows: bn divides kThreads
  const int lc = tid % bn, lk0 = tid / bn, lkstep = kThreads / bn;

  for (int c0 = c_begin; c0 < c_end; c0 += bn) {
    __syncthreads();                       // previous tile fully consumed
    // Stage the tile with cp.async: every load of the tile is in flight at
    // once, instead of one round trip to device memory per element.
    const bool valid = c0 + lc < c_end;
    for (int k = lk0; k < d; k += lkstep) {
      const float* row = xi + (size_t)k * n;
      cp_async_f32(xs + k * xs_stride + lc, valid ? row + c0 + lc : row, valid);
    }
    cp_async_wait_all();
    __syncthreads();

    // S = X_b^T Q: output o = j * bn + c, `ksplit` threads per output, each
    // over a strided slice of k; the slices are summed in a fixed order.
    if (out <= kThreads) {
      const int o = tid % out, ks = tid / out;
      float s = 0.f;
      if (ks < ksplit) {
        const int c = o % bn, j = o / bn;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int k = ks;
        const int step = ksplit;
        for (; k + 3 * step < d; k += 4 * step) {
          a0 = fmaf(xs[k * xs_stride + c], qs[k * r + j], a0);
          a1 = fmaf(xs[(k + step) * xs_stride + c],
                    qs[(k + step) * r + j], a1);
          a2 = fmaf(xs[(k + 2 * step) * xs_stride + c],
                    qs[(k + 2 * step) * r + j], a2);
          a3 = fmaf(xs[(k + 3 * step) * xs_stride + c],
                    qs[(k + 3 * step) * r + j], a3);
        }
        for (; k < d; k += step)
          a0 = fmaf(xs[k * xs_stride + c], qs[k * r + j], a0);
        s = (a0 + a1) + (a2 + a3);
      }
      red[tid] = s;
      __syncthreads();
      if (tid < out) {
        float t = 0.f;
        for (int p = 0; p < ksplit; ++p) t += red[p * out + tid];
        const int c = tid % bn, j = tid / bn;
        ss[c * r + j] = t;
      }
    } else {
      for (int o = tid; o < out; o += kThreads) {
        const int c = o % bn, j = o / bn;
        float a = 0.f;
        for (int k = 0; k < d; ++k)
          a = fmaf(xs[k * xs_stride + c], qs[k * r + j], a);
        ss[c * r + j] = a;
      }
    }
    __syncthreads();

    // V += X_b S: each thread owns rows k = tid, tid + kThreads, ...; it
    // takes them ROWS at a time, so each S value read from shared memory
    // serves ROWS rows. The sum over c runs in order for every row.
    for (int k0 = tid; k0 < d; k0 += ROWS * kThreads) {
      float acc[ROWS][RMAX];
#pragma unroll
      for (int m = 0; m < ROWS; ++m)
#pragma unroll
        for (int j = 0; j < RMAX; ++j) acc[m][j] = 0.f;
      for (int c = 0; c < bn; ++c) {
        float sv[RMAX];
#pragma unroll
        for (int j = 0; j < RMAX; ++j) sv[j] = j < r ? ss[c * r + j] : 0.f;
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const int k = k0 + m * kThreads;
          const float xv = k < d ? xs[k * xs_stride + c] : 0.f;
#pragma unroll
          for (int j = 0; j < RMAX; ++j) acc[m][j] = fmaf(xv, sv[j], acc[m][j]);
        }
      }
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int k = k0 + m * kThreads;
        if (k < d) {
#pragma unroll
          for (int j = 0; j < RMAX; ++j)
            if (j < r) vs[j * d + k] += acc[m][j];
        }
      }
    }
  }
  __syncthreads();

  float* p = partial + ((size_t)node * splits + split) * d * r;
  for (int idx = tid; idx < d * r; idx += kThreads) {
    const int k = idx / r, j = idx - k * r;
    p[idx] = vs[j * d + k];
  }
}

// Pass 2: V[i] = (sum over splits of the partials, in order) / n_true[i].
__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ n_true,
                                   float* __restrict__ v, int nodes, int dr,
                                   int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)nodes * dr) return;
  const int node = (int)(idx / dr);
  const int e = (int)(idx - (size_t)node * dr);
  const float* p = partial + (size_t)node * splits * dr + e;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += p[(size_t)sp * dr];
  v[idx] = s / n_true[node];
}

template <int RMAX>
cudaError_t launch_partial(dim3 grid, size_t smem, cudaStream_t stream,
                           const float* x, const float* q, const float* n_true,
                           float* partial, int d, int n, int r, int bn,
                           int cols_per_split, int splits) {
  cudaError_t err = cudaFuncSetAttribute(
      gram_partial_kernel<RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gram_partial_kernel<RMAX><<<grid, kThreads, smem, stream>>>(
      x, q, n_true, partial, d, n, r, bn, cols_per_split, splits);
  return cudaGetLastError();
}

template <int RMAX>
int blocks_per_sm(size_t smem) {
  if (cudaFuncSetAttribute(gram_partial_kernel<RMAX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, gram_partial_kernel<RMAX>, kThreads, smem) != cudaSuccess)
    return 0;
  return blocks;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory pass 1 needs for (d, r, bn).
size_t gram_apply_smem_bytes(int d, int r, int bn) {
  return sizeof(float) * ((size_t)d * (bn + 1) + 2 * (size_t)r * d +
                          (size_t)bn * r + kThreads);
}

// Blocks of pass 1 that fit on one SM at once for (d, r, bn); 0 on error.
int gram_apply_blocks_per_sm(int d, int r, int bn) {
  const size_t smem = gram_apply_smem_bytes(d, r, bn);
  if (r <= 8) return blocks_per_sm<8>(smem);
  if (r <= 16) return blocks_per_sm<16>(smem);
  if (r <= 32) return blocks_per_sm<32>(smem);
  if (r <= 64) return blocks_per_sm<64>(smem);
  return 0;
}

// x: (nodes, d, n) f32, q: (nodes, d, r) f32, n_true: (nodes,) f32,
// partial: (nodes, splits, d, r) f32 scratch, v: (nodes, d, r) f32 output.
// Returns the CUDA error code of the launches (0 on success).
int gram_apply_launch(const float* x, const float* q, const float* n_true,
                      float* partial, float* v, int nodes, int d, int n, int r,
                      int bn, int cols_per_split, int splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = gram_apply_smem_bytes(d, r, bn);
  const dim3 grid(splits, nodes);
  cudaError_t err;
  if (r <= 8)
    err = launch_partial<8>(grid, smem, stream, x, q, n_true, partial, d, n, r,
                            bn, cols_per_split, splits);
  else if (r <= 16)
    err = launch_partial<16>(grid, smem, stream, x, q, n_true, partial, d, n, r,
                             bn, cols_per_split, splits);
  else if (r <= 32)
    err = launch_partial<32>(grid, smem, stream, x, q, n_true, partial, d, n, r,
                             bn, cols_per_split, splits);
  else if (r <= 64)
    err = launch_partial<64>(grid, smem, stream, x, q, n_true, partial, d, n, r,
                             bn, cols_per_split, splits);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)nodes * d * r;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  gram_reduce_kernel<<<blocks, threads, 0, stream>>>(partial, n_true, v, nodes,
                                                     d * r, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
