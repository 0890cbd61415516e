// Hopper (sm_90a) tall-skinny Gram of CholeskyQR: G[b] = V_b^T V_b.
//
// Replaces: repro/kernels/gram_qr.py  gram_qr_pallas  (G = V^T V, the
// CholeskyQR matmul). One launch serves a batch of B matrices (d, r),
// row-major, f32 or bf16; G is (B, r, r) f32. B = 1 is the reference's
// kernel; the port's CholeskyQR2 sends every node's (or slab's) Gram of one
// pass through one launch.
//
// What bounds it on the H100: at the main path's r = 7 it reads d * r
// values and does d r (r + 1) flops of the symmetric product, r + 1 = 8
// flops per 4-byte value: bytes. At r = 128 it is 129 flops per value, 32
// per byte of f32: the 67 TFLOP/s of f32 FMA on the CUDA cores, which this
// kernel uses (no tensor cores: the reference is float32, and a TF32 or
// bf16 product would move the Gram).
//
// Design:
//  * G is symmetric, so only tile pairs (ti, tj) with ti <= tj of the T x T
//    output tiles are computed; each (i, j), i <= j, is summed once and
//    written to both G[i][j] and G[j][i]: G is exactly symmetric.
//  * A block owns one tile pair of one matrix and one range of rows. It
//    stages the two column panels of a chunk of rows in shared memory (as
//    f32: bf16 is widened on load) and each thread keeps an M x M micro-tile
//    of sums in registers. Where the tile has fewer outputs than the block
//    has threads (r <= 8), P groups of threads take every P-th row and their
//    sums are added in phase order at the end.
//  * The TPU kernel carries G across a sequential grid over row blocks;
//    Hopper blocks run in parallel and in no order. For a short d (the
//    wrapper's choice) one block walks all rows in order and writes G. For
//    a tall d the rows are split into fixed ranges: pass 1 writes one partial
//    Gram per range, pass 2 sums the partials in range order. No atomics:
//    every launch gives the same bits, which the bitwise resume of a
//    checkpointed run relies on.
//  * Ragged edges: rows past a range or d, and columns past r, are masked;
//    any d >= 1 and r >= 1 are taken (no padding of d, unlike ops.py's
//    TPU path).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPanelFloats = 2048;   // one staged column panel: 8 KB

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// M: the side of a thread's micro-tile for output tiles of side T.
template <int T> struct Micro;
template <> struct Micro<8> { static constexpr int M = 1; };
template <> struct Micro<16> { static constexpr int M = 1; };
template <> struct Micro<32> { static constexpr int M = 2; };
template <> struct Micro<64> { static constexpr int M = 4; };

inline int tile_side(int r) {
  return r <= 8 ? 8 : (r <= 16 ? 16 : (r <= 32 ? 32 : 64));
}

inline int tile_pairs(int r) {
  const int t = tile_side(r);
  const int nt = (r + t - 1) / t;
  return nt * (nt + 1) / 2;
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

// out = G (splits == 1, both triangles) or the partials (splits > 1,
// (B, splits, r, r), upper triangle only).
template <typename In, int T>
__global__ void __launch_bounds__(kThreads)
gram_qr_kernel(const In* __restrict__ v, float* __restrict__ out, int d, int r,
               int rows_per_split, int splits) {
  constexpr int M = Micro<T>::M;
  constexpr int TT = T / M;                 // threads along a tile side
  constexpr int P = kThreads / (TT * TT);   // row phases
  constexpr int KC = kPanelFloats / T;      // rows staged at once
  __shared__ float as[KC][T];
  __shared__ float bs[KC][T];
  __shared__ float red[P > 1 ? P * T * T : 1];

  const int split = blockIdx.x, b = blockIdx.z;
  const int nt = (r + T - 1) / T;
  int ti, tj;
  tile_pair(blockIdx.y, nt, ti, tj);
  const int e = threadIdx.x % (TT * TT), p = threadIdx.x / (TT * TT);
  const int ta = e / TT, tb = e % TT;
  const In* vb = v + (size_t)b * d * r;
  const int k_begin = split * rows_per_split;
  const int k_end = min(d, k_begin + rows_per_split);

  float acc[M][M];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < M; ++n) acc[m][n] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += KC) {
    const int rows = min(KC, k_end - k0);
    __syncthreads();                       // previous chunk fully consumed
    for (int idx = threadIdx.x; idx < rows * T; idx += kThreads) {
      const int k = idx / T, c = idx - k * T;
      const In* row = vb + (size_t)(k0 + k) * r;
      const int ci = ti * T + c, cj = tj * T + c;
      as[k][c] = ci < r ? to_f32(row[ci]) : 0.f;
      bs[k][c] = cj < r ? to_f32(row[cj]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = p; k < rows; k += P) {
      float a[M], bv[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        a[m] = as[k][ta * M + m];
        bv[m] = bs[k][tb * M + m];
      }
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < M; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
    }
  }

  if constexpr (P > 1) {                   // M == 1 here
    red[(p * T + ta) * T + tb] = acc[0][0];
    __syncthreads();
    if (p == 0) {
      float t = red[ta * T + tb];
      for (int q = 1; q < P; ++q) t += red[(q * T + ta) * T + tb];
      acc[0][0] = t;
    }
  }
  if (p != 0) return;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int n = 0; n < M; ++n) {
      const int i = ti * T + ta * M + m, j = tj * T + tb * M + n;
      if (i < r && j < r && i <= j) {
        if (splits == 1) {
          float* g = out + (size_t)b * r * r;
          g[(size_t)i * r + j] = acc[m][n];
          g[(size_t)j * r + i] = acc[m][n];
        } else {
          out[(((size_t)b * splits + split) * r + i) * r + j] = acc[m][n];
        }
      }
    }
  }
}

// Pass 2: G[b][i][j] = sum over ranges of the partial at (min, max), in
// range order, so G[b][i][j] and G[b][j][i] are the same sum.
__global__ void gram_qr_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ g, int batch, int r,
                                      int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t rr = (size_t)r * r;
  if (idx >= (size_t)batch * rr) return;
  const size_t b = idx / rr;
  const int e = (int)(idx - b * rr);
  const int i = e / r, j = e - i * r;
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  const float* pp = partial + b * splits * rr + (size_t)lo * r + hi;
  float t = 0.f;
  for (int s = 0; s < splits; ++s) t += pp[(size_t)s * rr];
  g[idx] = t;
}

template <typename In, int T>
cudaError_t launch(const In* v, float* partial, float* g, int batch, int d,
                   int r, int rows_per_split, int splits,
                   cudaStream_t stream) {
  const dim3 grid(splits, tile_pairs(r), batch);
  gram_qr_kernel<In, T><<<grid, kThreads, 0, stream>>>(
      v, splits == 1 ? g : partial, d, r, rows_per_split, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)batch * r * r;
  const int threads = 256;
  gram_qr_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                          0, stream>>>(partial, g, batch, r, splits);
  return cudaGetLastError();
}

template <typename In>
cudaError_t dispatch(const In* v, float* partial, float* g, int batch, int d,
                     int r, int rows_per_split, int splits,
                     cudaStream_t stream) {
  switch (tile_side(r)) {
    case 8:
      return launch<In, 8>(v, partial, g, batch, d, r, rows_per_split, splits,
                           stream);
    case 16:
      return launch<In, 16>(v, partial, g, batch, d, r, rows_per_split,
                            splits, stream);
    case 32:
      return launch<In, 32>(v, partial, g, batch, d, r, rows_per_split,
                            splits, stream);
    default:
      return launch<In, 64>(v, partial, g, batch, d, r, rows_per_split,
                            splits, stream);
  }
}

template <typename In, int T>
int blocks_per_sm() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gram_qr_kernel<In, T>, kThreads, 0) != cudaSuccess)
    return 0;
  return per_sm;
}

template <typename In>
int blocks_per_sm_for(int r) {
  switch (tile_side(r)) {
    case 8: return blocks_per_sm<In, 8>();
    case 16: return blocks_per_sm<In, 16>();
    case 32: return blocks_per_sm<In, 32>();
    default: return blocks_per_sm<In, 64>();
  }
}

}  // namespace

extern "C" {

// Output tile pairs (the grid's y axis) a matrix with r columns takes.
int gram_qr_tile_pairs(int r) { return tile_pairs(r); }

// Blocks of pass 1 that fit on one SM at once; 0 on error.
int gram_qr_blocks_per_sm(int r, int is_bf16) {
  return is_bf16 ? blocks_per_sm_for<__nv_bfloat16>(r)
                 : blocks_per_sm_for<float>(r);
}

// G[b] = V_b^T V_b. v: (batch, d, r) f32 or bf16 (is_bf16), g: (batch, r, r)
// f32; partial: (batch, splits, r, r) f32 scratch, read only when
// splits > 1. Rows [s * rows_per_split, (s + 1) * rows_per_split) form range
// s. Returns the CUDA error code of the launches (0 on success).
int gram_qr_launch(const void* v, int is_bf16, float* partial, float* g,
                   int batch, int d, int r, int rows_per_split, int splits,
                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (batch < 1 || d < 1 || r < 1 || splits < 1 || rows_per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      is_bf16 ? dispatch(static_cast<const __nv_bfloat16*>(v), partial, g,
                         batch, d, r, rows_per_split, splits, stream)
              : dispatch(static_cast<const float*>(v), partial, g, batch, d,
                         r, rows_per_split, splits, stream);
  return (int)err;
}

}  // extern "C"
