// Hopper (sm_90a) flash attention for the LM prefill path:
//   out[b, h, i, :] = softmax_j(q[b, h, i] . k[b, g(h), j] * scale) v[b, g(h), j]
// over the keys j visible to row i, with g(h) = h / (hq / hkv) (GQA).
//
// Replaces: repro/kernels/flash_attention.py  flash_attention_pallas.
//
// It computes what that kernel computes: online softmax with f32 logits,
// running max, normalizer and accumulator; row i sits at
// qpos = i + q_offset and sees key kpos when kpos < kv_valid, kpos <= qpos
// (causal) and kpos > qpos - window (sliding window); masked logits are
// -1e30 and their p is 0; a row that sees no key has l == 0, which is taken
// as 1, so it emits zeros. The output is in the inputs' dtype (bf16 or f32;
// all arithmetic is f32).
//
// What bounds it on the H100: operations. Prefill at qwen2-7b's shape
// (q 4 x 28 x 2048 x 128, k/v 4 x 4 x 2048 x 128, causal) needs
// 4 * b * hq * hd * s(s+1)/2 = 1.2e11 flops over the visible (q, k) pairs
// against 134 MB of q, k, v and output: 0.122 ms at 989 TFLOP/s (bf16 on
// the tensor cores) against 0.040 ms at 3.35 TB/s. This kernel multiplies
// on the CUDA cores in f32, whose 67 TFLOP/s put its floor at 1.8 ms; the
// tensor-core redesign (mma / wgmma, TMA) is later work.
//
// What the design does about it:
//  * Grid (query tile of 64 rows, b * hq). The TPU kernel's sequential kv
//    grid axis is a loop inside the block, which carries m, l and the
//    accumulator in registers; nothing crosses blocks, so there is one pass.
//    Tiles are launched last-first, so the longest (causal) tiles start
//    first and the short ones fill the tail.
//  * The loop visits only kv tiles that hold a visible key: up to the
//    diagonal under causal, from q_start + q_offset - window + 1 under a
//    window, below kv_valid. The TPU kernel's fully masked tiles add
//    exp(-1e30 - m) = 0, so skipping them changes nothing.
//  * GQA: the block reads kv head h / (hq / hkv) of the unexpanded K and V;
//    no expanded copy exists.
//  * 4 warps; a warp owns 16 query rows, a thread 4 rows x 8 keys of the
//    64 x 64 logits tile (keys tx, tx + 8, ...) and 4 rows x hd/8 columns of
//    the accumulator. Row max and sum meet in a 3-step shuffle over the 8
//    lanes that share a row. The q tile, the K and V tiles (converted to
//    f32) and the warp's p rows sit in dynamic shared memory (113 KB at
//    hd = 128, two blocks an SM), the q and K rows padded by one float so
//    that the 8 keys a warp reads at once fall in 8 banks.
//  * Ragged edges are masked here: q rows past sq and keys past skv load as
//    zeros, and only rows < sq are written. Any sq >= 1 and skv >= 1 work.
//  * The head dim is a template parameter: 16, 32, 64, 80 and 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kLanesPerRow = 8;                    // tx = lane % 8
constexpr int kRows = 4;                           // query rows a thread owns
constexpr int kKeys = kBlockK / kLanesPerRow;      // keys a thread owns
constexpr float kNeg = -1e30f;

static_assert(kThreads / kLanesPerRow * kRows == kBlockQ, "row tiling");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
struct Layout {
  static constexpr int kQK = HD + 1;               // padded row of q and K
  static constexpr int kP = kBlockK + 1;           // padded row of p
  static constexpr size_t kBytes =
      sizeof(float) * ((size_t)kBlockQ * kQK + (size_t)kBlockK * kQK +
                       (size_t)kBlockK * HD + (size_t)kBlockQ * kP);
};

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < kLanesPerRow; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kLanesPerRow; o <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int sq, int skv, int q_offset, int kv_valid,
                       int causal, int use_window, int window, float scale) {
  using L = Layout<HD>;
  constexpr int kCols = HD / kLanesPerRow;         // accumulator columns
  static_assert(HD % kLanesPerRow == 0, "head dim tiling");
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * L::kQK;
  float* vs = ks + kBlockK * L::kQK;
  float* ps = vs + kBlockK * HD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int bh = blockIdx.y;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const T* qg = q + (size_t)bh * sq * HD;
  const T* kg = k + (size_t)kvh * skv * HD;
  const T* vg = v + (size_t)kvh * skv * HD;
  T* og = out + (size_t)bh * sq * HD;

  const int tid = threadIdx.x;
  const int tx = tid % kLanesPerRow;
  const int r0 = (tid / kLanesPerRow) * kRows;

  for (int e = tid; e < kBlockQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    qs[r * L::kQK + c] = q0 + r < sq ? to_f32(qg[(size_t)(q0 + r) * HD + c])
                                     : 0.f;
  }

  // keys [k_begin, k_end) hold every key some row of this tile can see
  int k_end = kv_valid;
  if (causal) k_end = min(k_end, min(q0 + kBlockQ, sq) + q_offset);
  const int k_begin = use_window ? max(0, q0 + q_offset - window + 1) : 0;
  const int t_begin = k_begin / kBlockK;
  const int t_end = k_end > k_begin ? (k_end + kBlockK - 1) / kBlockK
                                    : t_begin;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();               // q staged; the last tile's K, V, p read
    for (int e = tid; e < kBlockK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const bool in = k0 + r < skv;
      const size_t g = (size_t)(k0 + r) * HD + c;
      ks[r * L::kQK + c] = in ? to_f32(kg[g]) : 0.f;
      vs[r * HD + c] = in ? to_f32(vg[g]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(r0 + i) * L::kQK + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = ks[(tx + kLanesPerRow * j) * L::kQK + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i + q_offset;
      bool vis[kKeys];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k0 + tx + kLanesPerRow * j;
        bool ok = kpos < kv_valid;
        if (causal) ok = ok && kpos <= qpos;
        if (use_window) ok = ok && kpos > qpos - window;
        vis[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(r0 + i) * L::kP + tx + kLanesPerRow * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();                  // a warp reads back only its own p rows

#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(r0 + i) * L::kP + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[key * HD + tx + kLanesPerRow * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      from_f32(og + (size_t)row * HD + tx + kLanesPerRow * c, acc[i][c] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int hq, int hkv, int sq, int skv, int q_offset,
                   int kv_valid, int causal, int use_window, int window,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  const size_t smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv,
      q_offset, kv_valid, causal, use_window, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* out, int batch, int hq, int hkv, int sq, int skv,
                     int q_offset, int kv_valid, int causal, int use_window,
                     int window, float scale, cudaStream_t stream) {
#define REPRO_FLASH_HD(HD)                                                   \
  case HD:                                                                   \
    return launch<T, HD>(q, k, v, out, batch, hq, hkv, sq, skv, q_offset,    \
                         kv_valid, causal, use_window, window, scale, stream);
  switch (hd) {
    REPRO_FLASH_HD(16)
    REPRO_FLASH_HD(32)
    REPRO_FLASH_HD(64)
    REPRO_FLASH_HD(80)
    REPRO_FLASH_HD(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_HD
}

}  // namespace

extern "C" {

// q, out: (batch, hq, sq, hd); k, v: (batch, hkv, skv, hd); all contiguous,
// all f32 (is_bf16 = 0) or all bf16 (= 1). hq % hkv == 0, hd one of 16, 32,
// 64, 80, 128, batch * hq <= 65535. use_window = 0 ignores window. Returns
// the CUDA error code of the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int batch, int hq, int hkv, int sq,
                           int skv, int hd, int q_offset, int kv_valid,
                           int causal, int use_window, int window, float scale,
                           int is_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(hd, q, k, v, out, batch, hq, hkv, sq,
                                        skv, q_offset, kv_valid, causal,
                                        use_window, window, scale, stream);
  return (int)dispatch<float>(hd, q, k, v, out, batch, hq, hkv, sq, skv,
                              q_offset, kv_valid, causal, use_window, window,
                              scale, stream);
}

}  // extern "C"
