// Weight-streaming int8 matmul for decode on Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel `paddle_ray_tpu/ops/decode_matmul.py:_kernel`
// (`int8_stream_matmul`): y = (x @ w_q) * scale (+ bias) for a small batch of
// rows, accumulated in f32 and returned in x's dtype.  The int8 weight is
// widened to f32 in registers; a bf16 x int8 product is exact in f32.
//
// Layouts (all contiguous):
//   x      [B, K]     f32 or bf16, B <= 128
//   w      [K, N]     int8, any N (the ragged edge is masked)
//   scale  [N]        f32
//   bias   [N]        f32, or null
//   part   [S, B, N]  f32 scratch when the K range is split (S > 1)
//   out    [B, N]     x's dtype
//
// What bounds it on the H100: the weight bytes.  At decode (B = 8) the
// operations are 2 * B = 16 per weight byte, far below the card's
// operations-per-byte line, so the least time is K * N bytes over 3.35 TB/s
// (1 MB -> 0.3 us; the 51.5 MB LM head -> 15 us).
//
// Design (simple first):
//   * a block owns a tile of 64 output columns, a range of K rows and a group
//     of up to 8 input rows.  Its 256 threads are 16 column groups of 4
//     columns x 16 K sub-rows: each thread reads one 4-byte word of a weight
//     row per step (16 threads read 64 contiguous bytes) and keeps an 8 x 4
//     f32 accumulator; the 16 K sub-rows are summed in shared memory;
//   * x's rows for the block's K range are staged once in shared memory as
//     f32 and read back as broadcasts;
//   * the wrapper splits K over S blocks when there are too few column tiles
//     to fill the card (the 1024-wide layers have 16), so about two blocks
//     run per SM; then each block writes f32 partial sums and a second, small
//     kernel adds the S partials in a fixed order (deterministic) and applies
//     scale and bias.  With one split the first kernel writes the output;
//   * at B <= 8 (the decode path) every weight byte is read from device
//     memory once.  A larger B takes one block row per 8 input rows, which
//     read the same weight tile again (from L2 where it fits).
// Left for later: cp.async/TMA double buffering of the weight rows, and one
// pass over the weights for any B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kColThreads = 16;
constexpr int kTileN = kColThreads * kColsPerThread;  // 64 output columns
constexpr int kKSub = kThreads / kColThreads;         // 16 K sub-rows
constexpr int kRows = 8;                              // input rows per block
constexpr int kMaxTileK = 1024;                       // K rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// smem: x rows [kRows][tile_k] f32, then the K sub-row sums [kKSub][kRows][kTileN] f32
inline size_t smem_bytes(int tile_k) {
  return sizeof(float) * (static_cast<size_t>(kRows) * tile_k + kKSub * kRows * kTileN);
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
int8_stream_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          float* __restrict__ part, T* __restrict__ out, int B, int K, int N,
                          int tile_k) {
  extern __shared__ float smem[];
  float* x_s = smem;                        // [kRows][tile_k]
  float* red = x_s + kRows * tile_k;        // [kKSub][kRows][kTileN]

  const int col0 = blockIdx.x * kTileN;
  const int k0 = blockIdx.y * tile_k;
  const int k1 = min(K, k0 + tile_k);
  const int row0 = blockIdx.z * kRows;
  const int rows = min(kRows, B - row0);
  const int cx = threadIdx.x % kColThreads, ky = threadIdx.x / kColThreads;
  const int c = col0 + cx * kColsPerThread;  // this thread's first column

  for (int i = threadIdx.x; i < kRows * tile_k; i += kThreads) {
    const int r = i / tile_k, k = k0 + i % tile_k;
    x_s[i] = (r < rows && k < k1) ? to_f32(x[static_cast<size_t>(row0 + r) * K + k]) : 0.f;
  }
  __syncthreads();

  float acc[kRows][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;

  if (c < N) {
#pragma unroll 4
    for (int k = k0 + ky; k < k1; k += kKSub) {
      const int8_t* wr = w + static_cast<size_t>(k) * N + c;
      float wf[kColsPerThread];
      if (kAligned) {
        // N % 4 == 0: the four columns are one aligned word (c + 3 < N)
        const char4 q = *reinterpret_cast<const char4*>(wr);
        wf[0] = q.x; wf[1] = q.y; wf[2] = q.z; wf[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) wf[j] = (c + j < N) ? static_cast<float>(wr[j]) : 0.f;
      }
      const float* xk = x_s + (k - k0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = xk[r * tile_k];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
      }
    }
  }

  // sum the K sub-rows
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      red[(ky * kRows + r) * kTileN + cx * kColsPerThread + j] = acc[r][j];
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kTileN; i += kThreads) {
    const int r = i / kTileN, col = col0 + i % kTileN;
    if (r >= rows || col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < kKSub; ++y) s += red[y * kRows * kTileN + i];
    const size_t o = static_cast<size_t>(row0 + r) * N + col;
    if (gridDim.y == 1) {
      float v = s * scale[col];
      if (bias != nullptr) v += bias[col];
      store(out + o, v);
    } else {
      part[static_cast<size_t>(blockIdx.y) * B * N + o] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_stream_matmul_finish(const float* __restrict__ part, const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ out, int B, int N,
                          int splits) {
  const size_t bn = static_cast<size_t>(B) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < bn;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += part[p * bn + i];
    const int col = static_cast<int>(i % N);
    float v = s * scale[col];
    if (bias != nullptr) v += bias[col];
    store(out + i, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* bias,
                   float* part, void* out, int B, int K, int N, int tile_k, cudaStream_t st) {
  const int splits = (K + tile_k - 1) / tile_k;
  const size_t smem = smem_bytes(tile_k);
  const bool aligned = N % 4 == 0;
  auto kern = aligned ? &int8_stream_matmul_kernel<T, true> : &int8_stream_matmul_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTileN - 1) / kTileN, splits, (B + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(x), static_cast<const int8_t*>(w),
                                     scale, bias, part,
                                     static_cast<T*>(out), B, K, N, tile_k);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t bn = static_cast<size_t>(B) * N;
  const int blocks = static_cast<int>(std::min<size_t>((bn + kThreads - 1) / kThreads, 1024));
  int8_stream_matmul_finish<T><<<blocks, kThreads, 0, st>>>(
      part, scale, bias, static_cast<T*>(out), B, N, splits);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes.  dtype: 0 = float32, 1 = bfloat16 (x and out).  `part` holds ceil(K / tile_k) * B * N floats when K is split (else
// it may be null).  Returns the cudaError_t of the launches (0 on success);
// it does not synchronise.
extern "C" int prt_int8_stream_matmul(const void* x, const void* w, const void* scale,
                                      const void* bias, void* part, void* out, int B, int K,
                                      int N, int tile_k, int dtype, void* stream) {
  if (B <= 0 || B > 128 || K <= 0 || N <= 0 || tile_k <= 0 || tile_k > kMaxTileK)
    return cudaErrorInvalidValue;
  if (tile_k < K && part == nullptr) return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* bs = static_cast<const float*>(bias);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, sc, bs, pt, out, B, K, N, tile_k, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, sc, bs, pt, out, B, K, N, tile_k, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* prt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
