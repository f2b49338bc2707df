// Fused one-token decode attention over a dense KV cache for Hopper (sm_90a),
// plain CUDA C++.
//
// Replaces the TPU kernels `paddle_ray_tpu/ops/decode_attention.py:
// _kernel_bf16` (bf16 and f32 caches) and `_kernel_q8` (int8 cache with
// per-(token, head) f32 scales), with their helper `_online_step`: one query
// row per (batch, head) attends the cache rows t <= pos.  The int8 K scale
// folds into the logit after the dot, the V scale into the accumulation
// weight only; the softmax denominator sums the plain exponentials.  Masked
// logits are -1e30 before the max, exponentials are natural (expf).
//
// Layouts (all contiguous):
//   q        [BH, d]       pre-scaled by the wrapper, in q's dtype
//   k, v     [BH, T, d]    q's dtype, or int8 with
//   ks, vs   [BH, T]       f32 scales
//   out      [BH, d]       q's dtype
//
// What bounds it on the H100: the cache bytes.  Each live row of K and V is
// read once, 2 * (pos + 1) * d * sizeof(element) per (b, h) pair (+ 8 bytes
// of scales for int8), against 3.35 TB/s; the 4 * (pos + 1) * d operations
// per pair are far below the card's rate.  The grid reads no row past pos
// (the TPU kernel's grid walks the whole allocation).
//
// d is 64, 80, 96 or 128: a row is whole 16-byte loads (bf16 160 and 192
// bytes, int8 80 and 96 at d 80 and 96).
//
// Design (simple first): one block per (b, h) pair -- gpt3-350m decode at
// batch 8 has 128 pairs for 132 SMs.  Its 8 warps take groups of 32 cache
// rows in turn; in a group each lane owns one row for the dot product
// (16-byte loads of its row, q broadcast from shared memory), the warp keeps
// its own running max, denominator and an f32 accumulator with each lane
// owning output dims lane + 32 j for j < ceil(d / 32) (the last group masked
// where d is not a multiple of 32), and the group's weights reach the lanes
// by shuffle.  At the end the 8 warps' partial softmaxes merge in shared memory.
// Left for later: split the rows of a pair over several blocks (a second
// pass merges them) when B * h is small, and cp.async prefetch of the next
// group's rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr float kNeg = -1e30f;  // the TPU kernel's _NEG

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// A 16-byte load of T, widened to f32.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <> struct Vec16<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(b[i]);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, typename KV, bool Q8, int D>
__global__ void __launch_bounds__(kWarps * 32)
fused_decode_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                              const KV* __restrict__ v, const float* __restrict__ ks,
                              const float* __restrict__ vs, T* __restrict__ out, int T_len,
                              int n_live) {
  constexpr int kDL = (D + 31) / 32;  // output dims per lane, the last masked
  static_assert(D % Vec16<KV>::kN == 0, "whole 16-byte loads of a row");
  constexpr int kVN = Vec16<KV>::kN;  // elements per 16-byte load
  __shared__ float q_s[D];
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][D];

  const int bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < D; i += blockDim.x) q_s[i] = to_f32(q[static_cast<size_t>(bh) * D + i]);
  __syncthreads();

  const KV* kb = k + static_cast<size_t>(bh) * T_len * D;
  const KV* vb = v + static_cast<size_t>(bh) * T_len * D;
  const float* ksb = Q8 ? ks + static_cast<size_t>(bh) * T_len : nullptr;
  const float* vsb = Q8 ? vs + static_cast<size_t>(bh) * T_len : nullptr;

  float m = kNeg, l = 0.f, acc[kDL];
#pragma unroll
  for (int j = 0; j < kDL; ++j) acc[j] = 0.f;

  const int groups = (n_live + 31) / 32;
  for (int g = warp; g < groups; g += kWarps) {
    const int t = g * 32 + lane;
    const bool live = t < n_live;
    float s = kNeg;
    if (live) {
      const KV* kr = kb + static_cast<size_t>(t) * D;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += kVN) {
        float f[kVN];
        Vec16<KV>::widen(*reinterpret_cast<const uint4*>(kr + c), f);
#pragma unroll
        for (int e = 0; e < kVN; ++e) dot = fmaf(q_s[c + e], f[e], dot);
      }
      s = Q8 ? dot * ksb[t] : dot;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float corr = expf(m - m_new);
    const float e = live ? expf(s - m_new) : 0.f;
    l = l * corr + warp_sum(e);
    const float w = Q8 ? (live ? e * vsb[t] : 0.f) : e;
#pragma unroll
    for (int j = 0; j < kDL; ++j) acc[j] *= corr;
    m = m_new;
    const int rows = min(32, n_live - g * 32);  // never read a row past pos
    const KV* vg = vb + static_cast<size_t>(g) * 32 * D;
    for (int tt = 0; tt < rows; ++tt) {
      const float p = __shfl_sync(0xffffffffu, w, tt);
#pragma unroll
      for (int j = 0; j < kDL; ++j)
        if (j * 32 + lane < D)
          acc[j] = fmaf(p, to_f32(vg[static_cast<size_t>(tt) * D + j * 32 + lane]), acc[j]);
    }
  }

  // merge the warps' partial softmaxes
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < kDL; ++j)
    if (j * 32 + lane < D) acc_s[warp][j * 32 + lane] = acc[j];
  __syncthreads();
  float mx = kNeg;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w] - mx);
      num = fmaf(acc_s[w][i], c, num);
      den = fmaf(l_s[w], c, den);
    }
    store(out + static_cast<size_t>(bh) * D + i, num / den);
  }
}

template <typename T, typename KV, bool Q8, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, void* out, int BH, int T_len, int n_live, cudaStream_t st) {
  fused_decode_attention_kernel<T, KV, Q8, D><<<BH, kWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs,
      static_cast<T*>(out), T_len, n_live);
  return cudaGetLastError();
}

template <typename T, typename KV, bool Q8>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, void* out, int BH, int T_len, int n_live, cudaStream_t st) {
  switch (d) {
    case 64: return launch<T, KV, Q8, 64>(q, k, v, ks, vs, out, BH, T_len, n_live, st);
    case 80: return launch<T, KV, Q8, 80>(q, k, v, ks, vs, out, BH, T_len, n_live, st);
    case 96: return launch<T, KV, Q8, 96>(q, k, v, ks, vs, out, BH, T_len, n_live, st);
    case 128: return launch<T, KV, Q8, 128>(q, k, v, ks, vs, out, BH, T_len, n_live, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry bound with ctypes.  dtype: 0 = float32, 1 = bfloat16 (q and out;
// the cache too unless q8).  q8: 1 = int8 cache with ks/vs scales.  n_live =
// pos + 1 rows of the cache are attended.  Returns the cudaError_t of the
// launch (0 on success); it does not synchronise.
extern "C" int prt_fused_decode_attention(const void* q, const void* k, const void* v,
                                          const void* ks, const void* vs, void* out, int BH,
                                          int T_len, int d, int n_live, int dtype, int q8,
                                          void* stream) {
  if (BH <= 0 || n_live <= 0 || n_live > T_len) return cudaErrorInvalidValue;
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q8) {
    if (ksp == nullptr || vsp == nullptr) return cudaErrorInvalidValue;
    if (dtype == 0) return launch_d<float, int8_t, true>(d, q, k, v, ksp, vsp, out, BH, T_len, n_live, st);
    if (dtype == 1) return launch_d<__nv_bfloat16, int8_t, true>(d, q, k, v, ksp, vsp, out, BH, T_len, n_live, st);
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch_d<float, float, false>(d, q, k, v, nullptr, nullptr, out, BH, T_len, n_live, st);
  if (dtype == 1) return launch_d<__nv_bfloat16, __nv_bfloat16, false>(d, q, k, v, nullptr, nullptr, out, BH, T_len, n_live, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* prt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
