// Ragged paged attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernels `paddle_ray_tpu/ops/paged_attention.py:_kernel`
// and `_kernel_q8` (with their helpers `_online`, `_masked_logits` and
// `_finish`): ragged per-slot query chunks attend that slot's pages of a
// paged KV pool, causal within the chunk at absolute position
// `lengths - q_lens + i`, with GQA (h_q = G * h_kv).  Masked terms weigh exactly 0, dead slots and pad rows
// give 0, and a row whose softmax denominator is 0 emits 0.
//
// Layouts (all contiguous):
//   q      [B, C, h_q, d]         pre-scaled by the wrapper, in q's dtype
//   k, v   [N, page, h_kv, d]     one layer of the pool; page 0 is the null page;
//                                 q's dtype, or int8 (`_kernel_q8`) with
//   ks, vs [N, page, h_kv] f32    per-(token, head) scales: the K scale folds
//                                 into the logit after the dot, the V scale into
//                                 the accumulation weight only (the softmax
//                                 denominator sums the plain exponentials)
//   table  [B, P] int32           physical page per logical block
//   lengths, q_lens [B] int32
//   out    [B, C, h_q, d]         q's dtype
//
// Design (simple first):
//   * one block per (slot b, kv head, tile of 32 (query row, group member)
//     pairs); 8 warps, each warp owns 4 pairs and keeps their running max m,
//     denominator l and accumulator acc in registers (f32);
//   * the block walks its slot's pages in order -- the loop that replaces
//     the TPU's sequential grid axis -- reading each page id from the table
//     itself, and stops after the last page any of its rows can see
//     (never past ceil(lengths[b] / page), never past P);
//   * each page's K and V tiles are staged in shared memory as f32 (K rows
//     padded by one word, so lane i reading key i is bank-conflict free);
//   * logits: each lane owns keys lane, lane+32, ...; the accumulation: each
//     lane owns output dims lane, lane+32, ..., with the page's weights
//     staged per warp in shared memory.
//
// What bounds it on the H100: decode (one row per slot) is bound by bytes --
// every live K and V page is read once, 2 * len * h_kv * d * sizeof(T) per
// slot (int8: d + 4 bytes per row and head), against 3.35 TB/s.  The 128-row
// prefill chunks are bound by operations: 4 * C * len * h * d FLOPs against the tensor cores.  This
// design uses neither well: the dot products run on the f32 CUDA cores, the
// page loads are synchronous, and a decode slot's pages stream through one
// block.  Left for later: wgmma for Q.K^T and P.V on the prefill tiles, TMA
// with an mbarrier ring to overlap page loads with compute, and split-K over
// pages (a second reduction pass) so a long decode slot spreads over SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kPairs = kWarps * kRowsPerWarp;  // (row, group member) pairs per block
constexpr float kNeg = -1e30f;                 // the TPU kernel's _NEG

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
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
template <> struct Vec16<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(b[i]);
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

template <int D, int PAGE>
constexpr size_t smem_bytes() {
  return sizeof(float) * (PAGE * (D + 1) + PAGE * D + kPairs * D + kPairs * PAGE + 2 * PAGE);
}

template <typename T, typename KV, bool Q8, int D, int PAGE>
__global__ void __launch_bounds__(kWarps * 32)
paged_ragged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kpool,
                              const KV* __restrict__ vpool, const float* __restrict__ kscale,
                              const float* __restrict__ vscale, const int* __restrict__ table,
                              const int* __restrict__ lengths, const int* __restrict__ q_lens,
                              T* __restrict__ out, int C, int h_q, int h_kv, int P) {
  constexpr int kDL = D / 32;        // output dims per lane
  constexpr int kKL = PAGE / 32;     // keys per lane
  constexpr int kKS = D + 1;         // padded K row, in floats
  constexpr int kVN = Vec16<KV>::kN; // elements per 16-byte load
  extern __shared__ float smem[];
  float* k_s = smem;                 // [PAGE][D + 1]
  float* v_s = k_s + PAGE * kKS;     // [PAGE][D]
  float* q_s = v_s + PAGE * D;       // [kPairs][D]
  float* p_s = q_s + kPairs * D;     // [kPairs][PAGE]
  float* ks_s = p_s + kPairs * PAGE; // [PAGE] int8 K scales
  float* vs_s = ks_s + PAGE;         // [PAGE] int8 V scales

  const int b = blockIdx.x, hk = blockIdx.y;
  const int group = h_q / h_kv;
  const int pair0 = blockIdx.z * kPairs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ln = lengths[b];
  const int ql = min(q_lens[b], C);
  const int n_pairs = C * group;            // pairs of this (b, kv head)
  const int live_pairs = ql * group;        // pair index = row * group + member
  const int here = min(kPairs, n_pairs - pair0);

  auto out_row = [&](int pi) {
    const int qi = pi / group, g = pi % group;
    return out + ((static_cast<size_t>(b) * C + qi) * h_q + hk * group + g) * D;
  };

  if (ln <= 0 || pair0 >= live_pairs) {
    // dead slot, or every row of this tile is a pad row: zeros
    for (int i = threadIdx.x; i < here * D; i += blockDim.x)
      store(out_row(pair0 + i / D) + i % D, 0.f);
    return;
  }

  // stage this tile's query rows (already scaled) as f32
  for (int i = threadIdx.x; i < kPairs * D; i += blockDim.x) {
    const int pi = pair0 + i / D;
    const int qi = pi / group, g = pi % group;
    float x = 0.f;
    if (pi < live_pairs)
      x = to_f32(q[((static_cast<size_t>(b) * C + qi) * h_q + hk * group + g) * D + i % D]);
    q_s[i] = x;
  }

  // the last key any live row of this tile may see
  const int last_row = (min(live_pairs, pair0 + kPairs) - 1) / group;
  const int last_pos = ln - ql + last_row;
  const int n_pages = last_pos < 0 ? 0 : min(last_pos / PAGE + 1, P);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDL];
  int qpos[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int pi = pair0 + warp * kRowsPerWarp + r;
    live[r] = pi < live_pairs;
    qpos[r] = ln - ql + pi / group;
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDL; ++j) acc[r][j] = 0.f;
  }
  const bool warp_live = pair0 + warp * kRowsPerWarp < live_pairs;
  const size_t row_stride = static_cast<size_t>(h_kv) * D;  // between tokens of a page

  for (int jp = 0; jp < n_pages; ++jp) {
    __syncthreads();  // the previous page's tiles are no longer read
    const int pid = table[static_cast<size_t>(b) * P + jp];
    const KV* kp = kpool + static_cast<size_t>(pid) * PAGE * row_stride + hk * D;
    const KV* vp = vpool + static_cast<size_t>(pid) * PAGE * row_stride + hk * D;
    if (Q8) {
      for (int t = threadIdx.x; t < PAGE; t += blockDim.x) {
        const size_t si = (static_cast<size_t>(pid) * PAGE + t) * h_kv + hk;
        ks_s[t] = kscale[si];
        vs_s[t] = vscale[si];
      }
    }
    for (int i = threadIdx.x; i < PAGE * (D / kVN); i += blockDim.x) {
      const int t = i / (D / kVN), c = (i % (D / kVN)) * kVN;
      const uint4 uk = *reinterpret_cast<const uint4*>(kp + t * row_stride + c);
      const uint4 uv = *reinterpret_cast<const uint4*>(vp + t * row_stride + c);
      float fk[kVN], fv[kVN];
      Vec16<KV>::widen(uk, fk);
      Vec16<KV>::widen(uv, fv);
#pragma unroll
      for (int e = 0; e < kVN; ++e) {
        k_s[t * kKS + c + e] = fk[e];
        v_s[t * D + c + e] = fv[e];
      }
    }
    __syncthreads();
    if (!warp_live) continue;

    // logits: s[r][kk] = q_r . k_(kk*32 + lane)
    float s[kRowsPerWarp][kKL];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int kk = 0; kk < kKL; ++kk) s[r][kk] = 0.f;
    const float* qw = q_s + warp * kRowsPerWarp * D;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float kv[kKL];
#pragma unroll
      for (int kk = 0; kk < kKL; ++kk) kv[kk] = k_s[(kk * 32 + lane) * kKS + c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qv = qw[r * D + c];
#pragma unroll
        for (int kk = 0; kk < kKL; ++kk) s[r][kk] = fmaf(qv, kv[kk], s[r][kk]);
      }
    }

    // online softmax: masked terms weigh exactly 0
    float* pw = p_s + warp * kRowsPerWarp * PAGE;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      bool ok[kKL];
      float mx = kNeg;
#pragma unroll
      for (int kk = 0; kk < kKL; ++kk) {
        const int t = jp * PAGE + kk * 32 + lane;
        ok[kk] = live[r] && t <= qpos[r];
        if (Q8) s[r][kk] *= ks_s[kk * 32 + lane];  // K scale fold
        s[r][kk] = ok[kk] ? s[r][kk] : kNeg;
        mx = fmaxf(mx, s[r][kk]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float corr = expf(m[r] - m_new);
      float esum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKL; ++kk) {
        const float e = ok[kk] ? expf(s[r][kk] - m_new) : 0.f;
        // the V scale weighs the accumulation only
        pw[r * PAGE + kk * 32 + lane] = Q8 ? e * vs_s[kk * 32 + lane] : e;
        esum += e;
      }
      l[r] = l[r] * corr + warp_sum(esum);
#pragma unroll
      for (int j = 0; j < kDL; ++j) acc[r][j] *= corr;
      m[r] = m_new;
    }
    __syncwarp();
#pragma unroll 4
    for (int t = 0; t < PAGE; ++t) {
      float vv[kDL];
#pragma unroll
      for (int j = 0; j < kDL; ++j) vv[j] = v_s[t * D + j * 32 + lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = pw[r * PAGE + t];
#pragma unroll
        for (int j = 0; j < kDL; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
    __syncwarp();
  }

  // finish: l == 0 (dead or fully masked row) emits zeros
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int pi = pair0 + warp * kRowsPerWarp + r;
    if (pi >= n_pairs) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    T* o = out_row(pi);
#pragma unroll
    for (int j = 0; j < kDL; ++j) store(o + j * 32 + lane, acc[r][j] / l_safe);
  }
}

template <typename T, typename KV, bool Q8, int D, int PAGE>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                   const int* table, const int* lengths, const int* q_lens, void* out, int B,
                   int C, int h_q, int h_kv, int P, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, PAGE>();
  auto kern = paged_ragged_attention_kernel<T, KV, Q8, D, PAGE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int pairs = C * (h_q / h_kv);
  dim3 grid(B, h_kv, (pairs + kPairs - 1) / kPairs);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs,
      table, lengths, q_lens, static_cast<T*>(out), C, h_q, h_kv, P);
  return cudaGetLastError();
}

template <typename T, typename KV, bool Q8, int D>
cudaError_t launch_page(int page, const void* q, const void* k, const void* v, const float* ks,
                        const float* vs, const int* table, const int* lengths, const int* q_lens,
                        void* out, int B, int C, int h_q, int h_kv, int P, cudaStream_t stream) {
  switch (page) {
    case 32: return launch<T, KV, Q8, D, 32>(q, k, v, ks, vs, table, lengths, q_lens, out, B, C, h_q, h_kv, P, stream);
    case 64: return launch<T, KV, Q8, D, 64>(q, k, v, ks, vs, table, lengths, q_lens, out, B, C, h_q, h_kv, P, stream);
    case 128: return launch<T, KV, Q8, D, 128>(q, k, v, ks, vs, table, lengths, q_lens, out, B, C, h_q, h_kv, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV, bool Q8>
cudaError_t launch_dtype(int d, int page, const void* q, const void* k, const void* v,
                         const float* ks, const float* vs, const int* table, const int* lengths,
                         const int* q_lens, void* out, int B, int C, int h_q, int h_kv, int P,
                         cudaStream_t stream) {
  switch (d) {
    case 64: return launch_page<T, KV, Q8, 64>(page, q, k, v, ks, vs, table, lengths, q_lens, out, B, C, h_q, h_kv, P, stream);
    case 128: return launch_page<T, KV, Q8, 128>(page, q, k, v, ks, vs, table, lengths, q_lens, out, B, C, h_q, h_kv, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entries bound with ctypes.  dtype: 0 = float32, 1 = bfloat16 (q and out,
// and the pool of the first entry).  The _q8 entry takes the int8 pool with
// its f32 scales.  Each returns the cudaError_t of the launch (0 on
// success); it does not synchronise.
extern "C" int prt_paged_ragged_attention(const void* q, const void* k, const void* v,
                                          const void* table, const void* lengths,
                                          const void* q_lens, void* out, int B, int C, int h_q,
                                          int h_kv, int d, int page, int P, int dtype,
                                          void* stream) {
  if (B <= 0 || C <= 0 || h_kv <= 0 || h_q % h_kv != 0) return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  const int* qlp = static_cast<const int*>(q_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float, float, false>(d, page, q, k, v, nullptr, nullptr, tb, ln, qlp, out, B, C, h_q, h_kv, P, st);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16, __nv_bfloat16, false>(d, page, q, k, v, nullptr, nullptr, tb, ln, qlp, out, B, C, h_q, h_kv, P, st);
  return cudaErrorInvalidValue;
}

extern "C" int prt_paged_ragged_attention_q8(const void* q, const void* k, const void* ks,
                                             const void* v, const void* vs, const void* table,
                                             const void* lengths, const void* q_lens, void* out,
                                             int B, int C, int h_q, int h_kv, int d, int page,
                                             int P, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || h_kv <= 0 || h_q % h_kv != 0) return cudaErrorInvalidValue;
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  const int* qlp = static_cast<const int*>(q_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float, int8_t, true>(d, page, q, k, v, ksp, vsp, tb, ln, qlp, out, B, C, h_q, h_kv, P, st);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16, int8_t, true>(d, page, q, k, v, ksp, vsp, tb, ln, qlp, out, B, C, h_q, h_kv, P, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* prt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
