// Fused one-token decode attention over a dense KV cache for Hopper (sm_90a),
// plain CUDA C++.
//
// Replaces the TPU kernels `paddle_ray_tpu/ops/decode_attention.py:
// _kernel_bf16` (bf16 and f32 caches) and `_kernel_q8` (int8 cache with
// per-(token, head) f32 scales), with their helper `_online_step`: one query
// row per (batch, head) attends the cache rows t <= pos.  q is pre-scaled
// here: q * scale (the scale already rounded to q's type by the wrapper) is
// rounded to q's type before it is widened, bit for bit the JAX wrapper's
// `flat(q) * jnp.asarray(scale, q.dtype)`.  The logits are f32; the int8 K
// scale folds into the logit after the dot, the V scale into the
// accumulation weight only; the softmax denominator sums the plain
// exponentials.  Masked logits are -1e30 before the max, exponentials are
// natural (expf).
//
// Layouts:
//   q        [B, h, 1, d]  q's dtype; d contiguous, batch and head strides
//                          given (generate()'s transposed view is read as it lies)
//   k, v     [BH, T, d]    contiguous, q's dtype, or int8 with
//   ks, vs   [BH, T]       f32 scales
//   out      [BH, d]       q's dtype
//
// What bounds it on the H100: the cache bytes.  Each live row of K and V is
// read once, 2 * (pos + 1) * d * sizeof(element) per (b, h) pair (+ 8 bytes
// of scales for int8), against 3.35 TB/s; the 4 * (pos + 1) * d operations
// per pair are far below the card's rate.  No row past pos is read (the TPU
// kernel's grid walks the whole allocation).
//
// d is 64, 80, 96 or 128: a row is whole 16-byte pieces at every type.
//
// Design, for bytes in flight:
//   * split-K over a pair's rows (flash-decoding): one block per (split, pair);
//     the wrapper's `decode_split_plan` gives each split a whole number of
//     32-row groups, no split on a card full of work and never an empty one.
//     With one split the block writes the output; with several each writes its
//     (m, l, acc) to a workspace and the last block of the pair to finish --
//     found by an atomic counter it resets -- merges them in split order by the
//     log-sum-exp rule, so a call is one launch and two calls give the same bits;
//   * the block's warps (8, or fewer where two stages would pass the 227 KB a
//     block may hold) take the split's 32-row groups in turn.  A group of a
//     pair's rows is one contiguous byte range at any d, streamed by 16-byte
//     `cp.async` with every lane on neighbouring addresses into the warp's own
//     ring of two stages (rows padded by 16 bytes, so neither pass below has a
//     bank conflict); the next group flies while this one is computed.  Where
//     no warp has two groups the ring has one stage, and every group of the
//     split is in flight at once in half the shared memory, so two blocks fit
//     an SM: at gpt3-350m's batch-8 decode (pos 255) 64 KB a block;
//   * logits a lane per row (16-byte reads of its row, q broadcast from shared
//     memory); the warp's online softmax by shuffles;
//   * the V sum over column slices, not rows: a lane owns one 16-byte slice of
//     V (8 bf16, 4 f32 or 16 int8 values) over every R-th row of the group (R =
//     32 / slices a row), its weight by shuffle; the R partial sums of a slice
//     are added by shuffles once, when the warp is done;
//   * the warps' (m, l, acc) merge in shared memory in warp order.
//   int8 is widened by a byte permute under 2^23 and one subtraction (exact, off
//   the conversion unit), bf16 by a shift.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroup = 32;            // rows of a streamed group: a lane each for the logits
constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 232448;      // a block's shared memory on the H100
constexpr int kStages = 2;
constexpr float kNeg = -1e30f;        // the TPU kernel's _NEG

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// q * scale rounded to q's type, widened: the JAX wrapper's pre-scaled q
__device__ __forceinline__ float prescale(float q, float s) { return __fmul_rn(q, s); }
__device__ __forceinline__ float prescale(__nv_bfloat16 q, float s) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(__bfloat162float(q), s)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// int8 -> f32 exactly: the byte b ^ 0x80 = b + 128 under the exponent of 2^23
// is 2^23 + b + 128, minus 2^23 + 128.  u holds four int8 already XOR 0x80.
template <int I>
__device__ __forceinline__ float i8_to_f32(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | I)) - 8388736.f;
}

// A cache element type: 16 bytes widened to f32.
template <typename KV> struct Elt;
template <> struct Elt<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void widen(const uint4& w, float* f) {
    const uint32_t ws[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                            w.w ^ 0x80808080u};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      f[4 * h] = i8_to_f32<0>(ws[h]);
      f[4 * h + 1] = i8_to_f32<1>(ws[h]);
      f[4 * h + 2] = i8_to_f32<2>(ws[h]);
      f[4 * h + 3] = i8_to_f32<3>(ws[h]);
    }
  }
};
template <> struct Elt<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& w, float* f) {
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      f[2 * h] = __uint_as_float(ws[h] << 16);
      f[2 * h + 1] = __uint_as_float(ws[h] & 0xffff0000u);
    }
  }
};
template <> struct Elt<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void widen(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};

// shared memory besides the ring: q, the warps' (acc, m, l), the merge flag
constexpr size_t rest_bytes(int d, int warps) {
  return sizeof(float) * (d + warps * (d + 2)) + 16;
}

template <typename KV, int D>
struct Cfg {
  static constexpr bool kQ8 = std::is_same<KV, int8_t>::value;
  static constexpr int kES = sizeof(KV);
  static constexpr int kS = D * kES / 16;                 // 16-byte slices a row
  static constexpr int kR = kGroup / kS;                  // row subsets of the V sum
  static constexpr int kVLanes = kR * kS;                 // lanes of the V sum
  static constexpr int kVIters = (kGroup + kR - 1) / kR;  // rows a V lane visits a group
  static constexpr int kRS = D * kES + 16;                // a row in shared memory, bytes
  static constexpr int kVals = kGroup * kRS;              // one K or V group, bytes
  static constexpr int kStage = 2 * kVals + (kQ8 ? 2 * kGroup * 4 : 0);
  // 8 warps where two stages each fit, else 4, else 2
  static constexpr int kWarps =
      kMaxWarps * kStages * kStage + rest_bytes(D, kMaxWarps) <= kMaxSmem ? kMaxWarps
      : (kMaxWarps / 2) * kStages * kStage + rest_bytes(D, kMaxWarps / 2) <= kMaxSmem
          ? kMaxWarps / 2
          : kMaxWarps / 4;
  // a ring of two stages a warp, or one where no warp has two groups
  static constexpr size_t smem(int stages) {
    return static_cast<size_t>(kWarps) * stages * kStage + rest_bytes(D, kWarps);
  }
  static_assert(kWarps * kStages * kStage + rest_bytes(D, kWarps) <= kMaxSmem,
                "a block's shared memory");
  static_assert(D * kES % 16 == 0 && kS <= 32, "whole 16-byte slices, at most a warp's");
};

// two blocks an SM where their shared memory fits (at most 128 registers a thread)
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(32 * Cfg<KV, D>::kWarps, 2)
fused_decode_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                              const KV* __restrict__ v, const float* __restrict__ ks,
                              const float* __restrict__ vs, T* __restrict__ out,
                              float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
                              int* __restrict__ counters, int H, long long q_sb, long long q_sh,
                              int T_len, int n_live, int rps, float scale) {
  using Cf = Cfg<KV, D>;
  using E = Elt<KV>;
  constexpr bool kQ8 = Cf::kQ8;
  constexpr int W = Cf::kWarps, S = Cf::kS, R = Cf::kR, RS = Cf::kRS, VN = E::kN;
  extern __shared__ __align__(16) uint8_t smem[];
  // two stages a warp where a warp has two groups or more, else one: every
  // group of the split is then in flight at once, in half the shared memory
  const int stages = rps / kGroup > W ? kStages : 1;
  float* q_s = reinterpret_cast<float*>(smem + W * stages * Cf::kStage);  // [D] the pre-scaled q
  float* red_acc = q_s + D;                                 // [warp][D]
  float* red_m = red_acc + W * D;                           // [warp]
  float* red_l = red_m + W;
  int* flag = reinterpret_cast<int*>(red_l + W);

  const int split = blockIdx.x, n_splits = gridDim.x, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = split * rps, row_end = min(n_live, row0 + rps);
  const int groups = (row_end - row0 + kGroup - 1) / kGroup;
  const int n_my = groups > warp ? (groups - warp + W - 1) / W : 0;

  const size_t cache0 = static_cast<size_t>(bh) * T_len;
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(k + cache0 * D);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(v + cache0 * D);
  auto stage = [&](int st) { return smem + (warp * stages + st) * Cf::kStage; };
  // group i of this warp (rows row0 + 32 (warp + W i) ...) into stage st
  auto issue = [&](int i, int st) {
    const int t0 = row0 + kGroup * (warp + W * i);
    const int rows = min(kGroup, row_end - t0);
    uint8_t* k_s = stage(st);
    uint8_t* v_s = k_s + Cf::kVals;
    const size_t off = static_cast<size_t>(t0) * D * Cf::kES;
#pragma unroll
    for (int x = 0; x < S; ++x) {
      const int j = lane + 32 * x, r = j / S, c = j % S;
      if (r < rows) {
        cp16(k_s + r * RS + 16 * c, kb + off + 16 * j);
        cp16(v_s + r * RS + 16 * c, vb + off + 16 * j);
      }
    }
    if constexpr (kQ8) {
      float* sc = reinterpret_cast<float*>(v_s + Cf::kVals);
      if (lane < rows) {
        cp4(sc + lane, ks + cache0 + t0 + lane);
        cp4(sc + kGroup + lane, vs + cache0 + t0 + lane);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_my) issue(i, i);
    cp_commit();
  }
  // the pre-scaled q, while the first groups fly
  const T* qr = q + static_cast<long long>(bh / H) * q_sb + static_cast<long long>(bh % H) * q_sh;
  for (int i = threadIdx.x; i < D; i += 32 * W) q_s[i] = prescale(qr[i], scale);
  __syncthreads();

  float m = kNeg, l = 0.f, acc[VN];
#pragma unroll
  for (int e = 0; e < VN; ++e) acc[e] = 0.f;
  const int vr = lane / S, vc = lane % S;  // the lane's V row subset and slice
  for (int i = 0; i < n_my; ++i) {
    if (i + kStages - 1 < n_my) issue(i + kStages - 1, (i + kStages - 1) % stages);
    cp_commit();
    cp_wait<kStages - 1>();  // group i; with one stage the later group is empty
    __syncwarp();
    const uint8_t* k_s = stage(i % stages);
    const uint8_t* v_s = k_s + Cf::kVals;
    const float* ks_s = reinterpret_cast<const float*>(v_s + Cf::kVals);
    const int rows = min(kGroup, row_end - (row0 + kGroup * (warp + W * i)));
    const bool live = lane < rows;
    // the lane's row's logit
    float s = kNeg;
    if (live) {
      const uint8_t* kr = k_s + lane * RS;
      float dot = 0.f;
#pragma unroll
      for (int x = 0; x < S; ++x) {
        float f[VN];
        E::widen(*reinterpret_cast<const uint4*>(kr + 16 * x), f);
        const float4* qv = reinterpret_cast<const float4*>(q_s + VN * x);
#pragma unroll
        for (int h = 0; h < VN / 4; ++h) {
          const float4 qq = qv[h];
          dot = fmaf(qq.x, f[4 * h], dot);
          dot = fmaf(qq.y, f[4 * h + 1], dot);
          dot = fmaf(qq.z, f[4 * h + 2], dot);
          dot = fmaf(qq.w, f[4 * h + 3], dot);
        }
      }
      s = kQ8 ? dot * ks_s[lane] : dot;
    }
    float mx = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    const float e = live ? expf(s - m_new) : 0.f;
    float es = e;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) es += __shfl_xor_sync(0xffffffffu, es, o);
    l = l * corr + es;
    m = m_new;
    const float w = kQ8 ? e * ks_s[kGroup + lane] : e;  // the V scale weighs the sum only
#pragma unroll
    for (int x = 0; x < VN; ++x) acc[x] *= corr;
    // the V sum: slice vc of rows vr, vr + R, ... of the group
#pragma unroll
    for (int it = 0; it < Cf::kVIters; ++it) {
      const int t = vr + R * it;
      const float p = __shfl_sync(0xffffffffu, w, t & 31);
      if (lane < Cf::kVLanes && t < rows) {
        float f[VN];
        E::widen(*reinterpret_cast<const uint4*>(v_s + t * RS + 16 * vc), f);
#pragma unroll
        for (int x = 0; x < VN; ++x) acc[x] = fmaf(p, f[x], acc[x]);
      }
    }
    __syncwarp();
  }
  cp_wait<0>();

  // the warp's row subsets added by shuffles, in subset order
#pragma unroll
  for (int r = 1; r < R; ++r)
#pragma unroll
    for (int x = 0; x < VN; ++x) {
      const float o = __shfl_sync(0xffffffffu, acc[x], (vc + r * S) & 31);
      if (lane < S) acc[x] += o;
    }
  if (lane < S) {
#pragma unroll
    for (int x = 0; x < VN; ++x) red_acc[warp * D + VN * lane + x] = acc[x];
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  __syncthreads();

  // the warps' parts merged by the log-sum-exp rule, in warp order (a warp with
  // no group has l = 0 and m = -1e30: it weighs 0)
  float M = kNeg;
#pragma unroll
  for (int w2 = 0; w2 < W; ++w2) M = fmaxf(M, red_m[w2]);
  const size_t part = static_cast<size_t>(bh) * n_splits + split;
  for (int d = threadIdx.x; d < D; d += 32 * W) {
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < W; ++w2) {
      const float f = expf(red_m[w2] - M);
      L = fmaf(red_l[w2], f, L);
      A = fmaf(red_acc[w2 * D + d], f, A);
    }
    if (n_splits == 1) {
      store(out + static_cast<size_t>(bh) * D + d, A / L);
    } else {
      ws_acc[part * D + d] = A;
      if (d == 0) ws_ml[part] = make_float2(M, L);
    }
  }
  if (n_splits == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(&counters[bh], 1) == n_splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const size_t first = static_cast<size_t>(bh) * n_splits;
  float M2 = kNeg;
  for (int s2 = 0; s2 < n_splits; ++s2) M2 = fmaxf(M2, __ldcg(&ws_ml[first + s2]).x);
  for (int d = threadIdx.x; d < D; d += 32 * W) {
    float L = 0.f, A = 0.f;
    for (int s2 = 0; s2 < n_splits; ++s2) {
      const float2 ml = __ldcg(&ws_ml[first + s2]);
      const float f = expf(ml.x - M2);
      L = fmaf(ml.y, f, L);
      A = fmaf(__ldcg(&ws_acc[(first + s2) * D + d]), f, A);
    }
    store(out + static_cast<size_t>(bh) * D + d, A / L);
  }
  if (threadIdx.x == 0) counters[bh] = 0;  // ready for the next launch
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  void* out;
  float* ws_acc;
  float2* ws_ml;
  int* counters;
  int BH, H;
  long long q_sb, q_sh;
  int T_len, n_live, n_splits, rps;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D>
cudaError_t launch(const Args& a) {
  using Cf = Cfg<KV, D>;
  auto kern = fused_decode_attention_kernel<T, KV, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Cf::smem(kStages)));
  if (err != cudaSuccess) return err;
  if (a.BH > 65535) return cudaErrorInvalidValue;
  const size_t smem = Cf::smem(a.rps / kGroup > Cf::kWarps ? kStages : 1);
  kern<<<dim3(a.n_splits, a.BH), 32 * Cf::kWarps, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v), a.ks,
      a.vs, static_cast<T*>(a.out), a.ws_acc, a.ws_ml, a.counters, a.H, a.q_sb, a.q_sh, a.T_len,
      a.n_live, a.rps, a.scale);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch_d(int d, const Args& a) {
  switch (d) {
    case 64: return launch<T, KV, 64>(a);
    case 80: return launch<T, KV, 80>(a);
    case 96: return launch<T, KV, 96>(a);
    case 128: return launch<T, KV, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry bound with ctypes.  dtype: 0 = float32, 1 = bfloat16 (q and out;
// the cache too unless q8).  q8: 1 = int8 cache with ks/vs scales.  q is read
// at q + (bh / H) * q_sb + (bh % H) * q_sh (elements); scale is already
// rounded to q's type.  n_live = pos + 1 rows of the cache are attended, cut
// into n_splits splits of rps rows (a multiple of 32; the last split shorter,
// none empty).  With more than one split: a workspace of f32 [BH, n_splits, d]
// and float2 [BH, n_splits] partials and int32 [BH] counters, zero before the
// first launch (the kernel leaves them zero); launches that share the counters
// must be ordered.  Returns the cudaError_t of the launch (0 on success); it
// does not synchronise.
extern "C" int prt_fused_decode_attention(const void* q, const void* k, const void* v,
                                          const void* ks, const void* vs, void* out,
                                          void* ws_acc, void* ws_ml, void* counters, int BH,
                                          int H, long long q_sb, long long q_sh, int T_len, int d,
                                          int n_live, int dtype, int q8, float scale,
                                          int n_splits, int rps, void* stream) {
  if (BH <= 0 || H <= 0 || BH % H != 0 || n_live <= 0 || n_live > T_len || n_splits <= 0 ||
      rps <= 0 || rps % kGroup != 0 || static_cast<long long>(n_splits - 1) * rps >= n_live ||
      static_cast<long long>(n_splits) * rps < n_live ||
      (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs), out,
               static_cast<float*>(ws_acc), static_cast<float2*>(ws_ml),
               static_cast<int*>(counters), BH, H, q_sb, q_sh, T_len, n_live, n_splits, rps,
               scale, static_cast<cudaStream_t>(stream)};
  if (q8) {
    if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
    if (dtype == 0) return launch_d<float, int8_t>(d, a);
    if (dtype == 1) return launch_d<__nv_bfloat16, int8_t>(d, a);
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch_d<float, float>(d, a);
  if (dtype == 1) return launch_d<__nv_bfloat16, __nv_bfloat16>(d, a);
  return cudaErrorInvalidValue;
}

extern "C" const char* prt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
