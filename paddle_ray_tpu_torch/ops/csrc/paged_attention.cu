// Ragged paged attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernels `paddle_ray_tpu/ops/paged_attention.py:_kernel`
// and `_kernel_q8` (with their helpers `_online`, `_masked_logits` and
// `_finish`): ragged per-slot query chunks attend that slot's pages of a
// paged KV pool, causal within the chunk at absolute position
// `lengths - q_lens + i`, with GQA (h_q = G * h_kv).  Masked terms weigh
// exactly 0, dead slots and pad rows give 0, and a row whose softmax
// denominator is 0 emits 0.
//
// Layouts (all contiguous):
//   q      [B, C, h_q, d]         pre-scaled by the wrapper, in q's dtype
//   k, v   [N, page, h_kv, d]     one layer of the pool; page 0 is the null page;
//                                 q's dtype (`_kernel`), or int8 (`_kernel_q8`) with
//   ks, vs [N, page, h_kv] f32    per-(token, head) scales: the K scale folds
//                                 into the logit after the dot, the V scale into
//                                 the accumulation weight only (the softmax
//                                 denominator sums the plain exponentials)
//   table  [B, P] int32           physical page per logical block
//   lengths, q_lens [B] int32
//   out    [B, C, h_q, d]         q's dtype
// d is 64, 80, 96 or 128; pages of 32, 64 or 128 rows.
//
// One design for both pools (`paged_kernel<T, KV, D, PAGE>`, KV the pool's
// element: int8, or q's own type T):
//   * split-K over pages (flash-decoding): one block per (split, tile of 16
//     pairs, slot and kv head); the wrapper picks the number of splits and the
//     pages of each from the lengths it is given on the host (else the table's
//     width) and the SM count, and a slot's own length on the device decides
//     which of its splits have pages (a tile stops at the last key its last
//     live row sees; no page past it is read; the last split takes any pages
//     past the plan's, so a plan from stale lengths costs balance, not keys).  With one split the
//     block writes the output; with several each writes its (m, l, acc) to a
//     workspace and the last block of the tile to finish -- found by an atomic
//     counter it resets -- merges them by the log-sum-exp rule, so a call stays
//     one launch.  A split whose keys are all masked carries l = 0 and weighs 0;
//   * 4 warps split the keys, not the rows: each takes every fourth chunk of the
//     split's pages, so at decode no warp idles, and the warps' parts are merged
//     the same way in shared memory.  A chunk is 64 keys of int8 or 32 of a wider
//     type (at most a page): 8 KB of K and V at D 64 either way;
//   * each warp streams its chunks through its own ring: K and V rows by 16-byte
//     `cp.async` (rows padded by 16 bytes, so the lane-per-key reads and the
//     tensor-core fragments are free of bank conflicts), an int8 pool's f32
//     scales by 4-byte ones, the next chunk in flight while this one is computed.
//     Two stages, or one where two would pass the 227 KB a block may hold
//     (float32 at D 128).  int8 is widened in registers by a byte permute under
//     2^23 and one subtraction (exact, off the 16-a-clock conversion unit), bf16
//     by a shift;
//   * a tile with more than `kTcMinPairs*` live pairs and bf16 q runs both
//     products on the tensor cores (`mma.sync` m16n8k16, bf16 in, f32 out; int8 is
//     exact in bf16): S = Q K^T, then the K scale, the mask and the online softmax
//     in f32 registers, then O += P V with P (times the V scale) rounded to bf16
//     as the A operand.  A bf16 pool's K rows are the B operand as they lie; its
//     V reaches the product by `ldmatrix.trans`.  An int8 pool's keys are
//     permuted inside each step of 16 so that a lane's V operand is four 32-bit
//     words transposed byte-wise.  Other tiles (decode rows, float32 q) run on
//     the CUDA cores: a lane per key for the logits, a lane per pair of dims for
//     the weighted sum, weights through shared memory.
//   The logits live in the exp2 domain (the K scale times log2 e); the result
//   is the natural-exp one up to rounding.
//
// What bounds it on the H100: decode (one row per slot) is bound by bytes --
// every live K and V page is read once, 2 * len * h_kv * d * sizeof(KV) per
// slot (int8: d + 4 bytes per row and head), against 3.35 TB/s.  The 128-row
// prefill chunks are bound by operations: 4 * C * len * h * d FLOPs against the
// tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;             // (row, group member) pairs of a tile: one m16 tile
constexpr int kMaxSmem = 232448;      // a block's shared memory on the H100
constexpr float kNeg = -1e30f;        // the TPU kernel's _NEG
constexpr float kLog2e = 1.4426950408889634f;
// bf16 tiles with more live pairs than this run on the tensor cores, the rest
// on the CUDA cores: the faster side at each count, as
// tools/torch_paged_splits.py measures it, per pool kind: over an int8 pool
// decode rows without GQA or with GQA 2 on the CUDA cores, over a bf16 pool
// (which needs no widening) only tiles of one pair
constexpr int kTcMinPairsQ8 = 2;
constexpr int kTcMinPairsBf16 = 1;
static_assert(kTcMinPairsQ8 <= 4 && kTcMinPairsBf16 <= 4,
              "bf16 tiles reach the CUDA cores with 4 pairs at most");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// int8 -> f32 exactly, without the conversion unit (16 a clock on the H100): the
// byte b ^ 0x80 = b + 128 under the exponent of 2^23 is 2^23 + b + 128, minus
// 2^23 + 128.  u holds four int8 already XOR 0x80.
template <int I>
__device__ __forceinline__ float i8_to_f32(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | I)) - 8388736.f;
}
// two f32 exact in bf16 (integers of at most 8 bits) as bf16x2, by truncation
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A pool element type in shared memory: 16 bytes widened to f32, two
// neighbouring values as f32, and (bf16-exact types) two as an mma bf16x2.
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
  __device__ __forceinline__ static float2 pair(const uint8_t* p) {
    const uint32_t u = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    return make_float2(i8_to_f32<0>(u), i8_to_f32<1>(u));
  }
  __device__ __forceinline__ static uint32_t bf16x2(const uint8_t* p) {
    const uint32_t u = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    return pack_exact(i8_to_f32<0>(u), i8_to_f32<1>(u));
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
  __device__ __forceinline__ static float2 pair(const uint8_t* p) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
  __device__ __forceinline__ static uint32_t bf16x2(const uint8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
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
  __device__ __forceinline__ static float2 pair(const uint8_t* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <typename KV, int D, int PAGE>
struct Cfg {
  static constexpr bool kQ8 = std::is_same<KV, int8_t>::value;
  static constexpr int kES = sizeof(KV);
  static constexpr int kChunk = kQ8 ? 64 : 32;                // the wrapper's chunk_keys
  static constexpr int kKC = PAGE < kChunk ? PAGE : kChunk;   // keys of a streamed chunk
  static constexpr int kCPP = PAGE / kKC;                     // chunks a page
  static constexpr int kRS = D * kES + 16;                    // a K / V row in shared memory, bytes
  static constexpr int kVals = kKC * kRS;                     // one K or V chunk, bytes
  static constexpr int kStage = 2 * kVals + (kQ8 ? 2 * kKC * 4 : 0);  // K, V (and their scales)
  static constexpr size_t kRest =
      sizeof(float) * (kRows * D + kWarps * kRows * kKC) + sizeof(int) * (kRows + 4);
  // each warp's ring: two stages where they fit, else one (3 or 4 stages, or 8
  // warps, measured no faster over either pool)
  static constexpr int kStages = kWarps * 2 * kStage + kRest <= kMaxSmem ? 2 : 1;
  static constexpr int kRing = kWarps * kStages * kStage;
  static constexpr int kGroups = (D + 31) / 32;               // 32-dim groups of int8 P V's mma
  static constexpr int kLanePairs = (D + 63) / 64;            // dim pairs a lane owns (CUDA cores)
  static constexpr size_t kRed = sizeof(float) * kWarps * kRows * (D + 2);
  static_assert(kRed <= kRing, "the block merge reuses the ring");
  static constexpr size_t kSmem = kRing + kRest;
  static_assert(kSmem <= kMaxSmem, "a block's shared memory");
  static_assert(D * kES % 16 == 0 && D % 16 == 0, "16-byte rows, 16-dim mma steps");
};

// mma.sync m16n8k16, bf16 inputs, f32 accumulators in place
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices transposed: lanes 8 m .. 8 m + 7 give matrix m's rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// One block per (split of the slot's pages, tile of 16 (row, member) pairs, slot
// and kv head); see the file's header for the design.
template <typename T, typename KV, int D, int PAGE>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, const KV* __restrict__ kpool,
             const KV* __restrict__ vpool, const float* __restrict__ kscale,
             const float* __restrict__ vscale, const int* __restrict__ table,
             const int* __restrict__ lengths, const int* __restrict__ q_lens,
             T* __restrict__ out, float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
             int* __restrict__ counters, int C, int h_q, int h_kv, int P, int pps) {
  using Cf = Cfg<KV, D, PAGE>;
  using E = Elt<KV>;
  constexpr bool kQ8 = Cf::kQ8;
  constexpr int ES = Cf::kES;
  constexpr int KC = Cf::kKC;
  constexpr int RS = Cf::kRS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw;
  float* q_s = reinterpret_cast<float*>(smem + Cf::kRing);   // [16][D], CUDA-core tiles
  float* p_s = q_s + kRows * D;                              // [warp][16][KC]
  int* pos_s = reinterpret_cast<int*>(p_s + kWarps * kRows * KC);  // [16]
  int* flag = pos_s + kRows;

  const int split = blockIdx.x, n_splits = gridDim.x, tile = blockIdx.y;
  const int b = blockIdx.z / h_kv, hk = blockIdx.z % h_kv;
  const int group = h_q / h_kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ln = lengths[b];
  const int ql = min(q_lens[b], C);
  const int pair0 = tile * kRows;
  const int here = min(kRows, C * group - pair0);    // pairs of the tile, live or pad
  const int live = ln > 0 && ql > 0 ? max(0, min(kRows, ql * group - pair0)) : 0;
  int n_pages = 0;  // the tile's pages: up to the last key its last live row sees
  if (live > 0) {
    const int last_pos = ln - ql + (pair0 + live - 1) / group;
    n_pages = last_pos < 0 ? 0 : min(last_pos / PAGE + 1, P);
  }
  // splits with pages; the last one takes any pages past n_splits * pps
  const int n_live = min((n_pages + pps - 1) / pps, n_splits);
  const size_t unit = static_cast<size_t>(blockIdx.z) * gridDim.y + tile;
  auto row_off = [&](int r) {  // q / out offset of the tile's pair r
    const int pi = pair0 + r;
    return ((static_cast<size_t>(b) * C + pi / group) * h_q + hk * group + pi % group) * D;
  };
  if (split >= n_live) {
    if (split == 0)  // a dead slot, pad rows only, or no key in sight: zeros
      for (int i = threadIdx.x; i < here * D; i += kThreads) store(out + row_off(i / D) + i % D, 0.f);
    return;
  }
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    pos_s[r] = r < live ? ln - ql + (pair0 + r) / group : -1;
  }

  // this warp's chunks: c_begin + warp, + kWarps, ... of the split's pages
  const int c_begin = split * pps * Cf::kCPP;
  const int c_end = (split == n_live - 1 ? n_pages : (split + 1) * pps) * Cf::kCPP;
  const int n_my = c_end - c_begin > warp ? (c_end - c_begin - warp + kWarps - 1) / kWarps : 0;
  auto stage = [&](int st) { return smem + (warp * Cf::kStages + st) * Cf::kStage; };
  // the page ids of the warp's chunks, 32 at a time, a lane each: no table read
  // waits in front of a chunk's loads
  int pid_group = -1, pid_lane = 0;
  auto page_id = [&](int i) {  // i: the warp's chunk, the same in every lane
    if (i / 32 != pid_group) {
      pid_group = i / 32;
      const int j = 32 * pid_group + lane;
      pid_lane = j < n_my ? table[static_cast<size_t>(b) * P + (c_begin + warp + kWarps * j) / Cf::kCPP]
                          : 0;
    }
    return __shfl_sync(0xffffffffu, pid_lane, i % 32);
  };
  auto issue = [&](int i, int st) {
    const int c = c_begin + warp + kWarps * i;
    uint8_t* k_s = stage(st);
    uint8_t* v_s = k_s + Cf::kVals;
    const int pid = page_id(i);
    const size_t tok0 = static_cast<size_t>(pid) * PAGE + (c % Cf::kCPP) * KC;
    const size_t stride = static_cast<size_t>(h_kv) * D * ES;  // bytes between tokens
    const uint8_t* kp = reinterpret_cast<const uint8_t*>(kpool + (tok0 * h_kv + hk) * D);
    const uint8_t* vp = reinterpret_cast<const uint8_t*>(vpool + (tok0 * h_kv + hk) * D);
    constexpr int kPieces = D * ES / 16;
    for (int j = lane; j < KC * kPieces; j += 32) {
      const int t = j / kPieces, x = 16 * (j % kPieces);
      cp16(k_s + t * RS + x, kp + t * stride + x);
      cp16(v_s + t * RS + x, vp + t * stride + x);
    }
    if constexpr (kQ8) {
      float* ks_s = reinterpret_cast<float*>(v_s + Cf::kVals);
      for (int t = lane; t < KC; t += 32) {
        const size_t si = (tok0 + t) * h_kv + hk;
        cp4(ks_s + t, kscale + si);
        cp4(ks_s + KC + t, vscale + si);
      }
    }
  };
  // the warp's chunks through its ring: the loads of chunk i + 1 fly while chunk i
  // is computed (with two stages); then every warp's copies are done and the
  // ring may be reused
  auto stream = [&](auto&& compute) {
#pragma unroll
    for (int i = 0; i < Cf::kStages - 1; ++i) {
      if (i < n_my) issue(i, i);
      cp_commit();
    }
    for (int i = 0; i < n_my; ++i) {
      if (i + Cf::kStages - 1 < n_my) issue(i + Cf::kStages - 1, (i + Cf::kStages - 1) % Cf::kStages);
      cp_commit();
      cp_wait<Cf::kStages - 1>();
      __syncwarp();
      compute(stage(i % Cf::kStages), (c_begin + warp + kWarps * i) * KC);
      __syncwarp();
    }
    cp_wait<0>();
    __syncthreads();
  };
  // an int8 pool's scales of the chunk at k_s: K's, then V's
  auto kscales = [&](const uint8_t* k_s) {
    return reinterpret_cast<const float*>(k_s + 2 * Cf::kVals);
  };
  // the block merge's inputs, over the ring: each warp's m, l and acc per pair
  float* red_acc = reinterpret_cast<float*>(smem);          // [warp][16][D]
  float* red_m = red_acc + kWarps * kRows * D;              // [warp][16]
  float* red_l = red_m + kWarps * kRows;

  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kTcMin = kQ8 ? kTcMinPairsQ8 : kTcMinPairsBf16;
  bool done = false;
  if constexpr (kBf16) {
    if (live > kTcMin) {
      // tensor cores: S = Q K^T and O += P V as mma.sync m16n8k16 (bf16 in, f32
      // out).  An int8 pool's keys are permuted inside each 16 so that a lane's
      // four V bytes of one dim come from one 32-bit word of each of four rows (a
      // byte transpose in registers): logical key k of a 16-key step is key
      // 4 (k % 8 / 2) + 2 (k / 8) + k % 2.  A bf16 pool keeps the keys in order.
      __syncthreads();
      const int g = lane / 4, a = lane % 4;
      uint32_t qa[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = g + 8 * i;
          const T* qr = q + row_off(r) + 16 * kk + 2 * a;
          qa[kk][i] = r < live ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
          qa[kk][2 + i] = r < live ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
        }
      // the accumulators: int8, [32-dim group][n-tile c][4] with column g of
      // n-tile c dim 32 x + 4 g + c; bf16, [n-tile][4] with column g dim 8 n + g
      constexpr int kTiles = kQ8 ? 4 * Cf::kGroups : D / 8;
      float o[kTiles][4];
#pragma unroll
      for (int x = 0; x < kTiles; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[x][e] = 0.f;
      float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
      const int pos[2] = {pos_s[g], pos_s[g + 8]};
      // the chunk's key of n-tile j's column c (a lane's B operand: c = g; its
      // accumulators: c = 2 a + e)
      auto key = [](int j, int c) {
        return kQ8 ? 16 * (j / 2) + 4 * (c / 2) + 2 * (j % 2) + c % 2 : 8 * j + c;
      };
      stream([&](const uint8_t* k_s, int kb) {
        const uint8_t* v_s = k_s + Cf::kVals;
        const float* ks_s = kscales(k_s);
        const float* vs_s = ks_s + KC;
        float sc[KC / 8][4];
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
          const uint8_t* kr = k_s + key(j, g) * RS + 2 * a * ES;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            mma_bf16(sc[j], qa[kk], E::bf16x2(kr + 16 * kk * ES), E::bf16x2(kr + (16 * kk + 8) * ES));
        }
        // the K scale folds into the logit (exp2 domain), then the causal mask; the
        // online softmax of rows g and g + 8 over the four lanes of a quad
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = kNeg;
#pragma unroll
          for (int j = 0; j < KC / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kl = key(j, 2 * a + e);
              float& x = sc[j][2 * i + e];
              x = kb + kl <= pos[i] ? x * (kQ8 ? ks_s[kl] * kLog2e : kLog2e) : kNeg;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = exp2f(m[i] - m_new);
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < KC / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kl = key(j, 2 * a + e);
              float& x = sc[j][2 * i + e];
              const float p = kb + kl <= pos[i] ? exp2f(x - m_new) : 0.f;
              ps += p;
              x = kQ8 ? p * vs_s[kl] : p;  // the V scale weighs the accumulation only
            }
          ps += __shfl_xor_sync(0xffffffffu, ps, 1);
          ps += __shfl_xor_sync(0xffffffffu, ps, 2);
          l[i] = l[i] * alpha + ps;
          m[i] = m_new;
#pragma unroll
          for (int x = 0; x < kTiles; ++x) {
            o[x][2 * i] *= alpha;
            o[x][2 * i + 1] *= alpha;
          }
        }
        // O += P V: P (times the V scale) rounded to bf16 as the A operand
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                  pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                  pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                  pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
          if constexpr (kQ8) {
            // V's B operand from four 32-bit words (rows 4a .. 4a + 3 of the
            // 16-key step, dims 4g .. 4g + 3 of the 32-dim group) transposed
            // byte-wise
#pragma unroll
            for (int x = 0; x < Cf::kGroups; ++x) {
              const uint8_t* vr = v_s + (16 * kk + 4 * a) * RS + 32 * x + 4 * g;
              const uint32_t w0 = *reinterpret_cast<const uint32_t*>(vr);
              const uint32_t w1 = *reinterpret_cast<const uint32_t*>(vr + RS);
              const uint32_t w2 = *reinterpret_cast<const uint32_t*>(vr + 2 * RS);
              const uint32_t w3 = *reinterpret_cast<const uint32_t*>(vr + 3 * RS);
              const uint32_t x01 = __byte_perm(w0, w1, 0x5140), x23 = __byte_perm(w2, w3, 0x5140);
              const uint32_t y01 = __byte_perm(w0, w1, 0x7362), y23 = __byte_perm(w2, w3, 0x7362);
              const uint32_t t[4] = {__byte_perm(x01, x23, 0x5410), __byte_perm(x01, x23, 0x7632),
                                     __byte_perm(y01, y23, 0x5410), __byte_perm(y01, y23, 0x7632)};
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const uint32_t u = t[c] ^ 0x80808080u;
                mma_bf16(o[4 * x + c], pa, pack_exact(i8_to_f32<0>(u), i8_to_f32<1>(u)),
                         pack_exact(i8_to_f32<2>(u), i8_to_f32<3>(u)));
              }
            }
          } else {
            // V's B operand by ldmatrix.trans: matrices (keys 0-7 | 8-15 of the
            // step) x (dims 16 n .. + 7 | 16 n + 8 .. + 15)
            const int vrow = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
            for (int n = 0; n < D / 16; ++n) {
              uint32_t r[4];
              ldmatrix_x4_trans(r, v_s + vrow * RS + (16 * n + 8 * (lane >> 4)) * 2);
              mma_bf16(o[2 * n], pa, r[0], r[1]);
              mma_bf16(o[2 * n + 1], pa, r[2], r[3]);
            }
          }
        }
      });
      // rows g + 8 i: int8 dims 32 x + 8 a + 4 e + c, bf16 dims 8 n + 2 a + e
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = g + 8 * i;
        float* dst = red_acc + (warp * kRows + r) * D;
#pragma unroll
        for (int x = 0; x < kTiles; ++x)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = kQ8 ? 32 * (x / 4) + 8 * a + 4 * e + x % 4 : 8 * x + 2 * a + e;
            if (d < D) dst[d] = o[x][2 * i + e];
          }
        if (a == 0) {
          red_m[warp * kRows + r] = m[i];
          red_l[warp * kRows + r] = l[i];
        }
      }
      done = true;
    }
  }
  // CUDA cores: logits with a lane per key, the weighted sum with a lane per
  // pair of dims; NR rows (the live pairs rounded up to a power of two: a row
  // past them has q = 0 and sees no key, so it weighs nothing)
  auto cuda_cores = [&](auto nr_tag) {
    constexpr int NR = decltype(nr_tag)::value;
    for (int i = threadIdx.x; i < NR * D; i += kThreads) {
      const int r = i / D;
      q_s[i] = r < live ? to_f32(q[row_off(r) + i % D]) : 0.f;
    }
    __syncthreads();
    constexpr int kKL = KC / 32;
    constexpr int kDP = 2 * Cf::kLanePairs;
    float* p_w = p_s + warp * kRows * KC;
    float m[NR], l[NR], acc[NR][kDP];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      m[r] = kNeg;
      l[r] = 0.f;
#pragma unroll
      for (int j = 0; j < kDP; ++j) acc[r][j] = 0.f;
    }
    stream([&](const uint8_t* k_s, int kb) {
      const uint8_t* v_s = k_s + Cf::kVals;
      float s[NR][kKL];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int u = 0; u < kKL; ++u) s[r][u] = 0.f;
#pragma unroll
      for (int u = 0; u < kKL; ++u) {
        const uint8_t* kr = k_s + (lane + 32 * u) * RS;
#pragma unroll
        for (int x = 0; x < D / E::kN; ++x) {
          float f[E::kN];
          E::widen(*reinterpret_cast<const uint4*>(kr + 16 * x), f);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float4* qv = reinterpret_cast<const float4*>(q_s + r * D + E::kN * x);
            float acc_s = s[r][u];
#pragma unroll
            for (int h = 0; h < E::kN / 4; ++h) {
              const float4 qq = qv[h];
              acc_s = fmaf(qq.x, f[4 * h], acc_s);
              acc_s = fmaf(qq.y, f[4 * h + 1], acc_s);
              acc_s = fmaf(qq.z, f[4 * h + 2], acc_s);
              acc_s = fmaf(qq.w, f[4 * h + 3], acc_s);
            }
            s[r][u] = acc_s;
          }
        }
      }
      float kf[kKL], vf[kKL];
#pragma unroll
      for (int u = 0; u < kKL; ++u) {
        kf[u] = kQ8 ? kscales(k_s)[lane + 32 * u] * kLog2e : kLog2e;
        vf[u] = kQ8 ? kscales(k_s)[KC + lane + 32 * u] : 1.f;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int pos = pos_s[r];
        float mx = kNeg;
#pragma unroll
        for (int u = 0; u < kKL; ++u) {
          s[r][u] = kb + lane + 32 * u <= pos ? s[r][u] * kf[u] : kNeg;
          mx = fmaxf(mx, s[r][u]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = exp2f(m[r] - m_new);
        float es = 0.f;
#pragma unroll
        for (int u = 0; u < kKL; ++u) {
          const float e = kb + lane + 32 * u <= pos ? exp2f(s[r][u] - m_new) : 0.f;
          es += e;
          // the V scale weighs the accumulation only
          p_w[r * KC + lane + 32 * u] = kQ8 ? e * vf[u] : e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) es += __shfl_xor_sync(0xffffffffu, es, o);
        l[r] = l[r] * alpha + es;
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < kDP; ++j) acc[r][j] *= alpha;
      }
      __syncwarp();
#pragma unroll 2
      for (int t = 0; t < KC; t += 4) {
        float vv[4][kDP];
#pragma unroll
        for (int tt = 0; tt < 4; ++tt)
#pragma unroll
          for (int j = 0; j < Cf::kLanePairs; ++j) {
            const int d = 2 * (lane + 32 * j);
            const float2 x = d < D ? E::pair(v_s + (t + tt) * RS + d * ES) : make_float2(0.f, 0.f);
            vv[tt][2 * j] = x.x;
            vv[tt][2 * j + 1] = x.y;
          }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_w + r * KC + t);
#pragma unroll
          for (int j = 0; j < kDP; ++j)
            acc[r][j] = fmaf(p4.w, vv[3][j],
                             fmaf(p4.z, vv[2][j], fmaf(p4.y, vv[1][j], fmaf(p4.x, vv[0][j], acc[r][j]))));
        }
      }
    });
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float* dst = red_acc + (warp * kRows + r) * D;
#pragma unroll
      for (int j = 0; j < Cf::kLanePairs; ++j) {
        const int d = 2 * (lane + 32 * j);
        if (d < D) {
          dst[d] = acc[r][2 * j];
          dst[d + 1] = acc[r][2 * j + 1];
        }
      }
      if (lane == 0) {
        red_m[warp * kRows + r] = m[r];
        red_l[warp * kRows + r] = l[r];
      }
    }
  };
  if (!done) {
    if (live <= 1) {
      cuda_cores(std::integral_constant<int, 1>());
    } else if (live <= 2) {
      cuda_cores(std::integral_constant<int, 2>());
    } else if (kBf16 || live <= 4) {
      cuda_cores(std::integral_constant<int, 4>());
    } else if constexpr (!kBf16) {
      if (live <= 8)
        cuda_cores(std::integral_constant<int, 8>());
      else
        cuda_cores(std::integral_constant<int, 16>());
    }
  }
  __syncthreads();

  // the warps' parts merged by the log-sum-exp rule (a part with no key in sight
  // has l = 0 and weighs 0); one split writes the output, several write their
  // parts and the last block of the tile to finish merges them
  const size_t part = unit * n_splits + split;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (r >= here) break;
    if (r >= live) {
      if (n_live == 1) store(out + row_off(r) + d, 0.f);  // a pad row
      continue;
    }
    float M = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_m[w * kRows + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(red_m[w * kRows + r] - M);
      L += red_l[w * kRows + r] * f;
      A += red_acc[(w * kRows + r) * D + d] * f;
    }
    if (n_live == 1) {
      store(out + row_off(r) + d, L == 0.f ? 0.f : A / L);
    } else {
      ws_acc[(part * kRows + r) * D + d] = A;
      if (d == 0) ws_ml[part * kRows + r] = make_float2(M, L);
    }
  }
  if (n_live == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(&counters[unit], 1) == n_live - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  for (int i = threadIdx.x; i < here * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (r >= live) {
      store(out + row_off(r) + d, 0.f);
      continue;
    }
    const size_t first = unit * n_splits;
    float M = kNeg;
    for (int s2 = 0; s2 < n_live; ++s2) M = fmaxf(M, __ldcg(&ws_ml[(first + s2) * kRows + r]).x);
    float L = 0.f, A = 0.f;
    for (int s2 = 0; s2 < n_live; ++s2) {
      const float2 ml = __ldcg(&ws_ml[(first + s2) * kRows + r]);
      const float f = exp2f(ml.x - M);
      L += ml.y * f;
      A += __ldcg(&ws_acc[((first + s2) * kRows + r) * D + d]) * f;
    }
    store(out + row_off(r) + d, L == 0.f ? 0.f : A / L);
  }
  if (threadIdx.x == 0) counters[unit] = 0;  // ready for the next launch
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *table, *lengths, *q_lens;
  void* out;
  float* ws_acc;
  float2* ws_ml;
  int* counters;
  int B, C, h_q, h_kv, P, n_splits, pps;
  cudaStream_t stream;
};

template <typename T, typename KV, int D, int PAGE>
cudaError_t launch(const Args& a) {
  using Cf = Cfg<KV, D, PAGE>;
  auto kern = paged_kernel<T, KV, D, PAGE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Cf::kSmem));
  if (err != cudaSuccess) return err;
  const int tiles = (a.C * (a.h_q / a.h_kv) + kRows - 1) / kRows;
  if (tiles > 65535 || a.B * a.h_kv > 65535) return cudaErrorInvalidValue;
  dim3 grid(a.n_splits, tiles, a.B * a.h_kv);
  kern<<<grid, kThreads, Cf::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v), a.ks,
      a.vs, a.table, a.lengths, a.q_lens, static_cast<T*>(a.out), a.ws_acc, a.ws_ml, a.counters,
      a.C, a.h_q, a.h_kv, a.P, a.pps);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t by_page(int page, const Args& a) {
  switch (page) {
    case 32: return launch<T, KV, D, 32>(a);
    case 64: return launch<T, KV, D, 64>(a);
    case 128: return launch<T, KV, D, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
cudaError_t by_dim(int d, int page, const Args& a) {
  switch (d) {
    case 64: return by_page<T, KV, 64>(page, a);
    case 80: return by_page<T, KV, 80>(page, a);
    case 96: return by_page<T, KV, 96>(page, a);
    case 128: return by_page<T, KV, 128>(page, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry bound with ctypes.  dtype: 0 = float32, 1 = bfloat16 (q and out).
// kv_int8: 0 = a pool in q's dtype (ks, vs unused), 1 = an int8 pool with its
// f32 scales.  The split plan: n_splits splits of pps pages; with more than one
// split, a workspace of f32 [units, n_splits, 16, d] and float2 [units,
// n_splits, 16] partials and int32 [units] counters, zero before the first
// launch (the kernel leaves them zero), units = B * h_kv * ceil(C * h_q / h_kv
// / 16).  Launches that share the counters must be ordered (one stream; the
// wrapper keeps a buffer per stream).  Returns the cudaError_t of the launch
// (0 on success); it does not synchronise.
extern "C" int prt_paged_ragged_attention(const void* q, const void* k, const void* ks,
                                          const void* v, const void* vs, const void* table,
                                          const void* lengths, const void* q_lens, void* out,
                                          void* ws_acc, void* ws_ml, void* counters, int B,
                                          int C, int h_q, int h_kv, int d, int page, int P,
                                          int dtype, int kv_int8, int n_splits, int pps,
                                          void* stream) {
  if (B <= 0 || C <= 0 || h_kv <= 0 || h_q % h_kv != 0 || P <= 0 || n_splits <= 0 || pps <= 0 ||
      (kv_int8 && (ks == nullptr || vs == nullptr)) ||
      (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
               static_cast<const int*>(table), static_cast<const int*>(lengths),
               static_cast<const int*>(q_lens), out, static_cast<float*>(ws_acc),
               static_cast<float2*>(ws_ml), static_cast<int*>(counters), B, C, h_q, h_kv, P,
               n_splits, pps, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return kv_int8 ? by_dim<float, int8_t>(d, page, a) : by_dim<float, float>(d, page, a);
  if (dtype == 1)
    return kv_int8 ? by_dim<__nv_bfloat16, int8_t>(d, page, a)
                   : by_dim<__nv_bfloat16, __nv_bfloat16>(d, page, a);
  return cudaErrorInvalidValue;
}

extern "C" const char* prt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
