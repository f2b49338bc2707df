// Flash attention forward and backward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces three TPU kernels of `paddle_ray_tpu/ops/flash_attention.py`:
//   flash_fwd_kernel     <- _fwd_kernel      (online softmax, o and natural-log lse)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel   (dq recomputed from lse and delta)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (dk, dv summed over the q-head group)
// Same arithmetic: q arrives pre-scaled by scale * log2(e) in its own dtype, every
// kernel works in the exp2 domain, masked logits are -1e30 before the max, the causal
// mask is top-left aligned (row >= col), l is clamped to 1e-30, lse = (m + log2 l) ln 2,
// dq = (sum ds k) * scale and dk = (sum ds^T q_prescaled) * ln 2.
//
// Optional, in all three kernels, in the JAX order (`_mask_block`): an additive f32
// bias read through explicit strides for (batch, head, q row, key), so a broadcast
// bias (a [B, 1, 1, Skv] padding mask as -1e30) is read in place and never
// materialised as [B*H, S, Skv]; it is added as bias * log2(e) (a rounded product,
// as JAX computes it); then the causal mask, then int32 q / kv segment ids (unequal
// ids mask), each setting the logit to -1e30.  With a bias or segment ids, masked
// logits take part in the max and in exp2 as JAX's do, so a row whose every key is
// masked by segment ids gets uniform weights over its -1e30 logits (not NaN, not
// zeros), and one masked by a -1e30 bias gets zeros, as in JAX; only keys past Skv
// (a ragged last tile) weigh exactly 0.  Without them a separate instantiation
// drops causally masked keys and pays no per-logit lookup (see has_extras).  lse * log2(e) is a rounded product too (__fmul_rn: no FMA may fold it
// into the subtraction), which keeps a fully masked row's exp2(s - lse2) at 1.
// The dq kernel also writes dbias = ds [B*H, S, Skv] f32 when asked (zeros in the
// tiles a causal row never visits); the wrapper sums it back to the bias's shape.
//
// Layouts, all contiguous but the bias, heads folded into the leading dim (b * H + h):
//   q, o, do, dq [BH, S, D]      k, v, dk, dv [BHkv, Skv, D], BH = BHkv * group
//   lse, delta   [BH, S] float32
//   bias         f32 at bias[b * sb + h * sh + row * sq + key * sk] (any strides, 0 too)
//   segq, segk   [B, S], [B, Skv] int32      dbias [BH, S, Skv] float32
// q head bh reads kv head bh / group (GQA, no replication in memory); its batch is
// bh / H.
//
// Design (simple first):
//   * tiles of 64 q rows by 64 keys; 256 threads as a 16 x 16 grid, each thread
//     owning a 4 x 4 piece of the 64 x 64 score tile (rows ty*4+r, keys tx+16*j) and
//     the matching rows of the output tile (columns tx+16*j); the 16 threads of one
//     row group are one half-warp, so row max and sum are half-warp shuffles;
//   * tiles are staged in shared memory widened to f32, rows padded by one word so
//     the row and column walks are free of bank conflicts; probabilities go through
//     shared memory between the two products;
//   * forward and dq: one block per (q head, q tile), looping over key tiles up to
//     the causal limit hi = min(ceil((qi+1) * 64 / 64), nk) -- the loop that
//     replaces the TPU's sequential grid axis;
//   * dk/dv: one block per (kv head, key tile), looping over the group's q heads
//     and the q tiles i >= ki (causal), accumulating dk and dv in registers: no
//     atomics, so the result is deterministic;
//   * a ragged last tile (S or Skv not a multiple of 64) is masked, not refused.
//
// What bounds it on the H100: at the training shape (S 1024, D 64, bf16, causal)
// each kernel does 2, 3 and 4 [S, D] x [D, S] products over the causal half, which
// against the bf16 tensor cores (989 TFLOP/s) is about the same time as moving its
// inputs and outputs once (3.35 TB/s): forward bound by bytes, the two backward
// kernels by operations.  This design reaches neither: the products run on the f32
// CUDA cores (67 TFLOP/s peak) from shared memory, loads are synchronous and every
// tile waits for a block-wide barrier.  Left for later: mma/wgmma on bf16 tiles
// with f32 accumulation, TMA + mbarrier double buffering of the K/V (or Q/dO) tiles,
// and a persistent schedule that balances the causal triangle across SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;                 // q rows and keys per tile
constexpr int kThreads = 256;              // 16 x 16
constexpr int kPS = kTile + 1;             // padded row of a 64 x 64 f32 tile
constexpr float kNeg = -1e30f;             // the TPU kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// max / sum over the 16 lanes of a half-warp
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + 64) of a [n_rows, D] matrix into shared memory as f32 with row
// stride LD; rows past n_rows are zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int n_rows) {
  constexpr int kVN = Vec16<T>::kN;
  constexpr int kChunks = D / kVN;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVN;
    float f[kVN];
    if (row0 + r < n_rows) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
      Vec16<T>::widen(u, f);
    } else {
#pragma unroll
      for (int e = 0; e < kVN; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVN; ++e) dst[r * LD + c + e] = f[e];
  }
}

// s[r][j] += a[row(r)] . b[col(j)] over D, rows ty*4+r of `a`, rows tx+16j of `b`
// (both tiles with row stride D + 1).
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty * 4 + r) * LD + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = fmaf(av[r], bv[j], s[r][j]);
  }
}

// acc[r][j] += sum_k p[row(r)][k] * m[k][tx + 16j], p a 64 x 64 tile (stride kPS),
// m a 64 x D tile with row stride LD.
template <int D, int LD>
__device__ __forceinline__ void tile_pm(float (&acc)[4][D / 16], const float* p, const float* m,
                                        int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float pv[4], mv[D / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = p[(ty * 4 + r) * kPS + k];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) mv[j] = m[k * LD + tx + 16 * j];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[r][j] = fmaf(pv[r], mv[j], acc[r][j]);
  }
}

__device__ __forceinline__ int causal_hi(int qi, int nk) {
  // last key tile that holds a key visible to q tile qi, plus one
  return min((qi * kTile + kTile + kTile - 1) / kTile, nk);
}

// The optional bias and segment ids of a call.  `heads` is H, the q heads of a batch.
struct Extras {
  const float* bias;
  long long sb, sh, sq, sk;
  const int* segq;
  const int* segk;
  int heads;
};

// The logit of (q head bh, row, key) after the bias and the masks, in the JAX order:
// + bias * log2(e), then causal, then segment ids, each masking to -1e30.  Only for
// row < S and key < Skv.
__device__ __forceinline__ float adjust(float s, const Extras& ex, int bh, int row, int key, int S,
                                        int Skv, int causal) {
  const int b = bh / ex.heads;
  if (ex.bias != nullptr) {
    const float bv = ex.bias[b * ex.sb + (bh % ex.heads) * ex.sh + row * ex.sq + key * ex.sk];
    s = s + __fmul_rn(bv, kLog2e);
  }
  if (causal && row < key) s = kNeg;
  if (ex.segq != nullptr &&
      ex.segq[static_cast<size_t>(b) * S + row] != ex.segk[static_cast<size_t>(b) * Skv + key])
    s = kNeg;
  return s;
}

template <int D>
constexpr size_t fwd_smem() { return sizeof(float) * (2 * kTile * (D + 1) + kTile * D + kTile * kPS); }
template <int D>
constexpr size_t dq_smem() { return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPS); }
template <int D>
constexpr size_t dkv_smem() { return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile); }

// ---------------------------------------------------------------------------
// forward: one block per (q head bh, q tile qi)
// ---------------------------------------------------------------------------
template <typename T, int D, bool kExtras>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int Skv, int group,
                 int causal, Extras ex) {
  constexpr int LD = D + 1;
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [64][D + 1]
  float* k_s = q_s + kTile * LD;     // [64][D + 1]
  float* v_s = k_s + kTile * LD;     // [64][D]
  float* p_s = v_s + kTile * D;      // [64][65]

  const int bh = blockIdx.x, qi = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* kb = k + static_cast<size_t>(bh / group) * Skv * D;
  const T* vb = v + static_cast<size_t>(bh / group) * Skv * D;
  load_tile<T, D, LD>(q_s, q + static_cast<size_t>(bh) * S * D, qi * kTile, S);

  const int nk = (Skv + kTile - 1) / kTile;
  const int hi = causal ? causal_hi(qi, nk) : nk;
  float m[4], l[4], acc[4][kDJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[r][j] = 0.f;
  }

  for (int kt = 0; kt < hi; ++kt) {
    __syncthreads();  // the previous tiles are no longer read
    load_tile<T, D, LD>(k_s, kb, kt * kTile, Skv);
    load_tile<T, D, D>(v_s, vb, kt * kTile, Skv);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = qi * kTile + ty * 4 + r;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * kTile + tx + 16 * j;
        ok[j] = col < Skv && (kExtras || !causal || row >= col);
        if (!ok[j] || (kExtras && row >= S))
          s[r][j] = kNeg;
        else if (kExtras)  // a masked key still counts, at -1e30
          s[r][j] = adjust(s[r][j], ex, bh, row, col, S, Skv, causal);
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m[r], half_max(mx));
      const float alpha = exp2f(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? exp2f(s[r][j] - m_new) : 0.f;
        p_s[(ty * 4 + r) * kPS + tx + 16 * j] = p;
        psum += p;
      }
      l[r] = l[r] * alpha + half_sum(psum);
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[r][j] *= alpha;
      m[r] = m_new;
    }
    __syncwarp();  // a row of p_s is written and read by one half-warp
    tile_pm<D, D>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = qi * kTile + ty * 4 + r;
    if (row >= S) continue;
    const float ls = fmaxf(l[r], 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * S + row) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) store(orow + tx + 16 * j, acc[r][j] / ls);
    if (tx == 0) lse[static_cast<size_t>(bh) * S + row] = (m[r] + log2f(ls)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (q head bh, q tile qi)
// ---------------------------------------------------------------------------
template <typename T, int D, bool kExtras>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    float* __restrict__ dbias, int S, int Skv, int group, float scale,
                    int causal, Extras ex) {
  constexpr int LD = D + 1;
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [64][D + 1]
  float* do_s = q_s + kTile * LD;    // [64][D + 1]
  float* k_s = do_s + kTile * LD;    // [64][D + 1]
  float* v_s = k_s + kTile * LD;     // [64][D + 1]
  float* ds_s = v_s + kTile * LD;    // [64][65]

  const int bh = blockIdx.x, qi = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* kb = k + static_cast<size_t>(bh / group) * Skv * D;
  const T* vb = v + static_cast<size_t>(bh / group) * Skv * D;
  load_tile<T, D, LD>(q_s, q + static_cast<size_t>(bh) * S * D, qi * kTile, S);
  load_tile<T, D, LD>(do_s, dout + static_cast<size_t>(bh) * S * D, qi * kTile, S);
  float lse2[4], dl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = qi * kTile + ty * 4 + r;
    const size_t at = static_cast<size_t>(bh) * S + row;
    lse2[r] = row < S ? __fmul_rn(lse[at], kLog2e) : 0.f;
    dl[r] = row < S ? delta[at] : 0.f;
  }

  const int nk = (Skv + kTile - 1) / kTile;
  const int hi = causal ? causal_hi(qi, nk) : nk;
  float acc[4][kDJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[r][j] = 0.f;

  for (int kt = 0; kt < hi; ++kt) {
    __syncthreads();
    load_tile<T, D, LD>(k_s, kb, kt * kTile, Skv);
    load_tile<T, D, LD>(v_s, vb, kt * kTile, Skv);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, q_s, k_s, ty, tx);
    tile_dot<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = qi * kTile + ty * 4 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * kTile + tx + 16 * j;
        const bool ok = row < S && col < Skv && (kExtras || !causal || row >= col);
        const float sv =
            kExtras && ok ? adjust(s[r][j], ex, bh, row, col, S, Skv, causal) : s[r][j];
        const float p = ok ? exp2f(sv - lse2[r]) : 0.f;
        const float ds = p * (dp[r][j] - dl[r]);
        ds_s[(ty * 4 + r) * kPS + tx + 16 * j] = ds;
        if (dbias != nullptr && ok) dbias[(static_cast<size_t>(bh) * S + row) * Skv + col] = ds;
      }
    }
    __syncwarp();
    tile_pm<D, LD>(acc, ds_s, k_s, ty, tx);
  }
  if (dbias != nullptr) {
    // the key tiles a causal q tile never visits: ds is 0 there
    for (int kt = hi; kt < nk; ++kt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = qi * kTile + ty * 4 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = kt * kTile + tx + 16 * j;
          if (row < S && col < Skv) dbias[(static_cast<size_t>(bh) * S + row) * Skv + col] = 0.f;
        }
      }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = qi * kTile + ty * 4 + r;
    if (row >= S) continue;
    T* drow = dq + (static_cast<size_t>(bh) * S + row) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) store(drow + tx + 16 * j, acc[r][j] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk/dv: one block per (kv head bhk, key tile ki)
// ---------------------------------------------------------------------------
template <typename T, int D, bool kExtras>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int Skv, int group, int causal, Extras ex) {
  constexpr int LD = D + 1;
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                 // [64][D + 1]
  float* v_s = k_s + kTile * LD;     // [64][D + 1]
  float* q_s = v_s + kTile * LD;     // [64][D + 1]
  float* do_s = q_s + kTile * LD;    // [64][D + 1]
  float* pt_s = do_s + kTile * LD;   // [64 keys][65]: p transposed
  float* dst_s = pt_s + kTile * kPS; // [64 keys][65]: ds transposed
  float* lse_s = dst_s + kTile * kPS;  // [64]: lse * log2(e) of the q tile
  float* dl_s = lse_s + kTile;         // [64]: delta of the q tile

  const int bhk = blockIdx.x, ki = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T, D, LD>(k_s, k + static_cast<size_t>(bhk) * Skv * D, ki * kTile, Skv);
  load_tile<T, D, LD>(v_s, v + static_cast<size_t>(bhk) * Skv * D, ki * kTile, Skv);

  const int nq = (S + kTile - 1) / kTile;
  const int lo = causal ? (ki * kTile) / kTile : 0;
  float dk_acc[4][kDJ], dv_acc[4][kDJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int bh = bhk * group + g;
    const T* qb = q + static_cast<size_t>(bh) * S * D;
    const T* dob = dout + static_cast<size_t>(bh) * S * D;
    for (int qt = lo; qt < nq; ++qt) {
      __syncthreads();
      load_tile<T, D, LD>(q_s, qb, qt * kTile, S);
      load_tile<T, D, LD>(do_s, dob, qt * kTile, S);
      if (threadIdx.x < kTile) {
        const int row = qt * kTile + threadIdx.x;
        const size_t at = static_cast<size_t>(bh) * S + row;
        lse_s[threadIdx.x] = row < S ? __fmul_rn(lse[at], kLog2e) : 0.f;
        dl_s[threadIdx.x] = row < S ? delta[at] : 0.f;
      }
      __syncthreads();
      // transposed tiles: rows are keys ty*4+r, columns q rows tx+16j
      float st[4][4] = {}, dpt[4][4] = {};
      tile_dot<D>(st, k_s, q_s, ty, tx);
      tile_dot<D>(dpt, v_s, do_s, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = ki * kTile + ty * 4 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const int row = qt * kTile + qc;
          const bool ok = row < S && key < Skv && (kExtras || !causal || row >= key);
          const float sv =
              kExtras && ok ? adjust(st[r][j], ex, bh, row, key, S, Skv, causal) : st[r][j];
          const float p = ok ? exp2f(sv - lse_s[qc]) : 0.f;
          pt_s[(ty * 4 + r) * kPS + qc] = p;
          dst_s[(ty * 4 + r) * kPS + qc] = p * (dpt[r][j] - dl_s[qc]);
        }
      }
      __syncwarp();
      tile_pm<D, LD>(dv_acc, pt_s, do_s, ty, tx);
      tile_pm<D, LD>(dk_acc, dst_s, q_s, ty, tx);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = ki * kTile + ty * 4 + r;
    if (key >= Skv) continue;
    const size_t at = (static_cast<size_t>(bhk) * Skv + key) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      // q arrived pre-scaled by scale * log2(e): d(s)/d(k) = q_prescaled * ln 2
      store(dk + at + tx + 16 * j, dk_acc[r][j] * kLn2);
      store(dv + at + tx + 16 * j, dv_acc[r][j]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The kernels come in two instantiations: with a bias or segment ids (kExtras), where
// every in-range key takes part at -1e30 when masked, as in JAX; and without, where
// a causally masked key is dropped (weight 0, which exp2(-1e30 - m) is for the real
// running max every visited causal tile gives) and no per-logit lookup is paid.
bool has_extras(const Extras& ex) { return ex.bias != nullptr || ex.segq != nullptr; }

struct Shape {
  int BH, BHkv, S, Skv, D, causal;
  int group() const { return BH / BHkv; }
};

template <typename T, int D>
cudaError_t fwd(const Shape& sh, const Extras& ex, const void* q, const void* k, const void* v,
                void* o, float* lse, cudaStream_t st) {
  auto kern = has_extras(ex) ? flash_fwd_kernel<T, D, true> : flash_fwd_kernel<T, D, false>;
  cudaError_t err = allow_smem(kern, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid(sh.BH, (sh.S + kTile - 1) / kTile);
  kern<<<grid, kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sh.S, sh.Skv, sh.group(), sh.causal, ex);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const Shape& sh, const Extras& ex, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta, void* dq,
                   float* dbias, float scale, cudaStream_t st) {
  auto kern =
      has_extras(ex) ? flash_bwd_dq_kernel<T, D, true> : flash_bwd_dq_kernel<T, D, false>;
  cudaError_t err = allow_smem(kern, dq_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid(sh.BH, (sh.S + kTile - 1) / kTile);
  kern<<<grid, kThreads, dq_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), dbias, sh.S, sh.Skv,
      sh.group(), scale, sh.causal, ex);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const Shape& sh, const Extras& ex, const void* q, const void* k,
                    const void* v, const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, cudaStream_t st) {
  auto kern =
      has_extras(ex) ? flash_bwd_dkv_kernel<T, D, true> : flash_bwd_dkv_kernel<T, D, false>;
  cudaError_t err = allow_smem(kern, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid(sh.BHkv, (sh.Skv + kTile - 1) / kTile);
  kern<<<grid, kThreads, dkv_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sh.S,
      sh.Skv, sh.group(), sh.causal, ex);
  return cudaGetLastError();
}

bool valid(const Shape& sh, const Extras& ex) {
  return sh.BH > 0 && sh.BHkv > 0 && sh.BH % sh.BHkv == 0 && sh.S > 0 && sh.Skv > 0 &&
         (sh.S + kTile - 1) / kTile <= 65535 && (sh.Skv + kTile - 1) / kTile <= 65535 &&
         ex.heads > 0 && sh.BH % ex.heads == 0 && (ex.segq == nullptr) == (ex.segk == nullptr);
}

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128.  F is a generic lambda taking a
// (T*, D) tag pair.
template <typename F>
cudaError_t dispatch(int dtype, int D, F&& f) {
  if (dtype == 0 && D == 64) return f(static_cast<float*>(nullptr), std::integral_constant<int, 64>());
  if (dtype == 0 && D == 128) return f(static_cast<float*>(nullptr), std::integral_constant<int, 128>());
  if (dtype == 1 && D == 64) return f(static_cast<__nv_bfloat16*>(nullptr), std::integral_constant<int, 64>());
  if (dtype == 1 && D == 128) return f(static_cast<__nv_bfloat16*>(nullptr), std::integral_constant<int, 128>());
  return cudaErrorInvalidValue;
}

Extras make_extras(const void* bias, long long bsb, long long bsh, long long bsq, long long bsk,
                   int heads, const void* segq, const void* segk) {
  return Extras{static_cast<const float*>(bias), bsb, bsh, bsq, bsk, static_cast<const int*>(segq),
                static_cast<const int*>(segk), heads};
}

}  // namespace

// C entry points bound with ctypes.  Each returns the cudaError_t of its launch
// (0 on success) and does not synchronise.  q is pre-scaled by scale * log2(e).  The
// bias (f32, or null) is read at bias[b * sb + h * sh + row * sq + key * sk], heads =
// H; segq / segk are int32 [B, S] / [B, Skv], both or neither; dbias (f32 [BH, S,
// Skv], or null) is written by the dq kernel.
extern "C" int prt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int BH, int BHkv, int S, int Skv, int D, int causal, int dtype,
                             const void* bias, long long bsb, long long bsh, long long bsq,
                             long long bsk, int heads, const void* segq, const void* segk,
                             void* stream) {
  const Shape sh{BH, BHkv, S, Skv, D, causal};
  const Extras ex = make_extras(bias, bsb, bsh, bsq, bsk, heads, segq, segk);
  if (!valid(sh, ex)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto t, auto d) {
    using T = std::remove_pointer_t<decltype(t)>;
    return fwd<T, decltype(d)::value>(sh, ex, q, k, v, o, static_cast<float*>(lse), st);
  });
}

extern "C" int prt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, void* dbias,
                                int BH, int BHkv, int S, int Skv, int D, float scale, int causal,
                                int dtype, const void* bias, long long bsb, long long bsh,
                                long long bsq, long long bsk, int heads, const void* segq,
                                const void* segk, void* stream) {
  const Shape sh{BH, BHkv, S, Skv, D, causal};
  const Extras ex = make_extras(bias, bsb, bsh, bsq, bsk, heads, segq, segk);
  if (!valid(sh, ex)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto t, auto d) {
    using T = std::remove_pointer_t<decltype(t)>;
    return bwd_dq<T, decltype(d)::value>(sh, ex, q, k, v, dout, static_cast<const float*>(lse),
                                         static_cast<const float*>(delta), dq,
                                         static_cast<float*>(dbias), scale, st);
  });
}

extern "C" int prt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int BH,
                                 int BHkv, int S, int Skv, int D, int causal, int dtype,
                                 const void* bias, long long bsb, long long bsh, long long bsq,
                                 long long bsk, int heads, const void* segq, const void* segk,
                                 void* stream) {
  const Shape sh{BH, BHkv, S, Skv, D, causal};
  const Extras ex = make_extras(bias, bsb, bsh, bsq, bsk, heads, segq, segk);
  if (!valid(sh, ex)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto t, auto d) {
    using T = std::remove_pointer_t<decltype(t)>;
    return bwd_dkv<T, decltype(d)::value>(sh, ex, q, k, v, dout, static_cast<const float*>(lse),
                                          static_cast<const float*>(delta), dk, dv, st);
  });
}

extern "C" const char* prt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
