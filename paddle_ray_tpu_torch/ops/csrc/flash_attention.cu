// Flash attention forward and backward for Hopper (sm_90a), CUDA C++ with the bf16
// tensor cores through inline PTX (wgmma, TMA, mbarrier).
//
// Replaces three TPU kernels of `paddle_ray_tpu/ops/flash_attention.py`:
//   forward  <- _fwd_kernel      (online softmax, o and natural-log lse)
//   dq       <- _bwd_dq_kernel   (dq recomputed from lse and delta)
//   dk/dv    <- _bwd_dkv_kernel  (dk, dv summed over the q-head group)
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
// drops causally masked keys and pays no per-logit lookup (see has_extras).
// lse * log2(e) is a rounded product too (__fmul_rn: no FMA may fold it into the
// subtraction), which keeps a fully masked row's exp2(s - lse2) at 1.
// The dq kernel also writes dbias = ds [B*H, S, Skv] f32 when asked (zeros in the
// tiles a causal row never visits); the wrapper sums it back to the bias's shape.
//
// The visit rule, in every kernel whatever its tile: under causal masking q row r
// visits the keys below (r / 64 + 1) * 64 -- the 64-key tiles of the TPU kernel's
// grid up to r's own -- and a key past that weighs exactly 0.  With extras the keys
// of r's own 64-key tile past r take part at -1e30.  It decides the output only for
// a row whose every visible key is masked (segment ids under causal masking).
//
// Layouts, all contiguous but the bias, heads folded into the leading dim (b * H + h):
//   q, o, do, dq [BH, S, D]      k, v, dk, dv [BHkv, Skv, D], BH = BHkv * group
//   lse, delta   [BH, S] float32
//   bias         f32 at bias[b * sb + h * sh + row * sq + key * sk] (any strides, 0 too)
//   segq, segk   [B, S], [B, Skv] int32      dbias [BH, S, Skv] float32
// q head bh reads kv head bh / group (GQA, no replication in memory); its batch is
// bh / H.  Head dims 64, 80, 96 and 128; S and Skv any length (a ragged last tile
// is masked, not refused).
//
// What bounds it on the H100: at GPT-3 350m's training shape (S 1024, D 64, bf16,
// causal) each kernel does 2, 3 and 4 [S, D] x [D, S] products over the causal half,
// which against the bf16 tensor cores (989 TFLOP/s; NVIDIA H100 SXM data sheet, at
// its 700 W limit) is about the same time as moving its inputs and outputs once
// (3.35 TB/s): the forward is bound by bytes, the two backward kernels by
// operations.
//
// Two designs, by dtype (no switch between them at run time):
//
// bf16: the tensor cores (flash_fwd_tc_kernel, flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel).  384 threads: warpgroup 0 is the producer -- one thread
// issues every TMA load (`cp.async.bulk.tensor`), and it gives back its registers
// (`setmaxnreg` 24) -- and warpgroups 1 and 2 are consumers (`setmaxnreg` 240), each
// owning 64 rows of the block's tile.  ptxas reports 168 registers at entry (384
// threads, one block an SM) and no spill in any of the 24 instantiations but the
// forward's D 64 one with extras (36 bytes); the consumers' accumulators live in
// registers above 168, which `setmaxnreg` 240 makes room for.  Every tile arrives by
// TMA through a 3-D tensor map over [heads, rows, D] (built on the host with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion, so no
// -lcuda): a box past S or Skv is filled with zeros by the hardware and never reads
// the next head's rows.  The streamed tiles go through a ring of two stages, each
// with a `full` mbarrier (TMA bytes) and an `empty` one (the 256 consumer threads),
// so the loads of tile j + 1 overlap the products on tile j.  Shared memory holds
// each tile in 128-byte swizzle atoms of 64 columns ([D / 64][rows][64], the TMA
// map's and the wgmma descriptors' swizzle both 128B); D 80 and 96 are zero-filled
// out to two atoms (128 columns) by TMA, and the products never read the fill: the
// Q K^T sums run over D / 16 k-steps and the products with N = D (`wgmma` m64n80 /
// m64n96) stop at D.
//   * forward, persistent: one block an SM walks the (q head, 128 q rows) items,
//     the last q rows of every head first so the causal triangle's long rows do not
//     trail, and its producer loads the next item's Q (two buffers) and K/V tiles
//     while the current item runs.  The kernel takes q as it is
//     and each consumer pre-scales its own 64 rows in shared memory (q * scale *
//     log2 e rounded to bf16, as the wrapper did in three passes over q before).
//     S = Q K^T is `wgmma` m64nNk16 with A (the warpgroup's Q rows, loaded once) and
//     B (the K tile, K-major as stored) from shared memory, in f32; the masks, the
//     online max and sum stay in f32 registers, reduced over the four threads of a
//     quad; P goes from the S accumulator to bf16 registers and straight into O +=
//     P V as wgmma's register A operand, with V read through the MN-major
//     (transposed) descriptor -- no transposing copy, no round trip through shared
//     memory.  Key tiles of 128 at D 64 and of 64 above (S, O and P fit 240
//     registers either way).
//   * dk/dv, one block per (kv head, 128 keys), K and V resident in shared memory,
//     Q, dO, lse * log2(e) and delta of each visited q tile (64 rows) streamed (the
//     producer warp's lanes copy lse and delta): with keys as rows, S^T = K Q^T and
//     dP^T = V dO^T (both operands K-major), P^T = exp2(S^T - lse2) and dS^T = P^T
//     (dP^T - delta) in f32 registers, column by column, then dV += P^T dO and dK +=
//     dS^T Q with P^T and dS^T as bf16 register A operands and dO and Q through the
//     MN-major descriptor.  dK and dV accumulate in f32 registers (two m64nD
//     accumulators: 128 registers a thread at D 128) across the GQA group's q heads
//     and the q tiles the causal rule visits, with no atomics (deterministic), and
//     are scaled (dk by ln 2) and cast at the end.
//   * dq, one block per (q head, 128 q rows), the last q rows of every head
//     launched first; Q and dO of the block arrive once by TMA and stay resident,
//     each consumer keeps its rows' lse * log2(e) and delta in registers, and the
//     producer streams the K and V tiles (64 keys) up to the later warpgroup's
//     causal limit while each consumer stops at its own: S = Q K^T and dP = dO V^T
//     (both operands K-major), P = exp2(S - lse2) and dS = P (dP - delta) in f32
//     registers, then dQ += dS K with dS as the bf16 register A operand and K
//     through the MN-major descriptor.  dQ accumulates in f32 registers with no
//     atomics (deterministic) and is scaled and cast at the end.  dbias, the f32 dS
//     before its bf16 rounding, is staged tile by tile in shared memory (rows
//     padded to 72 floats: conflict-free) and written in whole lines, 16 threads a
//     row; zeros go to the tiles a causal row never visits.
//   * extras: each thread looks up its two rows' (forward) or keys' (dk/dv) bias
//     line and segment id once, and a call without a bias or segment ids reads a
//     zero at stride 0, so the per-logit work has no branch.
//   Measured and left out: overlapping one tile's second product with the next
//   tile's softmax (the wait pattern of FlashAttention-3, with a third stage), and
//   skipping the per-logit tests on tiles that need none, both made the kernels
//   slower on the H100.
//   The one change in the numbers against the SIMT kernels: P (and, in dk/dv, dS)
//   is rounded to bf16 before its product, as in every tensor-core flash kernel.
//   The S and dP sums, the softmax statistics and lse stay f32.
//
// float32 (all three kernels): plain CUDA C++ on the CUDA cores (flash_fwd_kernel,
// flash_bwd_dq_kernel, flash_bwd_dkv_kernel).  TF32 tensor cores would miss the f32
// tolerance.
//   * tiles of 64 q rows by 64 keys; 256 threads as a 16 x 16 grid, each thread
//     owning a 4 x 4 piece of the 64 x 64 score tile (rows ty*4+r, keys tx+16*j) and
//     the matching rows of the output tile (columns tx+16*j); the 16 threads of one
//     row group are one half-warp, so row max and sum are half-warp shuffles;
//   * tiles are staged in shared memory widened to f32, rows padded by one word so
//     the row and column walks are free of bank conflicts; probabilities go through
//     shared memory between the two products;
//   * forward and dq: one block per (q head, q tile), looping over key tiles up to
//     the causal limit; dk/dv: one block per (kv head, key tile), looping over the
//     group's q heads and the q tiles i >= ki (causal), accumulating in registers.
//   These run the products on the f32 CUDA cores (67 TFLOP/s, the same data sheet)
//   from shared memory, with synchronous loads behind block-wide barriers.

#include <cuda.h>  // CUtensorMap and its enums; the driver entry point comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;                 // q rows and keys per tile
constexpr int kThreads = 256;              // 16 x 16
constexpr int kPS = kTile + 1;             // padded row of a 64 x 64 f32 tile
constexpr float kNeg = -1e30f;             // the TPU kernel's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// A 16-byte load of T, widened to f32 (the SIMT kernels run float32 only).
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
// stride LD; rows past n_rows are zeros.  With kScale each value is multiplied by
// `scale` (q's pre-scaling, as the JAX wrapper does it in float32).
template <typename T, int D, int LD, bool kScale = false>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int n_rows, float scale = 1.f) {
  constexpr int kVN = Vec16<T>::kN;
  constexpr int kChunks = D / kVN;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVN;
    float f[kVN];
    if (row0 + r < n_rows) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
      Vec16<T>::widen(u, f);
      if (kScale)
#pragma unroll
        for (int e = 0; e < kVN; ++e) f[e] = __fmul_rn(f[e], scale);
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
                 float qscale, int causal, Extras ex) {
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
  load_tile<T, D, LD, true>(q_s, q + static_cast<size_t>(bh) * S * D, qi * kTile, S, qscale);

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


// ---------------------------------------------------------------------------
// The bf16 tensor-core kernels: PTX helpers
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kWG = 128;              // threads of a warpgroup
constexpr int kTcThreads = 3 * kWG;   // the producer warpgroup and two consumers
constexpr int kStages = 2;            // the ring of streamed tiles
constexpr int kAtomRow = 128;         // bytes of a row of a 128-byte swizzle atom (64 bf16)

// the head dim padded to whole 64-column swizzle atoms
template <int D>
constexpr int padded() { return D <= 64 ? 64 : 128; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes, the period of the 128B swizzle
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive, and expect `bytes` more of TMA transfers in the current phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box at (c0 column, c1 row, c2 head) of a 3-D map into shared memory
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `count` threads on named barrier `id` (0 is __syncthreads')
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: no instruction that
// touches them moves across this point, and they stay live up to it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// What a tensor-core kernel reads in place of an absent bias or segment id (at
// stride 0), so the per-logit extras run without a branch: a bias of 0 adds
// nothing, two segment ids of 0 are equal.
__device__ const float kZeroBias = 0.f;
__device__ const int kZeroSeg = 0;

// wgmma's shared-memory descriptor of a 128B-swizzled operand (layout type 1): the
// start address and the leading / stride byte offsets, in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}
// K-major (the reduced dim contiguous, as Q, K, V and dO are stored for Q K^T, K Q^T,
// V dO^T): 8-row groups 1024 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_k(const void* p) { return make_desc(p, 16, 1024); }
// MN-major (the output dim contiguous, as V is for P V and dO / Q are for P^T dO /
// dS^T Q): 64-column atoms `atom_bytes` apart, 8-row groups of the reduced dim 1024
// bytes apart.
__device__ __forceinline__ uint64_t desc_mn(const void* p, uint32_t atom_bytes) {
  return make_desc(p, atom_bytes, 1024);
}
// the k-th 16-column slice of a K-major tile of `rows` rows in 64-column atoms: 32
// bytes into its atom (the hardware applies the swizzle to the whole address)
__device__ __forceinline__ uint32_t kslice(int kk, int rows) {
  return (kk / 4) * rows * kAtomRow + (kk % 4) * 32;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The f32 accumulator of an m64nN wgmma, as bf16 A fragments of the next product
// (the reduced dim = N): thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and
// columns 8 j + 2 (l % 4) (+ 1) at acc[4 j + 2 i + c], which is the A fragment
// layout of the k-step j / 2.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// wgmma.mma_async m64nNk16, bf16 inputs, f32 accumulators d (N / 2 a thread); acc = 0
// overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // A and B from shared memory; TA / TB: 1 where the operand is MN-major
  template <int TA, int TB>
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // A from registers (four bf16 pairs a thread), B from shared memory
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
};

template <>
struct Wgmma<80> {
  // A from registers (four bf16 pairs a thread), B from shared memory
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
};

template <>
struct Wgmma<96> {
  // A from registers (four bf16 pairs a thread), B from shared memory
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  // A and B from shared memory; TA / TB: 1 where the operand is MN-major
  template <int TA, int TB>
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // A from registers (four bf16 pairs a thread), B from shared memory
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
};

// ---------------------------------------------------------------------------
// forward on the tensor cores: one block per (q head bh, 128 q rows)
// ---------------------------------------------------------------------------
template <int D>
struct FwdTc {
  static constexpr int kDp = padded<D>();
  static constexpr int kBM = 2 * 64;               // q rows: 64 per consumer warpgroup
  static constexpr int kBN = D == 64 ? 128 : 64;   // keys per tile
  static constexpr int kQBytes = kBM * kDp * 2;
  static constexpr int kTileBytes = kBN * kDp * 2;  // one K or V tile
  // two Q buffers (the next item's Q loads while this one's tiles run), the K/V ring
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + 2 * kStages * kTileBytes + 64;
};

template <int D, bool kExtras>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                    float* __restrict__ lse, int S, int Skv, int BH, int group, float qscale,
                    int causal, Extras ex) {
  using C = FwdTc<D>;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_bufs = align_1024(smem_raw);              // two of [kDp / 64][128][64]
  uint8_t* kv_s = q_bufs + 2 * C::kQBytes;             // per stage: K, V [kDp / 64][kBN][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 2 * kStages * C::kTileBytes);
  uint64_t* q_full = bars;                             // [2]
  uint64_t* q_empty = bars + 2;                        // [2]
  uint64_t* full = bars + 4;
  uint64_t* empty = bars + 4 + kStages;

  // Persistent: the block takes items blockIdx.x, + gridDim.x, ... of the (q head,
  // 128 q rows) items, the last q rows of every head first, so the causal triangle's
  // long rows do not trail; the producer runs ahead across items.
  const int n_qb = (S + C::kBM - 1) / C::kBM;
  const int n_items = BH * n_qb;
  auto item_tiles = [&](int q0) {
    return ((causal ? min(Skv, q0 + C::kBM) : Skv) + kBN - 1) / kBN;
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 2 * kWG);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // the producer: one thread issues the loads, paced by `q_empty` and `empty`
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int t = 0;  // the block's K/V tiles so far, across items
      for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
        const int bh = item % BH, q0 = (n_qb - 1 - item / BH) * C::kBM;
        uint8_t* q_s = q_bufs + (n % 2) * C::kQBytes;
        mbar_wait(&q_empty[n % 2], ((n / 2) & 1) ^ 1);
        mbar_arrive_tx(&q_full[n % 2], C::kQBytes);
        for (int a = 0; a < C::kDp / 64; ++a)
          tma_load3(q_s + a * C::kBM * kAtomRow, &tq, &q_full[n % 2], a * 64, q0, bh);
        const int bhk = bh / group, n_tiles = item_tiles(q0);
        for (int j = 0; j < n_tiles; ++j, ++t) {
          const int s = t % kStages;
          mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
          mbar_arrive_tx(&full[s], 2 * C::kTileBytes);
          uint8_t* k_t = kv_s + 2 * s * C::kTileBytes;
          for (int a = 0; a < C::kDp / 64; ++a) {
            tma_load3(k_t + a * kBN * kAtomRow, &tk, &full[s], a * 64, j * kBN, bhk);
            tma_load3(k_t + C::kTileBytes + a * kBN * kAtomRow, &tv, &full[s], a * 64, j * kBN,
                      bhk);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int w = threadIdx.x / kWG - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int col0 = 2 * (lane % 4);  // this thread's columns in each group of 8
    const long long bias_sk = ex.bias != nullptr ? ex.sk : 0;
    const int seg_sk = ex.segk != nullptr;
    int t = 0;
    for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
      const int bh = item % BH, q0 = (n_qb - 1 - item / BH) * C::kBM;
      const int n_tiles = item_tiles(q0);
      const int row0 = q0 + 64 * w + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
      // the 64-key visit rule: the warpgroup's rows are one 64-row tile
      const int lim = causal ? min(Skv, q0 + 64 * w + 64) : Skv;
      const int my_tiles = q0 + 64 * w < S ? (lim + kBN - 1) / kBN : 0;
      uint8_t* q_w = q_bufs + (n % 2) * C::kQBytes + 64 * w * kAtomRow;
      // with extras: the thread's two rows' bias lines and segment ids, looked up once
      // (a zero at stride 0 where the call has none)
      const int b = bh / ex.heads;
      const int* segk_b =
          ex.segk != nullptr ? ex.segk + static_cast<size_t>(b) * Skv : &kZeroSeg;
      const float* bias_r[2];
      int seg_r[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = min(row0 + 8 * i, S - 1);  // rows past S are never adjusted
        bias_r[i] = ex.bias != nullptr
                        ? ex.bias + b * ex.sb + (bh % ex.heads) * ex.sh + row * ex.sq
                        : &kZeroBias;
        seg_r[i] = kExtras && ex.segq != nullptr ? ex.segq[static_cast<size_t>(b) * S + row] : 0;
      }

      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
      mbar_wait(&q_full[n % 2], (n / 2) & 1);
      // q * qscale rounded to bf16 (the JAX wrapper's pre-scaling), in place: the
      // warpgroup's own 64 rows of every atom; the swizzle moves whole 16-byte
      // chunks, so chunk by chunk needs no address map
      for (int a = 0; a < C::kDp / 64; ++a) {
        uint4* chunk = reinterpret_cast<uint4*>(q_w + a * C::kBM * kAtomRow);
        for (int i = threadIdx.x % kWG; i < 64 * kAtomRow / 16; i += kWG) {
          uint4 u = chunk[i];
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            h[e] = __floats2bfloat162_rn(__fmul_rn(f.x, qscale), __fmul_rn(f.y, qscale));
          }
          chunk[i] = u;
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + w, kWG);

      for (int j = 0; j < n_tiles; ++j, ++t) {
        const int s = t % kStages;
        mbar_wait(&full[s], (t / kStages) & 1);
        const uint8_t* k_t = kv_s + 2 * s * C::kTileBytes;
        const uint8_t* v_t = k_t + C::kTileBytes;
        if (j < my_tiles) {
          // S = Q K^T, f32
          float sc[kBN / 2];
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<kBN>::template ss<0, 0>(sc, desc_k(q_w + kslice(kk, C::kBM)),
                                          desc_k(k_t + kslice(kk, kBN)), kk > 0);
          wg_commit();
          wg_wait();
          fence_regs(sc);

          // masks and the online softmax in f32; a row's keys lie in the 4 threads of a
          // quad.  (Skipping the tests on tiles that need none measured slower.)
          const int k0 = j * kBN;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + 8 * i;
            float mx = kNeg;
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int col = k0 + 8 * j + col0 + c;
                float& x = sc[4 * j + 2 * i + c];
                if (kExtras) {
                  // bias * log2(e), then causal, then segment ids, as `adjust`, with no
                  // branch; a masked key still counts, at -1e30, one not visited weighs 0
                  const int cc = min(col, Skv - 1);
                  const float y = x + __fmul_rn(bias_r[i][cc * bias_sk], kLog2e);
                  const bool masked =
                      row >= S || (causal && row < col) || seg_r[i] != segk_b[cc * seg_sk];
                  x = col < lim ? (masked ? kNeg : y) : -INFINITY;
                } else if (!(col < lim && (!causal || row >= col))) {
                  x = -INFINITY;  // not visited, or dropped: weight exactly 0
                }
                mx = fmaxf(mx, x);
              }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = exp2f(m[i] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                float& x = sc[4 * j + 2 * i + c];
                x = exp2f(x - m_new);
                ps += x;
              }
            ps += __shfl_xor_sync(0xffffffffu, ps, 1);
            ps += __shfl_xor_sync(0xffffffffu, ps, 2);
            l[i] = l[i] * alpha + ps;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
              acc[4 * j + 2 * i] *= alpha;
              acc[4 * j + 2 * i + 1] *= alpha;
            }
          }

          // O += P V: P in bf16 registers, V through the MN-major descriptor
          uint32_t pa[kBN / 16][4];
          acc_to_a<kBN>(sc, pa);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk)
            Wgmma<D>::template rs<1>(acc, pa[kk],
                                     desc_mn(v_t + kk * 16 * kAtomRow, kBN * kAtomRow), 1);
          wg_commit();
          wg_wait();
          fence_regs(acc);
          fence_regs(pa);
        }
        mbar_arrive(&empty[s]);
      }
      mbar_arrive(&q_empty[n % 2]);  // this item's Q is read no more

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row >= S) continue;
        const float ls = fmaxf(l[i], 1e-30f);
        bf16* orow = o + (static_cast<size_t>(bh) * S + row) * D + col0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i] / ls, acc[4 * j + 2 * i + 1] / ls);
        if (lane % 4 == 0) lse[static_cast<size_t>(bh) * S + row] = (m[i] + log2f(ls)) * kLn2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv on the tensor cores: one block per (kv head bhk, 128 keys)
// ---------------------------------------------------------------------------
template <int D>
struct DkvTc {
  static constexpr int kDp = padded<D>();
  static constexpr int kBN = 2 * 64;                 // keys: 64 per consumer warpgroup
  static constexpr int kBM = 64;                     // q rows of a streamed tile
  static constexpr int kKVBytes = kBN * kDp * 2;     // K or V
  static constexpr int kQBytes = kBM * kDp * 2;      // a Q or dO tile
  static constexpr int kStageBytes = 2 * kQBytes + 1024;  // Q, dO, lse2 and delta [64] f32
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes + kStages * kStageBytes + 64;
};

template <int D, bool kExtras>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int S, int Skv, int group, int causal, Extras ex) {
  using C = DkvTc<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align_1024(smem_raw);    // [kDp / 64][128 keys][64]
  uint8_t* v_s = k_s + C::kKVBytes;
  uint8_t* st_s = v_s + C::kKVBytes;      // per stage: Q, dO [kDp / 64][64][64], lse2, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(st_s + kStages * C::kStageBytes);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bhk = blockIdx.x, key0 = blockIdx.y * C::kBN;
  const int nq = (S + C::kBM - 1) / C::kBM;
  const int lo = causal ? key0 / 64 : 0;  // the first q tile that sees the block's keys
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 2 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // the producer warp: lane 0 issues the TMA loads, every lane copies lse and delta
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_tx(kv_full, 2 * C::kKVBytes);
        for (int a = 0; a < C::kDp / 64; ++a) {
          tma_load3(k_s + a * C::kBN * kAtomRow, &tk, kv_full, a * 64, key0, bhk);
          tma_load3(v_s + a * C::kBN * kAtomRow, &tv, kv_full, a * 64, key0, bhk);
        }
      }
      int t = 0;
      for (int g = 0; g < group; ++g) {
        const int bh = bhk * group + g;
        for (int qt = lo; qt < nq; ++qt, ++t) {
          const int s = t % kStages;
          mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
          uint8_t* q_t = st_s + s * C::kStageBytes;
          float* lse_t = reinterpret_cast<float*>(q_t + 2 * C::kQBytes);
          for (int r = lane; r < C::kBM; r += 32) {
            const int row = qt * C::kBM + r;
            const size_t at = static_cast<size_t>(bh) * S + row;
            lse_t[r] = row < S ? __fmul_rn(lse[at], kLog2e) : 0.f;
            lse_t[C::kBM + r] = row < S ? delta[at] : 0.f;
          }
          if (lane == 0) {
            mbar_arrive_tx(&full[s], 2 * C::kQBytes);
            for (int a = 0; a < C::kDp / 64; ++a) {
              tma_load3(q_t + a * C::kBM * kAtomRow, &tq, &full[s], a * 64, qt * C::kBM, bh);
              tma_load3(q_t + C::kQBytes + a * C::kBM * kAtomRow, &tdo, &full[s], a * 64,
                        qt * C::kBM, bh);
            }
          } else {
            mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int w = threadIdx.x / kWG - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int kw = key0 + 64 * w;                        // the warpgroup's first key
    const int key_r0 = kw + 16 * warp + lane / 4;        // this thread's keys: key_r0, + 8
    const int col0 = 2 * (lane % 4);
    const int lo_w = causal ? kw / 64 : 0;               // its first visited q tile
    const bool active = kw < Skv;
    const uint8_t* k_w = k_s + 64 * w * kAtomRow;
    const uint8_t* v_w = v_s + 64 * w * kAtomRow;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    int t = 0;
    for (int g = 0; g < group; ++g) {
      const int bh = bhk * group + g;
      for (int qt = lo; qt < nq; ++qt, ++t) {
        const int s = t % kStages;
        mbar_wait(&full[s], (t / kStages) & 1);
        const uint8_t* q_t = st_s + s * C::kStageBytes;
        const uint8_t* do_t = q_t + C::kQBytes;
        const float* lse_t = reinterpret_cast<const float*>(q_t + 2 * C::kQBytes);
        const float* dl_t = lse_t + C::kBM;
        if (active && qt >= lo_w) {
          // with extras: the thread's two keys' bias lines and segment ids for q head
          // bh (a zero at stride 0 where the call has none)
          const int b = bh / ex.heads;
          const long long bias_sq = ex.bias != nullptr ? ex.sq : 0;
          const int seg_sq = ex.segq != nullptr;
          const int* segq_b =
              ex.segq != nullptr ? ex.segq + static_cast<size_t>(b) * S : &kZeroSeg;
          const float* bias_k[2];
          int seg_k[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int key = min(key_r0 + 8 * i, Skv - 1);  // keys past Skv: never adjusted
            bias_k[i] = ex.bias != nullptr
                            ? ex.bias + b * ex.sb + (bh % ex.heads) * ex.sh + key * ex.sk
                            : &kZeroBias;
            seg_k[i] =
                kExtras && ex.segk != nullptr ? ex.segk[static_cast<size_t>(b) * Skv + key] : 0;
          }
          // S^T = K Q^T and dP^T = V dO^T, f32; rows are keys, columns q rows
          float st[32], dpt[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<64>::template ss<0, 0>(st, desc_k(k_w + kslice(kk, C::kBN)),
                                         desc_k(q_t + kslice(kk, C::kBM)), kk > 0);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<64>::template ss<0, 0>(dpt, desc_k(v_w + kslice(kk, C::kBN)),
                                         desc_k(do_t + kslice(kk, C::kBM)), kk > 0);
          wg_commit();
          wg_wait();
          fence_regs(st);
          fence_regs(dpt);

          // P^T = exp2(S^T - lse2), dS^T = P^T (dP^T - delta), in f32; column by column,
          // so a q row's lse2, delta and bias offset serve both of the thread's keys
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int qc = 8 * j + col0 + c;
              const int row = qt * C::kBM + qc;
              const float lse2 = lse_t[qc], dl = dl_t[qc];
              const int rc = min(row, S - 1);
              const int seg_c = kExtras ? segq_b[rc * seg_sq] : 0;
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int key = key_r0 + 8 * i;
                const int idx = 4 * j + 2 * i + c;
                const bool ok = row < S && key < Skv && (kExtras || !causal || row >= key);
                float sv = st[idx];
                if (kExtras) {  // bias * log2(e), causal, segment ids, as `adjust`, no branch
                  const float y = sv + __fmul_rn(bias_k[i][rc * bias_sq], kLog2e);
                  sv = (causal && row < key) || seg_c != seg_k[i] ? kNeg : y;
                }
                const float p = ok ? exp2f(sv - lse2) : 0.f;
                st[idx] = p;
                dpt[idx] = p * (dpt[idx] - dl);
              }
            }

          // dV += P^T dO and dK += dS^T Q: bf16 register A operands, dO and Q MN-major
          uint32_t pa[4][4], da[4][4];
          acc_to_a<64>(st, pa);
          acc_to_a<64>(dpt, da);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<D>::template rs<1>(dv_acc, pa[kk],
                                     desc_mn(do_t + kk * 16 * kAtomRow, C::kBM * kAtomRow), 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<D>::template rs<1>(dk_acc, da[kk],
                                     desc_mn(q_t + kk * 16 * kAtomRow, C::kBM * kAtomRow), 1);
          wg_commit();
          wg_wait();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          fence_regs(pa);
          fence_regs(da);
        }
        mbar_arrive(&empty[s]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key_r0 + 8 * i;
      if (key >= Skv) continue;
      const size_t at = (static_cast<size_t>(bhk) * Skv + key) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        // q arrived pre-scaled by scale * log2(e): d(s)/d(k) = q_prescaled * ln 2
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * i] * kLn2, dk_acc[4 * j + 2 * i + 1] * kLn2);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dq on the tensor cores: one block per (q head bh, 128 q rows)
// ---------------------------------------------------------------------------
template <int D>
struct DqTc {
  static constexpr int kDp = padded<D>();
  static constexpr int kBM = 2 * 64;                 // q rows: 64 per consumer warpgroup
  static constexpr int kBN = 64;                     // keys of a streamed tile
  static constexpr int kQBytes = kBM * kDp * 2;      // Q or dO, resident
  static constexpr int kTileBytes = kBN * kDp * 2;   // one K or V tile
  static constexpr int kLdb = kBN + 8;               // a dbias staging row, in floats
  static constexpr int kDbBytes = 64 * kLdb * 4;     // one warpgroup's dbias tile
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kTileBytes + 2 * kDbBytes + 64;
};

template <int D, bool kExtras>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       float* __restrict__ dbias, int S, int Skv, int BH, int group, float scale,
                       int causal, Extras ex) {
  using C = DqTc<D>;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);                 // [kDp / 64][128][64]
  uint8_t* do_s = q_s + C::kQBytes;
  uint8_t* kv_s = do_s + C::kQBytes;                   // per stage: K, V [kDp / 64][64][64]
  float* db_s = reinterpret_cast<float*>(kv_s + 2 * kStages * C::kTileBytes);  // [2][64][kLdb]
  uint64_t* bars = reinterpret_cast<uint64_t*>(db_s + 2 * 64 * C::kLdb);
  uint64_t* qd_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  // the last q rows of every head first, so the causal triangle's long rows
  // do not trail
  const int n_qb = (S + C::kBM - 1) / C::kBM;
  const int bh = blockIdx.x % BH, q0 = (n_qb - 1 - blockIdx.x / BH) * C::kBM;
  const int nk = (Skv + kBN - 1) / kBN;
  // key tiles a warpgroup visits: the 64-key visit rule, its rows one 64-row tile
  auto wg_tiles = [&](int w) {
    if (q0 + 64 * w >= S) return 0;
    return causal ? min(q0 / kBN + w + 1, nk) : nk;
  };
  const int n_tiles = max(wg_tiles(0), wg_tiles(1));
  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // the producer: one thread loads Q and dO once, then streams K and V
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(qd_full, 2 * C::kQBytes);
      for (int a = 0; a < C::kDp / 64; ++a) {
        tma_load3(q_s + a * C::kBM * kAtomRow, &tq, qd_full, a * 64, q0, bh);
        tma_load3(do_s + a * C::kBM * kAtomRow, &tdo, qd_full, a * 64, q0, bh);
      }
      const int bhk = bh / group;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * C::kTileBytes);
        uint8_t* k_t = kv_s + 2 * s * C::kTileBytes;
        for (int a = 0; a < C::kDp / 64; ++a) {
          tma_load3(k_t + a * kBN * kAtomRow, &tk, &full[s], a * 64, j * kBN, bhk);
          tma_load3(k_t + C::kTileBytes + a * kBN * kAtomRow, &tv, &full[s], a * 64, j * kBN,
                    bhk);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int w = threadIdx.x / kWG - 1, tw = threadIdx.x % kWG;
    const int warp = tw / 32, lane = threadIdx.x % 32;
    const int col0 = 2 * (lane % 4);
    const int row0 = q0 + 64 * w + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    const int my_tiles = wg_tiles(w);
    const uint8_t* q_w = q_s + 64 * w * kAtomRow;
    const uint8_t* do_w = do_s + 64 * w * kAtomRow;
    float* db_w = db_s + w * 64 * C::kLdb;
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const size_t at = static_cast<size_t>(bh) * S + row;
      lse2[i] = row < S ? __fmul_rn(lse[at], kLog2e) : 0.f;
      dl[i] = row < S ? delta[at] : 0.f;
    }
    // with extras: the thread's two rows' bias lines and segment ids, looked up
    // once (a zero at stride 0 where the call has none)
    const long long bias_sk = ex.bias != nullptr ? ex.sk : 0;
    const int seg_sk = ex.segk != nullptr;
    const int b = bh / ex.heads;
    const int* segk_b = ex.segk != nullptr ? ex.segk + static_cast<size_t>(b) * Skv : &kZeroSeg;
    const float* bias_r[2];
    int seg_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = min(row0 + 8 * i, S - 1);  // rows past S are never adjusted
      bias_r[i] = ex.bias != nullptr ? ex.bias + b * ex.sb + (bh % ex.heads) * ex.sh + row * ex.sq
                                     : &kZeroBias;
      seg_r[i] = kExtras && ex.segq != nullptr ? ex.segq[static_cast<size_t>(b) * S + row] : 0;
    }
    // the warpgroup's dbias rows [wr0, wr0 + 64), written through db_w in whole lines
    const int wr0 = q0 + 64 * w;
    auto dbias_rows = [&](int key0, int keys, bool zeros) {
      // 16 threads a row, four keys a thread; a row's keys are contiguous
      for (int i = tw; i < 64 * (kBN / 4); i += kWG) {
        const int r = i / (kBN / 4), c = 4 * (i % (kBN / 4));
        const int row = wr0 + r;
        if (row >= S || c >= keys) continue;
        float4 v = zeros ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : *reinterpret_cast<const float4*>(db_w + r * C::kLdb + c);
        float* dst = dbias + (static_cast<size_t>(bh) * S + row) * Skv + key0 + c;
        if ((Skv & 3) == 0 && c + 4 <= keys) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
          for (int u = 0; u < 4 && c + u < keys; ++u) dst[u] = e[u];
        }
      }
    };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(qd_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const uint8_t* k_t = kv_s + 2 * s * C::kTileBytes;
      const uint8_t* v_t = k_t + C::kTileBytes;
      if (j < my_tiles) {
        // S = Q K^T and dP = dO V^T, f32, both operands K-major as stored
        float sc[kBN / 2], dp[kBN / 2];
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) sc[i] = dp[i] = 0.f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<kBN>::template ss<0, 0>(sc, desc_k(q_w + kslice(kk, C::kBM)),
                                        desc_k(k_t + kslice(kk, kBN)), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<kBN>::template ss<0, 0>(dp, desc_k(do_w + kslice(kk, C::kBM)),
                                        desc_k(v_t + kslice(kk, kBN)), kk > 0);
        wg_commit();
        wg_wait();
        fence_regs(sc);
        fence_regs(dp);

        // P = exp2(S - lse2) and dS = P (dP - delta) in f32; the extras as `adjust`
        // with no branch (bias * log2(e), then causal, then segment ids)
        const int k0 = j * kBN;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + 8 * i;
#pragma unroll
          for (int jj = 0; jj < kBN / 8; ++jj)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = k0 + 8 * jj + col0 + c;
              const int idx = 4 * jj + 2 * i + c;
              const bool ok = row < S && col < Skv && (kExtras || !causal || row >= col);
              float sv = sc[idx];
              if (kExtras) {
                const int cc = min(col, Skv - 1);
                const float y = sv + __fmul_rn(bias_r[i][cc * bias_sk], kLog2e);
                sv = (causal && row < col) || seg_r[i] != segk_b[cc * seg_sk] ? kNeg : y;
              }
              const float p = ok ? exp2f(sv - lse2[i]) : 0.f;
              dp[idx] = p * (dp[idx] - dl[i]);
            }
        }
        if (dbias != nullptr) {
          // dbias = the f32 dS, staged so the warpgroup writes whole lines
          named_bar_sync(1 + w, kWG);  // the previous tile's rows are written out
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < kBN / 8; ++jj)
              *reinterpret_cast<float2*>(db_w + (16 * warp + lane / 4 + 8 * i) * C::kLdb +
                                         8 * jj + col0) =
                  make_float2(dp[4 * jj + 2 * i], dp[4 * jj + 2 * i + 1]);
          named_bar_sync(1 + w, kWG);
          dbias_rows(k0, min(kBN, Skv - k0), false);
        }

        // dQ += dS K: dS as bf16 register A operands, K through the MN-major descriptor
        uint32_t da[kBN / 16][4];
        acc_to_a<kBN>(dp, da);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          Wgmma<D>::template rs<1>(acc, da[kk], desc_mn(k_t + kk * 16 * kAtomRow, kBN * kAtomRow),
                                   1);
        wg_commit();
        wg_wait();
        fence_regs(acc);
        fence_regs(da);
      }
      mbar_arrive(&empty[s]);
    }
    // dbias is 0 in the key tiles a causal row never visits
    if (dbias != nullptr)
      for (int t = my_tiles; t < nk; ++t) dbias_rows(t * kBN, min(kBN, Skv - t * kBN), true);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= S) continue;
      bf16* drow = dq + (static_cast<size_t>(bh) * S + row) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
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

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D TMA map over a contiguous bf16 [n, rows, D] tensor, in boxes of one 64-column
// 128-byte swizzle atom by `box_rows` rows of one head: columns past D and rows past
// `rows` arrive as zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int n, int rows, int D, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t fwd(const Shape& sh, const Extras& ex, const void* q, const void* k, const void* v,
                void* o, float* lse, float qscale, cudaStream_t st) {
  auto kern = has_extras(ex) ? flash_fwd_kernel<T, D, true> : flash_fwd_kernel<T, D, false>;
  cudaError_t err = allow_smem(kern, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid(sh.BH, (sh.S + kTile - 1) / kTile);
  kern<<<grid, kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sh.S, sh.Skv, sh.group(), qscale, sh.causal, ex);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_tc(const Shape& sh, const Extras& ex, const void* q, const void* k, const void* v,
                   void* o, float* lse, float qscale, cudaStream_t st) {
  using C = FwdTc<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, sh.BH, sh.S, D, C::kBM);
  if (err == cudaSuccess) err = make_map(&tk, k, sh.BHkv, sh.Skv, D, C::kBN);
  if (err == cudaSuccess) err = make_map(&tv, v, sh.BHkv, sh.Skv, D, C::kBN);
  if (err != cudaSuccess) return err;
  auto kern = has_extras(ex) ? flash_fwd_tc_kernel<D, true> : flash_fwd_tc_kernel<D, false>;
  err = allow_smem(kern, C::kSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // persistent: one block an SM (its registers and shared memory allow no second)
  const long long items = static_cast<long long>(sh.BH) * ((sh.S + C::kBM - 1) / C::kBM);
  const int grid = static_cast<int>(items < sms ? items : sms);
  kern<<<grid, kTcThreads, C::kSmem, st>>>(tq, tk, tv, static_cast<bf16*>(o), lse, sh.S, sh.Skv,
                                           sh.BH, sh.group(), qscale, sh.causal, ex);
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

template <int D>
cudaError_t bwd_dq_tc(const Shape& sh, const Extras& ex, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse, const float* delta,
                      void* dq, float* dbias, float scale, cudaStream_t st) {
  using C = DqTc<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = make_map(&tq, q, sh.BH, sh.S, D, C::kBM);
  if (err == cudaSuccess) err = make_map(&tdo, dout, sh.BH, sh.S, D, C::kBM);
  if (err == cudaSuccess) err = make_map(&tk, k, sh.BHkv, sh.Skv, D, C::kBN);
  if (err == cudaSuccess) err = make_map(&tv, v, sh.BHkv, sh.Skv, D, C::kBN);
  if (err != cudaSuccess) return err;
  auto kern =
      has_extras(ex) ? flash_bwd_dq_tc_kernel<D, true> : flash_bwd_dq_tc_kernel<D, false>;
  err = allow_smem(kern, C::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(sh.BH) * ((sh.S + C::kBM - 1) / C::kBM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<int>(blocks), kTcThreads, C::kSmem, st>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), dbias, sh.S, sh.Skv, sh.BH,
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

template <int D>
cudaError_t bwd_dkv_tc(const Shape& sh, const Extras& ex, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, cudaStream_t st) {
  using C = DkvTc<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = make_map(&tq, q, sh.BH, sh.S, D, C::kBM);
  if (err == cudaSuccess) err = make_map(&tdo, dout, sh.BH, sh.S, D, C::kBM);
  if (err == cudaSuccess) err = make_map(&tk, k, sh.BHkv, sh.Skv, D, C::kBN);
  if (err == cudaSuccess) err = make_map(&tv, v, sh.BHkv, sh.Skv, D, C::kBN);
  if (err != cudaSuccess) return err;
  auto kern =
      has_extras(ex) ? flash_bwd_dkv_tc_kernel<D, true> : flash_bwd_dkv_tc_kernel<D, false>;
  err = allow_smem(kern, C::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(sh.BHkv, (sh.Skv + C::kBN - 1) / C::kBN);
  kern<<<grid, kTcThreads, C::kSmem, st>>>(tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
                                           static_cast<bf16*>(dv), sh.S, sh.Skv, sh.group(),
                                           sh.causal, ex);
  return cudaGetLastError();
}

bool valid(const Shape& sh, const Extras& ex) {
  return sh.BH > 0 && sh.BHkv > 0 && sh.BH % sh.BHkv == 0 && sh.S > 0 && sh.Skv > 0 &&
         (sh.S + kTile - 1) / kTile <= 65535 && (sh.Skv + kTile - 1) / kTile <= 65535 &&
         ex.heads > 0 && sh.BH % ex.heads == 0 && (ex.segq == nullptr) == (ex.segk == nullptr);
}

// dtype: 0 = float32, 1 = bfloat16; D: 64, 80, 96 or 128.  F is a generic lambda
// taking a (T*, D) tag pair.
template <typename F>
cudaError_t dispatch(int dtype, int D, F&& f) {
  auto by_dim = [&](auto t) {
    switch (D) {
      case 64: return f(t, std::integral_constant<int, 64>());
      case 80: return f(t, std::integral_constant<int, 80>());
      case 96: return f(t, std::integral_constant<int, 96>());
      case 128: return f(t, std::integral_constant<int, 128>());
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return by_dim(static_cast<float*>(nullptr));
  if (dtype == 1) return by_dim(static_cast<bf16*>(nullptr));
  return cudaErrorInvalidValue;
}

Extras make_extras(const void* bias, long long bsb, long long bsh, long long bsq, long long bsk,
                   int heads, const void* segq, const void* segk) {
  return Extras{static_cast<const float*>(bias), bsb, bsh, bsq, bsk, static_cast<const int*>(segq),
                static_cast<const int*>(segk), heads};
}

template <typename T>
constexpr bool is_bf16() { return std::is_same<T, bf16>::value; }

}  // namespace

// C entry points bound with ctypes.  Each returns the cudaError_t of its launch
// (0 on success) and does not synchronise.  The forward takes q as it is and
// pre-scales it itself by qscale = scale * log2(e) (rounded to q's dtype); the
// backward entries take q pre-scaled so.  The
// bias (f32, or null) is read at bias[b * sb + h * sh + row * sq + key * sk], heads =
// H; segq / segk are int32 [B, S] / [B, Skv], both or neither; dbias (f32 [BH, S,
// Skv], or null) is written by the dq kernel.  bf16 runs on the tensor-core
// kernels, float32 on the SIMT ones.
extern "C" int prt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int BH, int BHkv, int S, int Skv, int D, float qscale, int causal,
                             int dtype,
                             const void* bias, long long bsb, long long bsh, long long bsq,
                             long long bsk, int heads, const void* segq, const void* segk,
                             void* stream) {
  const Shape sh{BH, BHkv, S, Skv, D, causal};
  const Extras ex = make_extras(bias, bsb, bsh, bsq, bsk, heads, segq, segk);
  if (!valid(sh, ex)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, [&](auto t, auto d) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int kD = decltype(d)::value;
    if constexpr (is_bf16<T>())
      return fwd_tc<kD>(sh, ex, q, k, v, o, static_cast<float*>(lse), qscale, st);
    else
      return fwd<T, kD>(sh, ex, q, k, v, o, static_cast<float*>(lse), qscale, st);
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
    constexpr int kD = decltype(d)::value;
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    float* db = static_cast<float*>(dbias);
    if constexpr (is_bf16<T>())
      return bwd_dq_tc<kD>(sh, ex, q, k, v, dout, l, dl, dq, db, scale, st);
    else
      return bwd_dq<T, kD>(sh, ex, q, k, v, dout, l, dl, dq, db, scale, st);
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
    constexpr int kD = decltype(d)::value;
    const float* l = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    if constexpr (is_bf16<T>())
      return bwd_dkv_tc<kD>(sh, ex, q, k, v, dout, l, dl, dk, dv, st);
    else
      return bwd_dkv<T, kD>(sh, ex, q, k, v, dout, l, dl, dk, dv, st);
  });
}

extern "C" const char* prt_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
