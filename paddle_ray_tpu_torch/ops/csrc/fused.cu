// Fused dropout + residual add + LayerNorm, forward and backward, on Hopper
// (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernels `paddle_ray_tpu/ops/fused.py:_dal_fwd_kernel` and
// `_dal_bwd_kernel` (`fused_dropout_add_layernorm`):
//
//   keep = hash(seed, global row, col) >= thresh       (thresh = p * 2^32)
//   h    = x * (keep ? scale : 0) + residual            (scale = f32(1) / f32(1 - p))
//   y    = (h - mean) * rstd * w + b,   rstd = rsqrt(var + eps)
//
// in f32: the mean first, then the CENTRED variance.  The hash is the JAX
// kernel's `_keep_mask`, a murmur3 finaliser over uint32 (seed, row, col); it
// uses the global row, so the mask is the JAX one bit for bit whatever the
// blocking, and the backward recomputes it from the seed: no mask in memory.
// The forward writes y and h in x's type and mean / rstd [rows] f32; the
// backward reads h (x's type, as the JAX backward does), mean, rstd, dy and
// the h output's own cotangent dh2 (optional), and gives
//
//   dh   = rstd * (dy w - mean(dy w) - xhat * mean(dy w xhat)) + dh2
//   dres = dh,   dx = dh * (keep ? scale : 0),   dw = sum_rows dy xhat,   db = sum_rows dy
//
// Layouts (all contiguous): x, residual, y, h, dy, dh2, dx, dres [rows, H] f32 or
// bf16 (one type); w, b [H] f32 or bf16 (one type); mean, rstd [rows] f32;
// part [2, blocks, H] f32 scratch (blocks <= min(256, rows)); dw, db [H] f32.
//
// What bounds it on the H100: bytes.  About 10 operations an element against
// the card's ~295 operations per byte, so the least time is x and residual read
// and y and h written once (forward); h, dy, dh2 read and dx, dres written once
// (backward), over 3.35 TB/s.
//
// Design, both passes on one plan for the card: a row lives in the registers
// of a group of G warps, the fewest (a power of two, at most eight) that keep a
// lane at V values, each lane holding NV 16-byte vectors of it (8 bf16 or 4 f32
// a vector), vector v of the row in lane v % 32 of the group's warp v / 32 % G.
// V is 8 in the backward (measured faster than 16 with half the warps a row)
// and 16 in the forward (on an H100 at [4096, 1024] bf16: 0.0188 ms against
// 0.0201 with 8, 0.0229 with 32; two warps a row, four rows a block at once).
// Each array is read and written once, by 16-byte loads and stores (where H is
// not a multiple of the vector or a pointer is not 16-byte aligned, by element
// loads of columns lane, lane + 32, ... of the same 32-vector blocks).
// Row sums are warp shuffles and, for G > 1, an exchange through shared memory
// behind the group's own named barrier: no __syncthreads in the row loop.
// With 16-byte loads later rows' inputs fly by cp.async into each thread's
// own shared-memory slots while this row is finished and stored.  A fixed grid
// of at most 256 blocks of 8 warps, whatever the card, each group striding
// over rows, so the sum order is the same on every card and call.  Each lane
// carries its columns' parameters in f32 registers across its rows, read once.
//   * forward: x and residual in, h = x keep scale + residual in f32 registers;
//     the mean (one exchange), then the centred sum of squares of the same
//     registers (a second exchange); y and h stored from registers, h never
//     read again.  Two rows of a group fly ahead of the one computed (one or
//     three measured slower).  w and b of the lane's columns are loaded once,
//     through one branch on their type;
//   * backward: h and dy (and dh2) in; the two row sums are independent, one
//     exchange (two slots by row parity); the next row's h and dy (and dh2)
//     fly while this row's outputs are computed and stored.  Each lane carries
//     its columns' w and dw / db terms in registers across its rows; at the end
//     the block's groups add theirs in shared memory in group order and the
//     block writes them once; a second launch sums the blocks in block order (a
//     warp per eighth of the blocks, 32 columns a block of threads).  The TPU
//     kernel carried dw / db across its sequential grid in scratch; here the
//     sums are deterministic without atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxH = 8192;  // the wrapper's KERNEL_MAX_H
constexpr int kF32 = 0, kBF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// a per-column parameter (w, b): f32 or bf16 by `dt`
__device__ __forceinline__ float load_param(const void* p, int i, int dt) {
  return dt == kF32 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// The JAX `_keep_mask` hash, in uint32 arithmetic (which wraps as JAX's does).
__device__ __forceinline__ bool keep(uint32_t seed, uint32_t row, uint32_t col, uint32_t thresh) {
  uint32_t x = seed * 2654435761u + row * 0x9E3779B9u + col * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

// ---------------------------------------------------------------------------
// rows in the registers of a group of warps: the parts of both passes
// ---------------------------------------------------------------------------
constexpr int kRowWarps = 8;
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRowBlocks = 256;  // the most blocks of a launch; the wrapper's _BWD_BLOCKS
constexpr int kRowValues = 8;    // the backward's values a lane, unless G would pass 8 warps
constexpr int kFwdValues = 16;   // the forward's
constexpr int kFwdAhead = 2;     // the forward's rows of a group in flight ahead of the one computed

// A warp's 32 x VE columns from `blk` on, VE values a lane held as 16 bytes of
// T: with VEC the lane's VE neighbours (one 16-byte load), else columns lane,
// lane + 32, ... (element loads, each coalesced over the warp) up to H
template <typename T>
struct Row {
  static constexpr int VE = 16 / sizeof(T);
  template <bool VEC>
  __device__ __forceinline__ static int col(int blk, int lane, int i) {
    return VEC ? blk + VE * lane + i : blk + lane + 32 * i;
  }
  template <bool VEC>
  __device__ __forceinline__ static uint4 load(const T* p, int blk, int lane, int H) {
    const int c = col<VEC>(blk, lane, 0);
    if (VEC) return c < H ? *reinterpret_cast<const uint4*>(p + c) : make_uint4(0, 0, 0, 0);
    uint4 u = make_uint4(0, 0, 0, 0);
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < VE; ++i)
      if (c + 32 * i < H) e[i] = p[c + 32 * i];
    return u;
  }
  __device__ __forceinline__ static float get(const uint4& u, int i) {
    return to_f32(reinterpret_cast<const T*>(&u)[i]);
  }
  template <bool VEC>
  __device__ __forceinline__ static void put(T* p, int blk, int lane, int H, const float* v) {
    const int c = col<VEC>(blk, lane, 0);
    if (VEC) {
      if (c >= H) return;
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < VE; ++i) store(e + i, v[i]);
      *reinterpret_cast<uint4*>(p + c) = u;
      return;
    }
#pragma unroll
    for (int i = 0; i < VE; ++i)
      if (c + 32 * i < H) store(p + c + 32 * i, v[i]);
  }
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over the G warps of group grp (the same bits in all of them):
// each warp's value through its slot in red, behind the group's barrier
__device__ __forceinline__ float group_sum(float v, float* red, int warp, int lane, int grp,
                                           int G) {
  if (G == 1) return v;
  if (lane == 0) red[warp] = v;
  group_barrier(1 + grp, 32 * G);
  float t = 0.f;
  for (int k = 0; k < G; ++k) t += red[grp * G + k];
  return t;
}

// ---------------------------------------------------------------------------
// forward: G warps a row, NV vectors a lane; see the file's header.  Two blocks
// an SM (128 registers a thread) up to 16 values a lane, one for the widest rows
// ---------------------------------------------------------------------------
template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(kRowThreads, NV * Row<T>::VE <= 16 ? 2 : 1)
dal_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res, const void* __restrict__ w,
               const void* __restrict__ b, T* __restrict__ y, T* __restrict__ h,
               float* __restrict__ mean, float* __restrict__ rstd, int rows, int H, int G,
               uint32_t seed, uint32_t thresh, float scale, int drop, float eps, int p_dt) {
  using R = Row<T>;
  constexpr int VE = R::VE;
  // with VEC each thread's own 16-byte slots of the group's next kFwdAhead
  // rows' x and residual ([ring][array][NV][thread]), filled by cp.async while
  // earlier rows are finished
  extern __shared__ __align__(16) float fwd_sm[];
  uint4* stage_s = reinterpret_cast<uint4*>(fwd_sm);
  // the row sums of a group's warps: the sum, then the centred sum of squares
  // (a warp's read of one slot and the next row's write of it lie on either
  // side of the other's barrier)
  __shared__ float red_s[2][kRowWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = kRowWarps / G, grp = warp / G, wig = warp % G;
  const int stride = gridDim.x * groups;

  int blk[NV];  // the lane's warp's column blocks: 32 (wig + G j) vectors in
#pragma unroll
  for (int j = 0; j < NV; ++j) blk[j] = VE * 32 * (wig + G * j);
  auto slot = [&](int r, int a, int j) {
    return stage_s + ((r * 2 + a) * NV + j) * kRowThreads + threadIdx.x;
  };
  // the lane's vectors of x and residual of `row` into ring slot r, as one
  // commit group (an empty one past the last row keeps the count)
  auto prefetch = [&](int r, int row) {
    if (row < rows) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = blk[j] + VE * lane;
        if (c < H) {
          cp16(slot(r, 0, j), x + static_cast<size_t>(row) * H + c);
          cp16(slot(r, 1, j), res + static_cast<size_t>(row) * H + c);
        }
      }
    }
    cp_commit();
  };
  const int first = blockIdx.x * groups + grp;
  if (VEC) {
#pragma unroll
    for (int r = 0; r < kFwdAhead; ++r) prefetch(r, first + r * stride);
  }
  // w and b of the lane's columns in f32 registers (0 past H), read once
  float wv[NV][VE], bv[NV][VE];
  auto load_params = [&](const auto* wp, const auto* bp) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        const int c = R::template col<VEC>(blk[j], lane, i);
        wv[j][i] = c < H ? to_f32(wp[c]) : 0.f;
        bv[j][i] = c < H ? to_f32(bp[c]) : 0.f;
      }
  };
  if (p_dt == kF32)
    load_params(static_cast<const float*>(w), static_cast<const float*>(b));
  else
    load_params(static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(b));

  // a slot this thread did not fill (past H) reads as 0
  auto take = [&](int r, int a, int j) {
    return blk[j] + VE * lane < H ? *slot(r, a, j) : make_uint4(0, 0, 0, 0);
  };
  int ring = 0;  // the ring slot of this row
  for (int row = first; row < rows; row += stride) {
    const size_t base = static_cast<size_t>(row) * H;
    float hv[NV][VE];
    float s1 = 0.f;
    // h = x keep scale + residual, as the plain version rounds it; columns past
    // H hold x = residual = 0, so h = 0 there
    auto fill = [&](int j, const uint4& xu, const uint4& ru) {
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        float xv = R::get(xu, i);
        if (drop) {
          const int c = R::template col<VEC>(blk[j], lane, i);
          xv = __fmul_rn(xv, keep(seed, static_cast<uint32_t>(row), static_cast<uint32_t>(c),
                                  thresh) ? scale : 0.f);
        }
        hv[j][i] = __fadd_rn(xv, R::get(ru, i));
        s1 += hv[j][i];
      }
    };
    if constexpr (VEC) {
      cp_wait<kFwdAhead - 1>();  // this row's group; later rows may fly
#pragma unroll
      for (int j = 0; j < NV; ++j) fill(j, take(ring, 0, j), take(ring, 1, j));
      // the slot is consumed: a later row's x and residual fly while this row
      // is finished and stored
      prefetch(ring, row + kFwdAhead * stride);
      ring = ring + 1 == kFwdAhead ? 0 : ring + 1;
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        fill(j, R::template load<VEC>(x + base, blk[j], lane, H),
             R::template load<VEC>(res + base, blk[j], lane, H));
    }
    const float mu = group_sum(warp_sum(s1), red_s[0], warp, lane, grp, G) / static_cast<float>(H);
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        const int c = R::template col<VEC>(blk[j], lane, i);
        const float d = c < H ? hv[j][i] - mu : 0.f;
        s2 += d * d;
      }
    const float var = group_sum(warp_sum(s2), red_s[1], warp, lane, grp, G) / static_cast<float>(H);
    const float rs = rsqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float yv[VE];
#pragma unroll
      for (int i = 0; i < VE; ++i) yv[i] = fmaf((hv[j][i] - mu) * rs, wv[j][i], bv[j][i]);
      R::template put<VEC>(y + base, blk[j], lane, H, yv);
      R::template put<VEC>(h + base, blk[j], lane, H, hv[j]);
    }
    if (wig == 0 && lane == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

// G warps a row, NV vectors a lane; see the file's header.  Two blocks an SM
// (128 registers a thread, which hold 16 values a lane with their dw / db), one
// for the widest rows
template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(kRowThreads, NV * Row<T>::VE <= 16 ? 2 : 1)
dal_bwd_kernel(const T* __restrict__ h, const float* __restrict__ mean,
               const float* __restrict__ rstd, const void* __restrict__ w,
               const T* __restrict__ dy, const T* __restrict__ dh2, T* __restrict__ dx,
               T* __restrict__ dres, float* __restrict__ part, int rows, int H, int G,
               uint32_t seed, uint32_t thresh, float scale, int drop, int p_dt) {
  using R = Row<T>;
  constexpr int VE = R::VE;
  extern __shared__ __align__(16) float sm[];
  // with VEC each thread's own 16-byte slots of the next row's h, dy and dh2
  // ([array][NV][thread]), filled by cp.async while this row is computed
  uint4* stage_s = reinterpret_cast<uint4*>(sm);
  float* w_s = sm + (VEC ? 3 * NV * kRowThreads * 4 : 0);   // [H] w in f32
  float* sum_s = w_s + H;                                  // [2][H] the block's dw, db
  __shared__ float red_s[2][kRowWarps][2];  // the row sums of a group's warps, by row parity
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = kRowWarps / G, grp = warp / G, wig = warp % G;
  const int stride = gridDim.x * groups;

  int blk[NV];  // the lane's warp's column blocks: 32 (wig + G j) vectors in
#pragma unroll
  for (int j = 0; j < NV; ++j) blk[j] = VE * 32 * (wig + G * j);
  auto slot = [&](int a, int j) { return stage_s + (a * NV + j) * kRowThreads + threadIdx.x; };
  // the lane's vectors of array a (0 h, 1 dy, 2 dh2) of `row` into its slots
  auto prefetch = [&](const T* src, int a, int row) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = blk[j] + VE * lane;
      if (c < H) cp16(slot(a, j), src + static_cast<size_t>(row) * H + c);
    }
  };
  const int first = blockIdx.x * groups + grp;
  if (VEC && first < rows) {
    prefetch(h, 0, first);
    prefetch(dy, 1, first);
    if (dh2 != nullptr) prefetch(dh2, 2, first);
    cp_commit();
  }
  for (int c = threadIdx.x; c < H; c += kRowThreads) w_s[c] = load_param(w, c, p_dt);
  __syncthreads();
  // the lane's columns' w in registers (0 past H), read once: reading a lane's
  // VE neighbours from shared memory every row is a 4- to 8-way bank conflict;
  // the widest rows (32 values a lane), short of registers, read them there
  constexpr bool kWRegs = NV * VE <= 16;
  float dw[NV][VE], db[NV][VE], wv[kWRegs ? NV : 1][VE];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < VE; ++i) {
      dw[j][i] = db[j][i] = 0.f;
      if constexpr (kWRegs) {
        const int c = R::template col<VEC>(blk[j], lane, i);
        wv[j][i] = c < H ? w_s[c] : 0.f;
      }
    }
  auto w_at = [&](int j, int i, int c) {
    if constexpr (kWRegs) return wv[j][i];
    return c < H ? w_s[c] : 0.f;
  };

  // a slot this thread did not fill (past H) reads as 0
  auto take = [&](int a, int j) {
    return blk[j] + VE * lane < H ? *slot(a, j) : make_uint4(0, 0, 0, 0);
  };
  // the row statistics, loaded a row ahead too
  float mu = first < rows ? mean[first] : 0.f, rs = first < rows ? rstd[first] : 0.f;
  int par = 0;
  for (int row = first; row < rows; row += stride, par ^= 1) {
    const size_t base = static_cast<size_t>(row) * H;
    const int next = row + stride;
    uint4 hv[NV], gv[NV], d2[NV];
    if constexpr (VEC) {
      cp_wait<0>();
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        hv[j] = take(0, j);
        gv[j] = take(1, j);
        if (dh2 != nullptr) d2[j] = take(2, j);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        hv[j] = R::template load<VEC>(h + base, blk[j], lane, H);
        gv[j] = R::template load<VEC>(dy + base, blk[j], lane, H);
        if (dh2 != nullptr) d2[j] = R::template load<VEC>(dh2 + base, blk[j], lane, H);
      }
    }
    // columns past H hold h = dy = 0 and w = 0: they add exactly 0
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        const int c = R::template col<VEC>(blk[j], lane, i);
        const float xh = (R::get(hv[j], i) - mu) * rs;
        const float g = R::get(gv[j], i);
        const float dyw = g * w_at(j, i, c);
        s1 += dyw;
        s2 += dyw * xh;
        dw[j][i] += g * xh;
        db[j][i] += g;
      }
    // the next row's h and dy fly while this one finishes: this thread's slots
    // were read into hv / gv, which the sums above have consumed
    if (VEC && next < rows) {
      prefetch(h, 0, next);
      prefetch(dy, 1, next);
    }
    const float mu_next = next < rows ? mean[next] : 0.f;
    const float rs_next = next < rows ? rstd[next] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (G > 1) {  // the group's warps in order
      if (lane == 0) {
        red_s[par][warp][0] = s1;
        red_s[par][warp][1] = s2;
      }
      group_barrier(1 + grp, 32 * G);
      s1 = s2 = 0.f;
      for (int k = 0; k < G; ++k) {
        s1 += red_s[par][grp * G + k][0];
        s2 += red_s[par][grp * G + k][1];
      }
    }
    const float m1 = s1 / static_cast<float>(H), m2 = s2 / static_cast<float>(H);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float d[VE], x[VE];
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        const int c = R::template col<VEC>(blk[j], lane, i);
        const float xh = (R::get(hv[j], i) - mu) * rs;
        const float dyw = R::get(gv[j], i) * w_at(j, i, c);
        d[i] = rs * (dyw - m1 - xh * m2);
        if (dh2 != nullptr) d[i] += R::get(d2[j], i);
        x[i] = drop ? d[i] * (keep(seed, static_cast<uint32_t>(row), static_cast<uint32_t>(c),
                                   thresh) ? scale : 0.f)
                    : d[i];
      }
      R::template put<VEC>(dres + base, blk[j], lane, H, d);
      R::template put<VEC>(dx + base, blk[j], lane, H, x);
    }
    if (VEC && next < rows) {  // dh2's slots, consumed above
      if (dh2 != nullptr) prefetch(dh2, 2, next);
      cp_commit();
    }
    mu = mu_next;
    rs = rs_next;
  }

  // the block's dw / db: its groups' terms added in group order, written once
  for (int k = 0; k < groups; ++k) {
    if (grp == k) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int i = 0; i < VE; ++i) {
          const int c = R::template col<VEC>(blk[j], lane, i);
          if (c < H) {
            sum_s[c] = k == 0 ? dw[j][i] : sum_s[c] + dw[j][i];
            sum_s[H + c] = k == 0 ? db[j][i] : sum_s[H + c] + db[j][i];
          }
        }
    }
    __syncthreads();
  }
  float* pw = part + static_cast<size_t>(blockIdx.x) * H;
  float* pb = part + static_cast<size_t>(gridDim.x + blockIdx.x) * H;
  for (int c = threadIdx.x; c < H; c += kRowThreads) {
    pw[c] = sum_s[c];
    pb[c] = sum_s[H + c];
  }
}

// dw[c] = sum over blocks of part[0][blk][c], db likewise (blockIdx.y), in block
// order: warp k sums blocks k, k + 8, ... of the block's 32 columns, then the 8
// warps' sums are added in warp order
__global__ void __launch_bounds__(kRowThreads)
dal_bwd_reduce(const float* __restrict__ part, float* __restrict__ dw, float* __restrict__ db,
               int blocks, int H) {
  __shared__ float s[kRowWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  const float* src = part + static_cast<size_t>(blockIdx.y) * blocks * H;
  float acc = 0.f;
  if (c < H)
    for (int k = warp; k < blocks; k += kRowWarps) acc += src[static_cast<size_t>(k) * H + c];
  s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < H) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kRowWarps; ++k) t += s[k][lane];
    (blockIdx.y == 0 ? dw : db)[c] = t;
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct FwdArgs {
  const void *x, *res, *w, *b;
  void *y, *h;
  float *mean, *rstd;
  int rows, H;
  uint32_t seed, thresh;
  float scale;
  int drop;
  float eps;
  int p_dt;
  cudaStream_t st;
};

// blocks of a launch: enough for every group of warps to have a row, at most
// kRowBlocks
int row_blocks(int rows, int G) {
  const int groups = kRowWarps / G;
  const int need = (rows + groups - 1) / groups;
  return need < kRowBlocks ? need : kRowBlocks;
}

template <typename T, int NV, bool VEC>
cudaError_t launch_fwd(const FwdArgs& a, int G) {
  auto kern = dal_fwd_kernel<T, NV, VEC>;
  const size_t smem = VEC ? kFwdAhead * 2 * NV * kRowThreads * 16 : 0;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<row_blocks(a.rows, G), kRowThreads, smem, a.st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res), a.w, a.b, static_cast<T*>(a.y),
      static_cast<T*>(a.h), a.mean, a.rstd, a.rows, a.H, G, a.seed, a.thresh, a.scale, a.drop,
      a.eps, a.p_dt);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *h, *w, *dy, *dh2;
  const float *mean, *rstd;
  void *dx, *dres;
  float *part, *dw, *db;
  int rows, H;
  uint32_t seed, thresh;
  float scale;
  int drop, p_dt;
  cudaStream_t st;
};

template <typename T, int NV, bool VEC>
cudaError_t launch_bwd(const BwdArgs& a, int G) {
  auto kern = dal_bwd_kernel<T, NV, VEC>;
  const size_t smem = sizeof(float) * 3 * a.H + (VEC ? 3 * NV * kRowThreads * 16 : 0);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int blocks = row_blocks(a.rows, G);
  kern<<<blocks, kRowThreads, smem, a.st>>>(
      static_cast<const T*>(a.h), a.mean, a.rstd, a.w, static_cast<const T*>(a.dy),
      static_cast<const T*>(a.dh2), static_cast<T*>(a.dx), static_cast<T*>(a.dres), a.part, a.rows,
      a.H, G, a.seed, a.thresh, a.scale, a.drop, a.p_dt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dal_bwd_reduce<<<dim3((a.H + 31) / 32, 2), kRowThreads, 0, a.st>>>(a.part, a.dw, a.db, blocks,
                                                                     a.H);
  return cudaGetLastError();
}

// G, the warps a row: the fewest (a power of two, at most 8) that keep a lane at
// `values` values; NV, the vectors a lane then holds (up to 4 for bf16 and 8
// for float32 rows wider than 2048).  Calls f(integral_constant<NV>, G).
template <typename T, typename F>
cudaError_t by_width(int H, int values, F&& f) {
  constexpr int VE = Row<T>::VE;
  int G = 1;
  while (G < kRowWarps && G * 32 * values < H) G *= 2;
  const int nv = (H + G * 32 * VE - 1) / (G * 32 * VE);
  switch (nv) {
    case 1: return f(std::integral_constant<int, 1>(), G);
    case 2: return f(std::integral_constant<int, 2>(), G);
    case 3: return f(std::integral_constant<int, 3>(), G);
    case 4: return f(std::integral_constant<int, 4>(), G);
  }
  if constexpr (VE == 4) {
    switch (nv) {
      case 5: return f(std::integral_constant<int, 5>(), G);
      case 6: return f(std::integral_constant<int, 6>(), G);
      case 7: return f(std::integral_constant<int, 7>(), G);
      case 8: return f(std::integral_constant<int, 8>(), G);
    }
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch_fwd_dtype(const FwdArgs& a) {
  const bool vec = a.H % Row<T>::VE == 0 && aligned16(a.x) && aligned16(a.res) &&
                   aligned16(a.y) && aligned16(a.h);
  return by_width<T>(a.H, kFwdValues, [&](auto nv, int G) {
    return vec ? launch_fwd<T, decltype(nv)::value, true>(a, G)
               : launch_fwd<T, decltype(nv)::value, false>(a, G);
  });
}

template <typename T>
cudaError_t launch_bwd_dtype(const BwdArgs& a) {
  const bool vec = a.H % Row<T>::VE == 0 && aligned16(a.h) && aligned16(a.dy) &&
                   aligned16(a.dx) && aligned16(a.dres) &&
                   (a.dh2 == nullptr || aligned16(a.dh2));
  return by_width<T>(a.H, kRowValues, [&](auto nv, int G) {
    return vec ? launch_bwd<T, decltype(nv)::value, true>(a, G)
               : launch_bwd<T, decltype(nv)::value, false>(a, G);
  });
}

bool bad_type(int dt) { return dt != kF32 && dt != kBF16; }

}  // namespace

// C entry points bound with ctypes.  Each returns the cudaError_t of its launches
// (0 on success) and does not synchronise.  dtype / p_dtype: 0 = f32, 1 = bf16.
extern "C" int prt_dal_fwd(const void* x, const void* res, const void* w, const void* b, void* y,
                           void* h, void* mean, void* rstd, int rows, int H, uint32_t seed,
                           uint32_t thresh, float scale, int drop, float eps, int dtype,
                           int p_dtype, void* stream) {
  if (rows <= 0 || H <= 0 || H > kMaxH || bad_type(dtype) || bad_type(p_dtype))
    return cudaErrorInvalidValue;
  const FwdArgs a{x, res, w, b, y, h, static_cast<float*>(mean), static_cast<float*>(rstd),
                  rows, H, seed, thresh, scale, drop, eps, p_dtype,
                  static_cast<cudaStream_t>(stream)};
  return dtype == kF32 ? launch_fwd_dtype<float>(a) : launch_fwd_dtype<__nv_bfloat16>(a);
}

// part: f32 [2, min(256, rows), H] scratch.
extern "C" int prt_dal_bwd(const void* h, const void* mean, const void* rstd, const void* w,
                           const void* dy, const void* dh2, void* dx, void* dres, void* part,
                           void* dw, void* db, int rows, int H, uint32_t seed, uint32_t thresh,
                           float scale, int drop, int dtype, int p_dtype, void* stream) {
  if (rows <= 0 || H <= 0 || H > kMaxH || bad_type(dtype) || bad_type(p_dtype))
    return cudaErrorInvalidValue;
  const BwdArgs a{h, w, dy, dh2, static_cast<const float*>(mean), static_cast<const float*>(rstd),
                  dx, dres, static_cast<float*>(part), static_cast<float*>(dw),
                  static_cast<float*>(db), rows, H, seed, thresh, scale, drop, p_dtype,
                  static_cast<cudaStream_t>(stream)};
  return dtype == kF32 ? launch_bwd_dtype<float>(a) : launch_bwd_dtype<__nv_bfloat16>(a);
}

extern "C" const char* prt_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
