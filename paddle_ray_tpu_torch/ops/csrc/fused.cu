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
// part [2, blocks, H] f32 scratch; dw, db [H] f32.
//
// What bounds it on the H100: bytes.  About 10 operations an element against
// the card's ~295 operations per byte, so the least time is x and residual read
// and y and h written once (forward); h, dy, dh2 read and dx, dres written once
// (backward), over 3.35 TB/s.
//
// Design (simple first):
//   * forward: one block per row, up to 256 threads walking its columns; the row
//     of h is staged in shared memory as f32, so x and residual are read once;
//     the two block reductions (sum, then centred sum of squares) are warp
//     shuffles and one shared word a warp, in a fixed order;
//   * backward: each block walks `per_block` consecutive rows (at most 256
//     blocks).  Per row, one pass reads h and dy, keeps x-hat and dy * w in
//     shared memory and sums dy * w and dy * w * x-hat; a second pass writes
//     dres and dx.  Each thread owns the same columns in every row, so it adds
//     its columns' dw / db terms into shared memory without atomics.  The TPU
//     kernel carried dw / db across its sequential grid in scratch; blocks run
//     in no order here, so each writes its partial sums and a second small
//     kernel sums them over the blocks in a fixed order: deterministic, no
//     atomics;
//   * loads are one element a thread (coalesced, not vectorised).  Left for
//     later: 16-byte loads, several rows a block at small H, a persistent
//     backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
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

// Sum of `v` over the block (blockDim.x a multiple of 32), the same value in
// every thread; `red` holds one word a warp.  Fixed order: bit-reproducible.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // `red` is no longer read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

inline int block_threads(int H) {
  const int t = (H + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// ---------------------------------------------------------------------------
// forward: one block per row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
dal_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res, const void* __restrict__ w,
               const void* __restrict__ b, T* __restrict__ y, T* __restrict__ h,
               float* __restrict__ mean, float* __restrict__ rstd, int H, uint32_t seed,
               uint32_t thresh, float scale, int drop, float eps, int p_dt) {
  extern __shared__ float hs[];  // [H]: the row of h in f32
  __shared__ float red[32];
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * H;

  float s = 0.f;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float xv = to_f32(x[base + c]);
    if (drop) xv = xv * (keep(seed, static_cast<uint32_t>(row), static_cast<uint32_t>(c), thresh) ? scale : 0.f);
    const float hv = xv + to_f32(res[base + c]);
    hs[c] = hv;
    s += hv;
  }
  const float mu = block_sum(s, red) / static_cast<float>(H);
  float q = 0.f;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const float d = hs[c] - mu;
    q += d * d;
  }
  const float var = block_sum(q, red) / static_cast<float>(H);
  const float rs = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const float hv = hs[c];
    const float xh = (hv - mu) * rs;
    store(h + base + c, hv);
    store(y + base + c, xh * load_param(w, c, p_dt) + load_param(b, c, p_dt));
  }
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// ---------------------------------------------------------------------------
// backward: one block per `per_block` consecutive rows, then the dw / db sum
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
dal_bwd_kernel(const T* __restrict__ h, const float* __restrict__ mean,
               const float* __restrict__ rstd, const void* __restrict__ w,
               const T* __restrict__ dy, const T* __restrict__ dh2, T* __restrict__ dx,
               T* __restrict__ dres, float* __restrict__ part, int rows, int H, int per_block,
               uint32_t seed, uint32_t thresh, float scale, int drop, int p_dt) {
  extern __shared__ float sm[];
  float* xh_s = sm;           // [H] x-hat of the row
  float* dyw_s = xh_s + H;    // [H] dy * w of the row
  float* dw_s = dyw_s + H;    // [H] this block's sum of dy * x-hat
  float* db_s = dw_s + H;     // [H] this block's sum of dy
  __shared__ float red[32];
  for (int c = threadIdx.x; c < H; c += blockDim.x) dw_s[c] = db_s[c] = 0.f;

  const int r0 = blockIdx.x * per_block;
  const int r1 = min(r0 + per_block, rows);
  for (int row = r0; row < r1; ++row) {
    const size_t base = static_cast<size_t>(row) * H;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < H; c += blockDim.x) {
      const float xh = (to_f32(h[base + c]) - mu) * rs;
      const float g = to_f32(dy[base + c]);
      const float dyw = g * load_param(w, c, p_dt);
      xh_s[c] = xh;
      dyw_s[c] = dyw;
      s1 += dyw;
      s2 += dyw * xh;
      dw_s[c] += g * xh;
      db_s[c] += g;
    }
    const float m1 = block_sum(s1, red) / static_cast<float>(H);
    const float m2 = block_sum(s2, red) / static_cast<float>(H);
    for (int c = threadIdx.x; c < H; c += blockDim.x) {
      float d = rs * (dyw_s[c] - m1 - xh_s[c] * m2);
      if (dh2 != nullptr) d += to_f32(dh2[base + c]);
      store(dres + base + c, d);
      if (drop) d = d * (keep(seed, static_cast<uint32_t>(row), static_cast<uint32_t>(c), thresh) ? scale : 0.f);
      store(dx + base + c, d);
    }
  }
  float* pw = part + static_cast<size_t>(blockIdx.x) * H;
  float* pb = part + static_cast<size_t>(gridDim.x + blockIdx.x) * H;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    pw[c] = dw_s[c];
    pb[c] = db_s[c];
  }
}

// dw[c] = sum over blocks of part[0][blk][c], db likewise, in block order
__global__ void __launch_bounds__(kMaxThreads)
dal_bwd_reduce(const float* __restrict__ part, float* __restrict__ dw, float* __restrict__ db,
               int blocks, int H) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  float sw = 0.f, sb = 0.f;
  for (int k = 0; k < blocks; ++k) {
    sw += part[static_cast<size_t>(k) * H + c];
    sb += part[static_cast<size_t>(blocks + k) * H + c];
  }
  dw[c] = sw;
  db[c] = sb;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* res, const void* w, const void* b, void* y,
                       void* h, float* mean, float* rstd, int rows, int H, uint32_t seed,
                       uint32_t thresh, float scale, int drop, float eps, int p_dt,
                       cudaStream_t st) {
  auto kern = dal_fwd_kernel<T>;
  const size_t smem = sizeof(float) * H;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<rows, block_threads(H), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), w, b, static_cast<T*>(y),
      static_cast<T*>(h), mean, rstd, H, seed, thresh, scale, drop, eps, p_dt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* h, const float* mean, const float* rstd, const void* w,
                       const void* dy, const void* dh2, void* dx, void* dres, float* part,
                       float* dw, float* db, int rows, int H, int per_block, uint32_t seed,
                       uint32_t thresh, float scale, int drop, int p_dt, cudaStream_t st) {
  auto kern = dal_bwd_kernel<T>;
  const size_t smem = sizeof(float) * 4 * H;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + per_block - 1) / per_block;
  kern<<<blocks, block_threads(H), smem, st>>>(
      static_cast<const T*>(h), mean, rstd, w, static_cast<const T*>(dy),
      static_cast<const T*>(dh2), static_cast<T*>(dx), static_cast<T*>(dres), part, rows, H,
      per_block, seed, thresh, scale, drop, p_dt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dal_bwd_reduce<<<(H + kMaxThreads - 1) / kMaxThreads, kMaxThreads, 0, st>>>(part, dw, db,
                                                                             blocks, H);
  return cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (dtype == kF32)
    return launch_fwd<float>(x, res, w, b, y, h, m, r, rows, H, seed, thresh, scale, drop, eps,
                             p_dtype, st);
  return launch_fwd<__nv_bfloat16>(x, res, w, b, y, h, m, r, rows, H, seed, thresh, scale, drop,
                                   eps, p_dtype, st);
}

extern "C" int prt_dal_bwd(const void* h, const void* mean, const void* rstd, const void* w,
                           const void* dy, const void* dh2, void* dx, void* dres, void* part,
                           void* dw, void* db, int rows, int H, int per_block, uint32_t seed,
                           uint32_t thresh, float scale, int drop, int dtype, int p_dtype,
                           void* stream) {
  if (rows <= 0 || H <= 0 || H > kMaxH || per_block <= 0 || bad_type(dtype) ||
      bad_type(p_dtype) || (rows + per_block - 1) / per_block > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  float* gw = static_cast<float*>(dw);
  float* gb = static_cast<float*>(db);
  if (dtype == kF32)
    return launch_bwd<float>(h, m, r, w, dy, dh2, dx, dres, pt, gw, gb, rows, H, per_block, seed,
                             thresh, scale, drop, p_dtype, st);
  return launch_bwd<__nv_bfloat16>(h, m, r, w, dy, dh2, dx, dres, pt, gw, gb, rows, H, per_block,
                                   seed, thresh, scale, drop, p_dtype, st);
}

extern "C" const char* prt_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
