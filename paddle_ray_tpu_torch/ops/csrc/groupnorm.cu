// Fused GroupNorm(+modulation)(+SiLU) forward and backward on Hopper (sm_90a),
// plain CUDA C++.
//
// Replaces the TPU kernels `paddle_ray_tpu/ops/groupnorm.py:_fwd_kernel` and
// `_bwd_kernel` (`fused_group_norm`):
//
//   y = act( GN(x; groups, gamma, beta) * (1 + s) + t )      act: none | silu
//
// with the statistics of each (sample, group) in f32: the mean first, then the
// CENTRED variance (never E[x^2] - mu^2, which cancels in f32 when |mu| >> std),
// rstd = rsqrt(var + eps).  The forward saves mu and rstd [N, G] f32; the
// backward recomputes x-hat from (x, mu, rstd) and never reads a normalised
// tensor from memory.
//
// Layouts (all contiguous):
//   x, y, dy, dx   [N, rows, C]  f32 or bf16 (channels-last; rows = H * W)
//   gamma, beta    [C]           f32 or bf16 (one type for both)
//   s, t           [N, C]        f32 or bf16 (one type for both), or null
//   mu, rstd       [N, G]        f32
//   dgamma_part,   [N, C]        f32 scratch: the per-sample partial sums
//   dbeta_part
//   ds, dt         [N, C]        f32 (only with s, t)
//   dgamma, dbeta  [C]           f32
//
// What bounds it on the H100: bytes.  About 10 operations an element against
// the card's ~295 operations per byte, so the least time is x read once and y
// written once (forward), x and dy read once and dx written once (backward),
// over 3.35 TB/s.
//
// Design (simple first):
//   * one block per (sample, group).  The TPU kernel ran one grid step per
//     sample and summed channels into groups with a [C, G] one-hot matmul,
//     because lane-dim reshapes do not lower there; here a block owns the
//     group's rows x cpg slice and indexes it directly (cpg = C / G, 10-80 in
//     the SD-UNet, not a power of two);
//   * a block's threads are `lanes` row lanes of `width` = min(cpg, 256)
//     channels (width * lanes <= 256, rounded up to whole warps; the rest
//     idle).  Each thread keeps one channel of a chunk and walks the rows of
//     its lane, so its per-channel constants sit in registers and its
//     per-channel sums need no atomics.  cpg > 256 walks the channels in
//     chunks of 256;
//   * forward: three walks over the slice (sum; centred sum of squares;
//     normalise and store), the second and third mostly from L2;
//   * backward: two walks (per-channel sums of dz and dz * x-hat, and ds, dt;
//     then dx), the per-channel sums reduced over the row lanes in shared
//     memory in a fixed order.  The TPU kernel carried dgamma / dbeta across
//     its sequential grid in scratch; blocks here run in no order, so each
//     writes its per-sample partials and a second small kernel sums them over
//     N in a fixed order: deterministic, no atomics;
//   * every reduction has a fixed order, so results repeat bit for bit.
// A group's slice is cpg contiguous elements (20-160 bytes) a row at a stride
// of C elements, so loads coalesce poorly.  Left for later: staging the slice
// in shared memory (one read of x instead of three), cp.async / TMA, and
// splitting the rows of a group over several blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kF32 = 0, kBF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// a per-channel parameter (gamma, beta, s, t): f32 or bf16 by `dt`
__device__ __forceinline__ float load_param(const void* p, size_t i, int dt) {
  return dt == kF32 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// threads of a block for `cpg` channels a group: whole warps covering
// width * lanes workers
inline int block_threads(int cpg) {
  const int width = cpg < kMaxThreads ? cpg : kMaxThreads;
  const int workers = width * (kMaxThreads / width);
  return (workers + 31) / 32 * 32;
}

// The sum of `v` over the block, the same value in every thread; `red` holds
// 32 floats of shared memory.  Fixed order: shuffles, then warps in order.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // `red` may still be read from the previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  const int warps = blockDim.x / 32;
  for (int w = 0; w < warps; ++w) s += red[w];
  return s;
}

struct Slice {
  int cpg, width, lanes;
  int cl, lane;      // this thread's channel in a chunk and its row lane
  bool worker;
  size_t base;       // offset of (n, row 0, first channel of the group)
};

__device__ __forceinline__ Slice slice_of(int rows, int C, int G) {
  Slice sl;
  const int n = blockIdx.x / G, g = blockIdx.x % G;
  sl.cpg = C / G;
  sl.width = min(sl.cpg, kMaxThreads);
  sl.lanes = kMaxThreads / sl.width;
  sl.cl = threadIdx.x % sl.width;
  sl.lane = threadIdx.x / sl.width;
  sl.worker = sl.lane < sl.lanes;
  sl.base = static_cast<size_t>(n) * rows * C + static_cast<size_t>(g) * sl.cpg;
  return sl;
}

// ---------------------------------------------------------------------------
// forward: grid N * G, one block per (sample, group)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
              const void* __restrict__ beta, const void* __restrict__ s,
              const void* __restrict__ t, T* __restrict__ y, float* __restrict__ mu_out,
              float* __restrict__ rstd_out, int rows, int C, int G, float eps, int silu,
              int p_dt, int s_dt) {
  __shared__ float red[32];
  const Slice sl = slice_of(rows, C, G);
  const int n = blockIdx.x / G, g = blockIdx.x % G;
  const T* xg = x + sl.base;
  T* yg = y + sl.base;
  const float cnt = static_cast<float>(rows) * static_cast<float>(sl.cpg);

  // walk 1: the group mean
  float acc = 0.f;
  if (sl.worker)
    for (int c = sl.cl; c < sl.cpg; c += sl.width) {
#pragma unroll 4
      for (int r = sl.lane; r < rows; r += sl.lanes) acc += to_f32(xg[static_cast<size_t>(r) * C + c]);
    }
  const float mean = block_sum(acc, red) / cnt;

  // walk 2: the centred variance
  acc = 0.f;
  if (sl.worker)
    for (int c = sl.cl; c < sl.cpg; c += sl.width) {
#pragma unroll 4
      for (int r = sl.lane; r < rows; r += sl.lanes) {
        const float d = to_f32(xg[static_cast<size_t>(r) * C + c]) - mean;
        acc += d * d;
      }
    }
  const float var = block_sum(acc, red) / cnt;
  const float rstd = rsqrtf(var + eps);
  if (threadIdx.x == 0) {
    mu_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }

  // walk 3: y = act(x * a_mul + a_add) with the affine and modulation folded
  if (!sl.worker) return;
  for (int c = sl.cl; c < sl.cpg; c += sl.width) {
    const int ch = g * sl.cpg + c;
    float a_mul = rstd * load_param(gamma, ch, p_dt);
    float a_add = load_param(beta, ch, p_dt) - mean * a_mul;
    if (s != nullptr) {
      const size_t nc = static_cast<size_t>(n) * C + ch;
      const float mod_s = 1.f + load_param(s, nc, s_dt);
      a_add = a_add * mod_s + load_param(t, nc, s_dt);
      a_mul = a_mul * mod_s;
    }
#pragma unroll 4
    for (int r = sl.lane; r < rows; r += sl.lanes) {
      const size_t i = static_cast<size_t>(r) * C + c;
      float w = to_f32(xg[i]) * a_mul + a_add;
      if (silu) w = w * sigmoid(w);
      store(yg + i, w);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: grid N * G, one block per (sample, group), then the dgamma /
// dbeta reduction over N
// ---------------------------------------------------------------------------
struct ChannelConsts {
  float gamma, beta, mod_s, shift;
};

__device__ __forceinline__ ChannelConsts channel_consts(const void* gamma, const void* beta,
                                                        const void* s, const void* t, int n,
                                                        int C, int ch, int p_dt, int s_dt) {
  ChannelConsts k;
  k.gamma = load_param(gamma, ch, p_dt);
  k.beta = load_param(beta, ch, p_dt);
  k.mod_s = 1.f;
  k.shift = 0.f;
  if (s != nullptr) {
    const size_t nc = static_cast<size_t>(n) * C + ch;
    k.mod_s = 1.f + load_param(s, nc, s_dt);
    k.shift = load_param(t, nc, s_dt);
  }
  return k;
}

// dw, the gradient at the pre-activation w = z * (1 + s) + t, and z = x-hat *
// gamma + beta: the terms of the JAX backward
__device__ __forceinline__ float grad_w(float xhat, float dy, const ChannelConsts& k,
                                        bool mod, int silu, float* z_out) {
  const float z = xhat * k.gamma + k.beta;
  *z_out = z;
  if (!silu) return dy;
  const float w = mod ? z * k.mod_s + k.shift : z;
  const float sg = sigmoid(w);
  return dy * sg * (1.f + w * (1.f - sg));
}

// smem: red [32] | part [4][kMaxThreads] | sum_dz [cpg] | sum_dzx [cpg]
inline size_t bwd_smem_bytes(int cpg) {
  return sizeof(float) * (32 + 4 * kMaxThreads + 2 * static_cast<size_t>(cpg));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
              const void* __restrict__ beta, const void* __restrict__ s,
              const void* __restrict__ t, const float* __restrict__ mu,
              const float* __restrict__ rstd, const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
              float* __restrict__ ds, float* __restrict__ dt, int rows, int C, int G, int silu,
              int p_dt, int s_dt) {
  extern __shared__ float smem[];
  float* red = smem;
  float* part = red + 32;                       // [4][kMaxThreads]
  float* sum_dz = part + 4 * kMaxThreads;       // [cpg]
  float* sum_dzx = sum_dz + (C / G);            // [cpg]

  const Slice sl = slice_of(rows, C, G);
  const int n = blockIdx.x / G, g = blockIdx.x % G;
  const bool mod = s != nullptr;
  const T* xg = x + sl.base;
  const T* dyg = dy + sl.base;
  T* dxg = dx + sl.base;
  const float m = mu[blockIdx.x], rs = rstd[blockIdx.x];
  const float cnt = static_cast<float>(rows) * static_cast<float>(sl.cpg);

  // walk 1, a chunk of `width` channels at a time: per-channel sums of dz,
  // dz * x-hat and, with modulation, dw * z and dw
  for (int c0 = 0; c0 < sl.cpg; c0 += sl.width) {
    const int c = c0 + sl.cl;
    const bool active = sl.worker && c < sl.cpg;
    float a_dz = 0.f, a_dzx = 0.f, a_ds = 0.f, a_dt = 0.f;
    if (active) {
      const ChannelConsts k = channel_consts(gamma, beta, s, t, n, C, g * sl.cpg + c, p_dt, s_dt);
#pragma unroll 4
      for (int r = sl.lane; r < rows; r += sl.lanes) {
        const size_t i = static_cast<size_t>(r) * C + c;
        const float xhat = (to_f32(xg[i]) - m) * rs;
        float z;
        const float dw = grad_w(xhat, to_f32(dyg[i]), k, mod, silu, &z);
        float dz = dw;
        if (mod) {
          a_ds += dw * z;
          a_dt += dw;
          dz = dw * k.mod_s;
        }
        a_dz += dz;
        a_dzx += dz * xhat;
      }
    }
    part[0 * kMaxThreads + threadIdx.x] = a_dz;
    part[1 * kMaxThreads + threadIdx.x] = a_dzx;
    part[2 * kMaxThreads + threadIdx.x] = a_ds;
    part[3 * kMaxThreads + threadIdx.x] = a_dt;
    __syncthreads();
    // lane 0's threads sum their channel over the row lanes, in order
    if (threadIdx.x < sl.width && c0 + threadIdx.x < sl.cpg) {
      float q[4] = {0.f, 0.f, 0.f, 0.f};
      for (int l = 0; l < sl.lanes; ++l) {
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] += part[j * kMaxThreads + l * sl.width + threadIdx.x];
      }
      const int cc = c0 + threadIdx.x;
      const size_t nc = static_cast<size_t>(n) * C + g * sl.cpg + cc;
      sum_dz[cc] = q[0];
      sum_dzx[cc] = q[1];
      dbeta_part[nc] = q[0];
      dgamma_part[nc] = q[1];
      if (mod) {
        ds[nc] = q[2];
        dt[nc] = q[3];
      }
    }
    __syncthreads();
  }

  // the group means of dz * gamma and dz * gamma * x-hat
  float v1 = 0.f, v2 = 0.f;
  for (int c = threadIdx.x; c < sl.cpg; c += blockDim.x) {
    const float gm = load_param(gamma, g * sl.cpg + c, p_dt);
    v1 += sum_dz[c] * gm;
    v2 += sum_dzx[c] * gm;
  }
  const float m1 = block_sum(v1, red) / cnt;
  const float m2 = block_sum(v2, red) / cnt;

  // walk 2: dx = rstd * (dz * gamma - m1 - x-hat * m2)
  if (!sl.worker) return;
  for (int c = sl.cl; c < sl.cpg; c += sl.width) {
    const ChannelConsts k = channel_consts(gamma, beta, s, t, n, C, g * sl.cpg + c, p_dt, s_dt);
#pragma unroll 4
    for (int r = sl.lane; r < rows; r += sl.lanes) {
      const size_t i = static_cast<size_t>(r) * C + c;
      const float xhat = (to_f32(xg[i]) - m) * rs;
      float z;
      const float dw = grad_w(xhat, to_f32(dyg[i]), k, mod, silu, &z);
      const float dz = mod ? dw * k.mod_s : dw;
      store(dxg + i, rs * (dz * k.gamma - m1 - xhat * m2));
    }
  }
}

// dgamma[c] = sum over n of dgamma_part[n, c], in the order n = 0, 1, ...
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_reduce_kernel(const float* __restrict__ dgamma_part, const float* __restrict__ dbeta_part,
                     float* __restrict__ dgamma, float* __restrict__ dbeta, int N, int C) {
  const int c = blockIdx.x * kMaxThreads + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int n = 0; n < N; ++n) {
    a += dgamma_part[static_cast<size_t>(n) * C + c];
    b += dbeta_part[static_cast<size_t>(n) * C + c];
  }
  dgamma[c] = a;
  dbeta[c] = b;
}

bool bad_shape(int N, int rows, int C, int G) {
  return N <= 0 || rows <= 0 || C <= 0 || G <= 0 || C % G != 0 ||
         static_cast<long long>(N) * G > 0x7fffffffLL;
}

bool bad_type(int dt) { return dt != kF32 && dt != kBF16; }

template <typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta, const void* s,
                       const void* t, void* y, float* mu, float* rstd, int N, int rows, int C,
                       int G, float eps, int silu, int p_dt, int s_dt, cudaStream_t st) {
  gn_fwd_kernel<T><<<N * G, block_threads(C / G), 0, st>>>(
      static_cast<const T*>(x), gamma, beta, s, t, static_cast<T*>(y), mu, rstd, rows, C, G, eps,
      silu, p_dt, s_dt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* beta, const void* s,
                       const void* t, const float* mu, const float* rstd, const void* dy,
                       void* dx, float* dgamma_part, float* dbeta_part, float* ds, float* dt,
                       float* dgamma, float* dbeta, int N, int rows, int C, int G, int silu,
                       int p_dt, int s_dt, cudaStream_t st) {
  const size_t smem = bwd_smem_bytes(C / G);
  auto kern = &gn_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<N * G, block_threads(C / G), smem, st>>>(
      static_cast<const T*>(x), gamma, beta, s, t, mu, rstd, static_cast<const T*>(dy),
      static_cast<T*>(dx), dgamma_part, dbeta_part, ds, dt, rows, C, G, silu, p_dt, s_dt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_reduce_kernel<<<(C + kMaxThreads - 1) / kMaxThreads, kMaxThreads, 0, st>>>(
      dgamma_part, dbeta_part, dgamma, dbeta, N, C);
  return cudaGetLastError();
}

}  // namespace

// C entries bound with ctypes.  Type codes: 0 = float32, 1 = bfloat16;
// x_dt for x and y (dy and dx), p_dt for gamma and beta, s_dt for s and t
// (null s and t: no modulation).  act: 0 = none, 1 = silu.  They return the
// cudaError_t of the launches (0 on success) and do not synchronise.
extern "C" int prt_group_norm_fwd(const void* x, const void* gamma, const void* beta,
                                  const void* s, const void* t, void* y, void* mu, void* rstd,
                                  int N, int rows, int C, int G, float eps, int act, int x_dt,
                                  int p_dt, int s_dt, void* stream) {
  if (bad_shape(N, rows, C, G) || (s == nullptr) != (t == nullptr) || (act != 0 && act != 1) ||
      bad_type(x_dt) || bad_type(p_dt) || (s != nullptr && bad_type(s_dt)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  if (x_dt == kF32)
    return launch_fwd<float>(x, gamma, beta, s, t, y, m, r, N, rows, C, G, eps, act, p_dt, s_dt, st);
  return launch_fwd<__nv_bfloat16>(x, gamma, beta, s, t, y, m, r, N, rows, C, G, eps, act, p_dt,
                                   s_dt, st);
}

extern "C" int prt_group_norm_bwd(const void* x, const void* gamma, const void* beta,
                                  const void* s, const void* t, const void* mu, const void* rstd,
                                  const void* dy, void* dx, void* dgamma_part, void* dbeta_part,
                                  void* ds, void* dt, void* dgamma, void* dbeta, int N, int rows,
                                  int C, int G, int act, int x_dt, int p_dt, int s_dt,
                                  void* stream) {
  if (bad_shape(N, rows, C, G) || (s == nullptr) != (t == nullptr) || (act != 0 && act != 1) ||
      bad_type(x_dt) || bad_type(p_dt) || (s != nullptr && bad_type(s_dt)) ||
      (s != nullptr && (ds == nullptr || dt == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* gp = static_cast<float*>(dgamma_part);
  float* bp = static_cast<float*>(dbeta_part);
  float* fs = static_cast<float*>(ds);
  float* ft = static_cast<float*>(dt);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (x_dt == kF32)
    return launch_bwd<float>(x, gamma, beta, s, t, m, r, dy, dx, gp, bp, fs, ft, dg, db, N, rows,
                             C, G, act, p_dt, s_dt, st);
  return launch_bwd<__nv_bfloat16>(x, gamma, beta, s, t, m, r, dy, dx, gp, bp, fs, ft, dg, db, N,
                                   rows, C, G, act, p_dt, s_dt, st);
}

extern "C" const char* prt_group_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
