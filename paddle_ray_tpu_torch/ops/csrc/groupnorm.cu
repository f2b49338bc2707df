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
// Two routes, chosen by shape alone in `ops/groupnorm.py:group_norm_plan`:
//
// CLUSTER (the main path; C * itemsize a multiple of 16 bytes, 16-byte
// aligned tensors, a slice that fits a cluster's shared memory):
//   * a thread-block cluster of K blocks (K <= 16) owns a (sample, group-set)
//     slice: a run of whole groups whose width in bytes is a multiple of 16
//     (4 groups of cpg 10 in bf16: 80 bytes); the plan takes 32 (a sector)
//     for the forward where the slice still fits, since blocks that share a
//     sector of each row read and write it twice.  Its blocks split the slice's
//     rows; each copies its rows x the group-set's channels ONCE from device
//     memory into shared memory by 16-byte `cp.async` (LDGSTS), in 4 commit
//     groups, and starts summing the first while the rest arrive;
//   * a thread owns one 16-byte vector of channels (8 bf16 or 4 f32) over a
//     stride of rows (the "row lanes"), and reads only the vectors it copied
//     itself, so no barrier stands between a copy and its use.  Its
//     per-channel sums sit in registers; the block sums them per group over
//     its (row lane, channel) pairs (the backward per channel first), then the
//     cluster exchanges the K partials over distributed shared memory
//     (`mapa` / `ld.shared::cluster`), every block adding them in rank order:
//     all blocks hold the same bits;
//   * forward: the mean, then the centred sum of squares from shared memory,
//     the same exchange, rstd; rank 0 writes mu and rstd; y = act(x * a_mul +
//     a_add) from shared memory, stored 16 bytes a thread.  One read of x and
//     one write of y a call;
//   * backward: x and dy both resident; per-channel sums of dw and dw * x-hat
//     (dw the gradient at the pre-activation), from which every other sum
//     follows, exchanged the same way (rank 0 writes dgamma_part, dbeta_part,
//     ds, dt for its (n, channels)); the group means m1, m2; dx from shared
//     memory.  One read of x and dy, one write of dx;
//   * a block's last remote read is followed by a cluster arrive, and the
//     block waits on the cluster barrier only at its end, so its epilogue
//     overlaps the others' exchange.
// ROWWISE (C * itemsize not a multiple of 16, an unaligned tensor, or a slice
// past a cluster's shared memory): the first design, one block per (sample,
// group), one channel a thread; the forward walks x three times, the
// backward x and dy twice, the later walks mostly from L2.
//
// On either route the backward's dgamma / dbeta are per-sample partials that a
// second small kernel sums over N in a fixed order (two launches a backward
// call, one a forward call).  Every reduction has a fixed order, so results
// repeat bit for bit.

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

// 1 / (1 + e^-v) by the special-function unit (ex2 and rcp): a few ulp, and 0
// where e^-v overflows.  expf and an IEEE division made the cluster kernels'
// SiLU cases 1.15-1.6x slower on the H100 (PERF.md, PR 12); both routes use
// this one so that they compute the same function.
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

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

// ---------------------------------------------------------------------------
// the cluster route (see the file's header)
// ---------------------------------------------------------------------------
constexpr int kClusterThreads = 256;  // the most threads of a cluster-route block
constexpr int kClusterMax = 16;       // a non-portable cluster size on the H100
constexpr int kChunks = 4;            // cp.async commit groups a block
constexpr int kSmemBlockMax = 232448;


// a (sample, group-set) slice and its split over a cluster, from the plan
struct Plan {
  int rows, C, G, cpg;
  int gpset, W, Wv, n_gsets;  // groups, channels and 16-byte vectors of a group-set
  int K, rows_b, lanes, T;    // cluster size, rows a block, row lanes, worker threads
  float cnt;                  // elements of a group
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the cluster barrier, split: arrive (release) and wait (acquire); every
// thread of every block of the cluster takes both
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// a barrier of the cluster (of the block alone for a cluster of one)
__device__ __forceinline__ void cluster_sync(int K) {
  if (K > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}
// a float of block `rank`'s shared memory at the offset of `p` in this block's
__device__ __forceinline__ float ld_cluster(const float* p, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}
// the sum of `p`'s float over the K blocks of the cluster in rank order, the
// same bits in every block; the K loads are issued before the first add
__device__ __forceinline__ float cluster_sum(const float* p, int K) {
  if (K == 1) return *p;
  float v[kClusterMax];
#pragma unroll
  for (int r = 0; r < kClusterMax; ++r) v[r] = r < K ? ld_cluster(p, r) : 0.f;
  float s = v[0];
#pragma unroll
  for (int r = 1; r < kClusterMax; ++r)
    if (r < K) s += v[r];
  return s;
}

// the sum over a warp's lanes, the same bits in every lane (each butterfly
// step adds the same two values, in either order)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of T as floats, and back
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// Shared memory, in order (each region a multiple of 16 bytes): the resident
// tiles [arrays][rows_b][Wv] 16-byte vectors; red [lanes][W] f32 (the row
// lanes' per-channel sums); prm [4][W] f32 (gamma, beta, s, t of the
// group-set's channels); red2 [kClusterThreads] f32; then forward part
// [2][gp4] and stat [2][gp4], backward part [2][W], tot [2][W] and stat
// [2][gp4], gp4 the group-set's groups rounded up to 4.
__host__ __device__ inline size_t cluster_tile_bytes(const Plan& p, int arrays, int es) {
  return static_cast<size_t>(arrays) * p.rows_b * p.W * es;
}
__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline size_t cluster_smem_bytes(const Plan& p, bool bwd, int es) {
  const size_t floats = static_cast<size_t>(p.lanes) * p.W + 4 * p.W + kClusterThreads +
                        (bwd ? 4 * p.W + 2 * round4(p.gpset) : 4 * round4(p.gpset));
  return cluster_tile_bytes(p, bwd ? 2 : 1, es) + sizeof(float) * floats;
}

struct Smem {
  uint4* tile;  // x, then (backward) dy
  float *red, *prm, *red2, *part, *tot, *stat;
};

template <typename T>
__device__ __forceinline__ Smem smem_of(unsigned char* base, const Plan& p, bool bwd) {
  Smem m;
  m.tile = reinterpret_cast<uint4*>(base);
  m.red = reinterpret_cast<float*>(base + cluster_tile_bytes(p, bwd ? 2 : 1, sizeof(T)));
  m.prm = m.red + static_cast<size_t>(p.lanes) * p.W;
  m.red2 = m.prm + 4 * p.W;
  m.part = m.red2 + kClusterThreads;
  m.tot = m.part + (bwd ? 2 * p.W : 0);
  m.stat = bwd ? m.tot + 2 * p.W : m.part + 2 * round4(p.gpset);
  return m;
}

// the thread's place in its block: vector column v, row lane l, the rows of
// the slice it owns (l + k * lanes for k < nk), and the chunk length in k
struct Owner {
  int v, l, nk, kc;
  bool worker;
};

__device__ __forceinline__ Owner owner_of(const Plan& p, int nrows) {
  Owner o;
  o.worker = static_cast<int>(threadIdx.x) < p.T;
  o.v = threadIdx.x % p.Wv;
  o.l = threadIdx.x / p.Wv;
  o.nk = o.worker && o.l < nrows ? (nrows - 1 - o.l) / p.lanes + 1 : 0;
  o.kc = ((p.rows_b + p.lanes - 1) / p.lanes + kChunks - 1) / kChunks;
  return o;
}

// copy the thread's vectors of `src` (at row 0 of the block, the thread's
// first channel) into `tile`, one commit group a chunk of k
template <typename T>
__device__ __forceinline__ void issue_copies(uint4* tile, const T* src, int chunk, const Owner& o,
                                             const Plan& p) {
  for (int k = chunk * o.kc; k < min((chunk + 1) * o.kc, o.nk); ++k) {
    const int r = o.l + k * p.lanes;
    cp_async16(tile + static_cast<size_t>(r) * p.Wv + o.v, src + static_cast<size_t>(r) * p.C);
  }
}

// wait for the thread's own copies of chunk `chunk` (a constant after unrolling)
__device__ __forceinline__ void wait_chunk(int chunk) {
  if (chunk == 0) cp_wait<kChunks - 1>();
  else if (chunk == 1) cp_wait<kChunks - 2>();
  else if (chunk == 2) cp_wait<kChunks - 3>();
  else cp_wait<0>();
}

// prm = gamma, beta (and s, t of sample n) of the group-set's W channels, as
// floats; read after the next barrier
__device__ __forceinline__ void load_params(float* prm, const void* gamma, const void* beta,
                                            const void* s, const void* t, int n, int gs,
                                            const Plan& p, int p_dt, int s_dt) {
  for (int c = threadIdx.x; c < p.W; c += blockDim.x) {
    const int ch = gs * p.W + c;
    prm[c] = load_param(gamma, ch, p_dt);
    prm[p.W + c] = load_param(beta, ch, p_dt);
    if (s != nullptr) {
      const size_t nc = static_cast<size_t>(n) * p.C + ch;
      prm[2 * p.W + c] = load_param(s, nc, s_dt);
      prm[3 * p.W + c] = load_param(t, nc, s_dt);
    }
  }
}

// out[c] = the block's sum of channel c over its row lanes, in a fixed order:
// each worker's E sums go to red[lane][channel]; P = blockDim / W strips of
// threads sum every P-th lane of a channel into red2, then one thread a
// channel adds the P strips.  Ends behind a barrier.
template <int E>
__device__ __forceinline__ void channel_sums(const float (&acc)[E], const Smem& m, float* out,
                                             const Plan& p, const Owner& o) {
  if (o.worker) {
    float4* dst = reinterpret_cast<float4*>(m.red + static_cast<size_t>(o.l) * p.W + o.v * E);
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncthreads();
  const int P = max(1, static_cast<int>(blockDim.x) / p.W);
  for (int i = threadIdx.x; i < P * p.W; i += blockDim.x) {
    const int c = i % p.W;
    float s0 = 0.f, s1 = 0.f;
    int l = i / p.W;
    for (; l + P < p.lanes; l += 2 * P) {
      s0 += m.red[static_cast<size_t>(l) * p.W + c];
      s1 += m.red[static_cast<size_t>(l + P) * p.W + c];
    }
    if (l < p.lanes) s0 += m.red[static_cast<size_t>(l) * p.W + c];
    (P == 1 ? out[c] : m.red2[i]) = s0 + s1;
  }
  __syncthreads();
  if (P > 1) {
    for (int c = threadIdx.x; c < p.W; c += blockDim.x) {
      float s = 0.f;
      for (int q = 0; q < P; ++q) s += m.red2[q * p.W + c];
      out[c] = s;
    }
    __syncthreads();
  }
}

// part[g] = the block's sum of group g's channels over its row lanes, straight
// from the workers' per-channel sums: wpg = warps / gpset warps a group each
// sum a fixed stride of its (lane, channel) pairs, a warp's lanes by
// butterfly, then the group's warps in order.  Ends behind a barrier.
template <int E>
__device__ __forceinline__ void group_sums(const float (&acc)[E], const Smem& m, float* part,
                                           const Plan& p, const Owner& o) {
  if (o.worker) {
    float4* dst = reinterpret_cast<float4*>(m.red + static_cast<size_t>(o.l) * p.W + o.v * E);
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int wpg = max(1, nw / p.gpset);
  const int n_e = p.lanes * p.cpg;
  for (int gw = warp; gw < p.gpset * wpg; gw += nw) {
    const int g = gw / wpg;
    float s = 0.f;
    for (int e = (gw % wpg) * 32 + lane; e < n_e; e += wpg * 32) {
      const int l = e / p.cpg;
      s += m.red[static_cast<size_t>(l) * p.W + g * p.cpg + (e - l * p.cpg)];
    }
    s = warp_sum(s);
    if (lane == 0) m.red2[gw] = s;
  }
  __syncthreads();
  if (threadIdx.x < p.gpset) {
    float s = 0.f;
    for (int q = 0; q < wpg; ++q) s += m.red2[threadIdx.x * wpg + q];
    part[threadIdx.x] = s;
  }
  __syncthreads();
}

// forward: grid K x group-sets x N in clusters of K, one cluster a (sample,
// group-set); three blocks an SM by registers (the shared memory may allow
// fewer)
template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 3)
gn_fwd_cluster_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                      const void* __restrict__ beta, const void* __restrict__ s,
                      const void* __restrict__ t, T* __restrict__ y, float* __restrict__ mu_out,
                      float* __restrict__ rstd_out, Plan p, float eps, int silu, int p_dt,
                      int s_dt) {
  constexpr int E = 16 / sizeof(T);
  static_assert(kChunks == 4, "wait_chunk unrolls four chunks");
  extern __shared__ __align__(16) unsigned char gn_smem[];
  const Smem m = smem_of<T>(gn_smem, p, false);
  const int gp4 = round4(p.gpset);
  const unsigned rank = cluster_rank();
  const int cl = blockIdx.x / p.K;
  const int gs = cl % p.n_gsets, n = cl / p.n_gsets;
  const int row0 = static_cast<int>(rank) * p.rows_b;
  const int nrows = max(0, min(p.rows_b, p.rows - row0));
  const Owner o = owner_of(p, nrows);
  const int c0 = gs * p.W + o.v * E;  // the thread's first channel
  const size_t base = (static_cast<size_t>(n) * p.rows + row0) * p.C + c0;

#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    issue_copies(m.tile, x + base, j, o, p);
    cp_commit();
  }
  load_params(m.prm, gamma, beta, s, t, n, gs, p, p_dt, s_dt);
  // the mean: sum each chunk as it lands
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    wait_chunk(j);
    for (int k = j * o.kc; k < min((j + 1) * o.kc, o.nk); ++k) {
      float f[E];
      unpack(m.tile[static_cast<size_t>(o.l + k * p.lanes) * p.Wv + o.v], f);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += f[e];
    }
  }
  float* stat = m.stat;  // [2][gp4]: mean, rstd
  group_sums(acc, m, m.part, p, o);
  cluster_sync(p.K);
  if (threadIdx.x < p.gpset) stat[threadIdx.x] = cluster_sum(m.part + threadIdx.x, p.K) / p.cnt;
  __syncthreads();

  // the centred variance, from shared memory
  float mean[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    mean[e] = stat[(o.v * E + e) / p.cpg];
    acc[e] = 0.f;
  }
  for (int k = 0; k < o.nk; ++k) {
    float f[E];
    unpack(m.tile[static_cast<size_t>(o.l + k * p.lanes) * p.Wv + o.v], f);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = f[e] - mean[e];
      acc[e] += d * d;
    }
  }
  group_sums(acc, m, m.part + gp4, p, o);
  cluster_sync(p.K);
  if (threadIdx.x < p.gpset) {
    const float q = cluster_sum(m.part + gp4 + threadIdx.x, p.K);
    const float rs = rsqrtf(q / p.cnt + eps);
    stat[gp4 + threadIdx.x] = rs;
    if (rank == 0) {
      const size_t ng = static_cast<size_t>(n) * p.G + gs * p.gpset + threadIdx.x;
      mu_out[ng] = stat[threadIdx.x];
      rstd_out[ng] = rs;
    }
  }
  if (p.K > 1) cluster_arrive();  // no read of another block's shared memory after here
  __syncthreads();

  // y = act(x * a_mul + a_add), the affine and modulation folded per channel
  if (o.worker) {
    float a_mul[E], a_add[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = o.v * E + e, g = c / p.cpg;
      a_mul[e] = stat[gp4 + g] * m.prm[c];
      a_add[e] = m.prm[p.W + c] - stat[g] * a_mul[e];
      if (s != nullptr) {
        const float mod_s = 1.f + m.prm[2 * p.W + c];
        a_add[e] = a_add[e] * mod_s + m.prm[3 * p.W + c];
        a_mul[e] = a_mul[e] * mod_s;
      }
    }
    T* dst = y + base;
    for (int k = 0; k < o.nk; ++k) {
      const int r = o.l + k * p.lanes;
      float f[E];
      unpack(m.tile[static_cast<size_t>(r) * p.Wv + o.v], f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float w = f[e] * a_mul[e] + a_add[e];
        if (silu) w = w * sigmoid(w);
        f[e] = w;
      }
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * p.C) = pack(f);
    }
  }
  if (p.K > 1) cluster_wait();  // no block leaves while another may read its shared memory
}

// backward: the same grid; MOD (scale and shift given) a template parameter.
// With w = x-hat * gw + bw the pre-activation (gw = gamma (1 + s), bw = beta
// (1 + s) + t) and dw its gradient, a thread sums per channel only S0 = sum
// dw and S1 = sum dw x-hat: dz = dw (1 + s) and z = x-hat gamma + beta give
// every other sum of the JAX backward from these two (dbeta_part = (1 + s)
// S0, dgamma_part = (1 + s) S1, ds = gamma S1 + beta S0, dt = S0), and dz
// gamma = dw gw.
template <typename T, bool MOD>
__global__ void __launch_bounds__(kClusterThreads, 2)
gn_bwd_cluster_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                      const void* __restrict__ beta, const void* __restrict__ s,
                      const void* __restrict__ t, const float* __restrict__ mu,
                      const float* __restrict__ rstd, const T* __restrict__ dy,
                      T* __restrict__ dx, float* __restrict__ dgamma_part,
                      float* __restrict__ dbeta_part, float* __restrict__ ds,
                      float* __restrict__ dt, Plan p, int silu, int p_dt, int s_dt) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char gn_smem[];
  const Smem m = smem_of<T>(gn_smem, p, true);
  const int gp4 = round4(p.gpset);
  const unsigned rank = cluster_rank();
  const int cl = blockIdx.x / p.K;
  const int gs = cl % p.n_gsets, n = cl / p.n_gsets;
  const int row0 = static_cast<int>(rank) * p.rows_b;
  const int nrows = max(0, min(p.rows_b, p.rows - row0));
  uint4* tile_x = m.tile;
  uint4* tile_dy = m.tile + static_cast<size_t>(p.rows_b) * p.Wv;
  const Owner o = owner_of(p, nrows);
  const int c0 = gs * p.W + o.v * E;
  const size_t base = (static_cast<size_t>(n) * p.rows + row0) * p.C + c0;

#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    issue_copies(tile_x, x + base, j, o, p);
    issue_copies(tile_dy, dy + base, j, o, p);
    cp_commit();
  }
  load_params(m.prm, gamma, beta, s, t, n, gs, p, p_dt, s_dt);
  // 1 + s of group-set channel c
  auto mod_s = [&](int c) { return MOD ? 1.f + m.prm[2 * p.W + c] : 1.f; };
  // per channel: the group's statistics, gw and bw
  float mean[E], rs[E], gw[E], bw[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const size_t ng = static_cast<size_t>(n) * p.G + gs * p.gpset + (o.v * E + e) / p.cpg;
    mean[e] = o.worker ? mu[ng] : 0.f;
    rs[e] = o.worker ? rstd[ng] : 0.f;
  }
  __syncthreads();  // prm
  const int cv = o.worker ? o.v * E : 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float ms = mod_s(cv + e);
    gw[e] = m.prm[cv + e] * ms;
    bw[e] = MOD ? m.prm[p.W + cv + e] * ms + m.prm[3 * p.W + cv + e] : m.prm[p.W + cv + e];
  }
  // dw of one element (x-hat, dy, channel e)
  auto grad = [&](float xhat, float d, int e) {
    if (!silu) return d;
    const float w = xhat * gw[e] + bw[e];
    const float sg = sigmoid(w);
    return d * sg * (1.f + w * (1.f - sg));
  };
  float s0[E], s1[E];
#pragma unroll
  for (int e = 0; e < E; ++e) s0[e] = s1[e] = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    wait_chunk(j);
    for (int k = j * o.kc; k < min((j + 1) * o.kc, o.nk); ++k) {
      const size_t i = static_cast<size_t>(o.l + k * p.lanes) * p.Wv + o.v;
      float fx[E], fd[E];
      unpack(tile_x[i], fx);
      unpack(tile_dy[i], fd);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xhat = (fx[e] - mean[e]) * rs[e];
        const float dw = grad(xhat, fd[e], e);
        s0[e] += dw;
        s1[e] += dw * xhat;
      }
    }
  }
  channel_sums(s0, m, m.part, p, o);
  channel_sums(s1, m, m.part + p.W, p, o);
  cluster_sync(p.K);
  // the cluster's S0 and S1 a channel, the K parts in rank order
  for (int i = threadIdx.x; i < 2 * p.W; i += blockDim.x) m.tot[i] = cluster_sum(m.part + i, p.K);
  if (p.K > 1) cluster_arrive();  // no read of another block's shared memory after here
  __syncthreads();
  if (rank == 0)
    for (int c = threadIdx.x; c < p.W; c += blockDim.x) {
      const float S0 = m.tot[c], S1 = m.tot[p.W + c], ms = mod_s(c);
      const size_t nc = static_cast<size_t>(n) * p.C + gs * p.W + c;
      dbeta_part[nc] = ms * S0;
      dgamma_part[nc] = ms * S1;
      if (MOD) {
        ds[nc] = m.prm[c] * S1 + m.prm[p.W + c] * S0;
        dt[nc] = S0;
      }
    }
  // the group means m1, m2 of dz * gamma and dz * gamma * x-hat: a warp a
  // group, its lanes by butterfly
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
    for (int g = warp; g < p.gpset; g += nw) {
      float v1 = 0.f, v2 = 0.f;
      for (int c = g * p.cpg + lane; c < (g + 1) * p.cpg; c += 32) {
        const float gwc = m.prm[c] * mod_s(c);
        v1 += m.tot[c] * gwc;
        v2 += m.tot[p.W + c] * gwc;
      }
      v1 = warp_sum(v1);
      v2 = warp_sum(v2);
      if (lane == 0) {
        m.stat[g] = v1 / p.cnt;
        m.stat[gp4 + g] = v2 / p.cnt;
      }
    }
  }
  __syncthreads();

  // dx = rstd * (dz * gamma - m1 - x-hat * m2), dz * gamma = dw * gw, from
  // shared memory
  if (o.worker) {
    float m1[E], m2[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int g = (o.v * E + e) / p.cpg;
      m1[e] = m.stat[g];
      m2[e] = m.stat[gp4 + g];
    }
    T* dst = dx + base;
    for (int k = 0; k < o.nk; ++k) {
      const int r = o.l + k * p.lanes;
      const size_t i = static_cast<size_t>(r) * p.Wv + o.v;
      float fx[E], fd[E];
      unpack(tile_x[i], fx);
      unpack(tile_dy[i], fd);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xhat = (fx[e] - mean[e]) * rs[e];
        fx[e] = rs[e] * (grad(xhat, fd[e], e) * gw[e] - m1[e] - xhat * m2[e]);
      }
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * p.C) = pack(fx);
    }
  }
  if (p.K > 1) cluster_wait();  // no block leaves while another may read its shared memory
}

bool bad_shape(int N, int rows, int C, int G) {
  return N <= 0 || rows <= 0 || C <= 0 || G <= 0 || C % G != 0 ||
         static_cast<long long>(N) * G > 0x7fffffffLL;
}

bool bad_type(int dt) { return dt != kF32 && dt != kBF16; }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta, const void* s,
                       const void* t, void* y, float* mu, float* rstd, int N, int rows, int C,
                       int G, float eps, int silu, int p_dt, int s_dt, cudaStream_t st) {
  gn_fwd_kernel<T><<<N * G, block_threads(C / G), 0, st>>>(
      static_cast<const T*>(x), gamma, beta, s, t, static_cast<T*>(y), mu, rstd, rows, C, G, eps,
      silu, p_dt, s_dt);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* dgamma_part, const float* dbeta_part, float* dgamma,
                          float* dbeta, int N, int C, cudaStream_t st) {
  gn_bwd_reduce_kernel<<<(C + kMaxThreads - 1) / kMaxThreads, kMaxThreads, 0, st>>>(
      dgamma_part, dbeta_part, dgamma, dbeta, N, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* beta, const void* s,
                       const void* t, const float* mu, const float* rstd, const void* dy,
                       void* dx, float* dgamma_part, float* dbeta_part, float* ds, float* dt,
                       int N, int rows, int C, int G, int silu, int p_dt, int s_dt,
                       cudaStream_t st) {
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
  return cudaGetLastError();
}

// The cluster route's Plan from the wrapper's numbers (groups a set, cluster
// size, rows a block, row lanes, dynamic shared memory), or false where they
// do not describe a plan the kernels take: the block must have a thread for
// each group of its set (the statistics are written one group a thread), and
// `smem` must be this layout's `cluster_smem_bytes`.
bool make_plan(int N, int rows, int C, int G, int es, int gpset, int K, int rows_b, int lanes,
               int smem, bool bwd, Plan* p) {
  if (gpset <= 0 || G % gpset != 0 || K < 1 || K > kClusterMax || rows_b < 1 || lanes < 1 ||
      (static_cast<long long>(C) * es) % 16 != 0)
    return false;
  const int E = 16 / es, cpg = C / G;
  const long long W = static_cast<long long>(gpset) * cpg;
  if ((W * es) % 16 != 0 || static_cast<long long>(K) * rows_b < rows) return false;
  p->rows = rows;
  p->C = C;
  p->G = G;
  p->cpg = cpg;
  p->gpset = gpset;
  p->W = static_cast<int>(W);
  p->Wv = static_cast<int>(W / E);
  p->n_gsets = G / gpset;
  p->K = K;
  p->rows_b = rows_b;
  p->lanes = lanes;
  p->T = p->Wv * lanes;
  p->cnt = static_cast<float>(rows) * static_cast<float>(cpg);
  if (p->T > kClusterThreads || gpset > (p->T + 31) / 32 * 32 ||
      static_cast<long long>(K) * p->n_gsets * N > 0x7fffffffLL)
    return false;
  return smem >= 0 && static_cast<size_t>(smem) == cluster_smem_bytes(*p, bwd, es) &&
         smem <= kSmemBlockMax;
}

// a launch configuration of grid K x group-sets x N in clusters of K
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  ClusterLaunch(const Plan& p, int N, size_t smem, cudaStream_t st) : cfg{} {
    cfg.gridDim = dim3(static_cast<unsigned>(p.K) * p.n_gsets * N);
    cfg.blockDim = dim3((p.T + 31) / 32 * 32);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = p.K > 1 ? 1 : 0;  // a cluster of one block launches as a plain grid
  }
};

// the kernel's attributes for a launch of `smem` bytes in clusters of K
template <typename Kern>
cudaError_t prepare_cluster(Kern kern, size_t smem, int K) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && K > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename T>
cudaError_t launch_fwd_cluster(const void* x, const void* gamma, const void* beta, const void* s,
                               const void* t, void* y, float* mu, float* rstd, int N,
                               const Plan& p, size_t smem, float eps, int silu, int p_dt,
                               int s_dt, cudaStream_t st) {
  auto kern = &gn_fwd_cluster_kernel<T>;
  cudaError_t err = prepare_cluster(kern, smem, p.K);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(p, N, smem, st);
  err = cudaLaunchKernelEx(&l.cfg, kern, static_cast<const T*>(x), gamma, beta, s, t,
                           static_cast<T*>(y), mu, rstd, p, eps, silu, p_dt, s_dt);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool MOD>
cudaError_t launch_bwd_cluster(const void* x, const void* gamma, const void* beta, const void* s,
                               const void* t, const float* mu, const float* rstd, const void* dy,
                               void* dx, float* dgamma_part, float* dbeta_part, float* ds,
                               float* dt, int N, const Plan& p, size_t smem, int silu, int p_dt,
                               int s_dt, cudaStream_t st) {
  auto kern = &gn_bwd_cluster_kernel<T, MOD>;
  cudaError_t err = prepare_cluster(kern, smem, p.K);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(p, N, smem, st);
  err = cudaLaunchKernelEx(&l.cfg, kern, static_cast<const T*>(x), gamma, beta, s, t, mu, rstd,
                           static_cast<const T*>(dy), static_cast<T*>(dx), dgamma_part,
                           dbeta_part, ds, dt, p, silu, p_dt, s_dt);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t bwd_cluster(const void* x, const void* gamma, const void* beta, const void* s,
                        const void* t, const float* mu, const float* rstd, const void* dy,
                        void* dx, float* gp, float* bp, float* fs, float* ft, int N,
                        const Plan& p, size_t smem, int silu, int p_dt, int s_dt,
                        cudaStream_t st) {
  if (s != nullptr)
    return launch_bwd_cluster<T, true>(x, gamma, beta, s, t, mu, rstd, dy, dx, gp, bp, fs, ft, N,
                                       p, smem, silu, p_dt, s_dt, st);
  return launch_bwd_cluster<T, false>(x, gamma, beta, s, t, mu, rstd, dy, dx, gp, bp, fs, ft, N,
                                      p, smem, silu, p_dt, s_dt, st);
}

}  // namespace

// C entries bound with ctypes.  Type codes: 0 = float32, 1 = bfloat16;
// x_dt for x and y (dy and dx), p_dt for gamma and beta, s_dt for s and t
// (null s and t: no modulation).  act: 0 = none, 1 = silu.  route: 0 =
// rowwise, 1 = cluster with the plan (gpset, K, rows_b, lanes, smem) of
// `ops/groupnorm.py:group_norm_plan`.  They return the cudaError_t of the
// launches (0 on success; cudaErrorInvalidValue for arguments or a plan the
// kernels do not take) and do not synchronise.
extern "C" int prt_group_norm_fwd(const void* x, const void* gamma, const void* beta,
                                  const void* s, const void* t, void* y, void* mu, void* rstd,
                                  int N, int rows, int C, int G, float eps, int act, int x_dt,
                                  int p_dt, int s_dt, int route, int gpset, int K, int rows_b,
                                  int lanes, int smem, void* stream) {
  if (bad_shape(N, rows, C, G) || (s == nullptr) != (t == nullptr) || (act != 0 && act != 1) ||
      bad_type(x_dt) || bad_type(p_dt) || (s != nullptr && bad_type(s_dt)) ||
      (route != 0 && route != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  if (route == 1) {
    Plan p;
    const int es = x_dt == kF32 ? 4 : 2;
    if (!make_plan(N, rows, C, G, es, gpset, K, rows_b, lanes, smem, false, &p) ||
        !aligned16(x) || !aligned16(y))
      return cudaErrorInvalidValue;
    if (x_dt == kF32)
      return launch_fwd_cluster<float>(x, gamma, beta, s, t, y, m, r, N, p, smem, eps, act, p_dt,
                                       s_dt, st);
    return launch_fwd_cluster<__nv_bfloat16>(x, gamma, beta, s, t, y, m, r, N, p, smem, eps, act,
                                             p_dt, s_dt, st);
  }
  if (x_dt == kF32)
    return launch_fwd<float>(x, gamma, beta, s, t, y, m, r, N, rows, C, G, eps, act, p_dt, s_dt, st);
  return launch_fwd<__nv_bfloat16>(x, gamma, beta, s, t, y, m, r, N, rows, C, G, eps, act, p_dt,
                                   s_dt, st);
}

extern "C" int prt_group_norm_bwd(const void* x, const void* gamma, const void* beta,
                                  const void* s, const void* t, const void* mu, const void* rstd,
                                  const void* dy, void* dx, void* dgamma_part, void* dbeta_part,
                                  void* ds, void* dt, void* dgamma, void* dbeta, int N, int rows,
                                  int C, int G, int act, int x_dt, int p_dt, int s_dt, int route,
                                  int gpset, int K, int rows_b, int lanes, int smem,
                                  void* stream) {
  if (bad_shape(N, rows, C, G) || (s == nullptr) != (t == nullptr) || (act != 0 && act != 1) ||
      bad_type(x_dt) || bad_type(p_dt) || (s != nullptr && bad_type(s_dt)) ||
      (s != nullptr && (ds == nullptr || dt == nullptr)) || (route != 0 && route != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  float* gp = static_cast<float*>(dgamma_part);
  float* bp = static_cast<float*>(dbeta_part);
  float* fs = static_cast<float*>(ds);
  float* ft = static_cast<float*>(dt);
  cudaError_t err;
  if (route == 1) {
    Plan p;
    const int es = x_dt == kF32 ? 4 : 2;
    if (!make_plan(N, rows, C, G, es, gpset, K, rows_b, lanes, smem, true, &p) ||
        !aligned16(x) || !aligned16(dy) || !aligned16(dx))
      return cudaErrorInvalidValue;
    err = x_dt == kF32 ? bwd_cluster<float>(x, gamma, beta, s, t, m, r, dy, dx, gp, bp, fs, ft, N,
                                            p, smem, act, p_dt, s_dt, st)
                       : bwd_cluster<__nv_bfloat16>(x, gamma, beta, s, t, m, r, dy, dx, gp, bp,
                                                    fs, ft, N, p, smem, act, p_dt, s_dt, st);
  } else {
    err = x_dt == kF32 ? launch_bwd<float>(x, gamma, beta, s, t, m, r, dy, dx, gp, bp, fs, ft, N,
                                           rows, C, G, act, p_dt, s_dt, st)
                       : launch_bwd<__nv_bfloat16>(x, gamma, beta, s, t, m, r, dy, dx, gp, bp, fs,
                                                   ft, N, rows, C, G, act, p_dt, s_dt, st);
  }
  if (err != cudaSuccess) return err;
  return launch_reduce(gp, bp, static_cast<float*>(dgamma), static_cast<float*>(dbeta), N, C, st);
}

extern "C" const char* prt_group_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
