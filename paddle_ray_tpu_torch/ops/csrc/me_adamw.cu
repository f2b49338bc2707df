// The MemoryEfficientAdamW update of one parameter in one launch, on Hopper
// (sm_90a), plain CUDA C++.
//
// Replaces no Pallas kernel.  The JAX package's optimizer
// (`paddle_ray_tpu/optimizer/memory_efficient.py`) is plain jnp that XLA fuses
// into a pass per leaf; the port's plain version
// (`ops/me_adamw.py:me_adamw_plain`) is about 30 tensor operations
// a leaf and, for a bfloat16 parameter without a float32 master, the threefry
// bits of its stochastic rounding as about 170 operations on int64 tensors, one
// launch each on the card.  This kernel is that whole update, bit for bit:
//
//   1. the old moments: int8 codes times the block's float32 scale (the first
//      moment, signed) and the square of uint8 codes times the scale (the second
//      moment, kept in the sqrt domain); or bfloat16 / float32 moments;
//   2. g in float32, plus an L1 (coeff * sign(p)) or L2 (coeff * p) decay;
//      m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g g, mhat = m / bc1, vhat =
//      v / bc2 (the bias corrections come from the host, in float32),
//      upd = mhat / (sqrt(vhat) + eps) + wd p, up = p - lr upd;
//   3. the new moments stored: each block of `block` flat elements quantized
//      against its absmax (max |m| / 127, max sqrt(v) / 255; the padding of the
//      last block is zeros, so the max runs over its real elements), codes
//      rint(x / max(scale, 1e-38)) clamped to [-127, 127] / [0, 255]; or the
//      moments rounded to bfloat16 or kept in float32;
//   4. the parameter: a float32 master updated and cast (round to nearest), or
//      the parameter cast, or -- bfloat16 without a master -- stochastically
//      rounded: the 16 bits below bfloat16's mantissa of up plus the low 16 bits
//      of `threefry(k0, k1, i >> 32, i)` (the two words xor'd, as
//      `core/prng.py:random_bits`) for the flat index i, truncated; a
//      non-finite up passes untouched (a NaN as XLA converts it: its sign and
//      0x7FC0).
//
// Every product, sum, quotient and square root is one IEEE float32 operation
// rounded to nearest, in the order the JAX function writes them: __fmul_rn,
// __fadd_rn, __fsub_rn (nvcc never contracts these into an FMA), __fdiv_rn
// (never a product with a reciprocal), __fsqrt_rn, rintf (half to even, as
// jnp.round).
//
// Layout: a warp takes one quantization block at a time (a grid-stride loop over
// blocks) and reduces its absmax by shuffles; lane 0 writes its scales, whose old
// values every lane reads first.  On the vector path (int8 moments, blocks of at
// most 256 elements and a multiple of 8, 16-byte aligned pointers: the main
// path's 256) a lane keeps 8 consecutive elements in registers from one 16-byte
// load of p and g (and the master) and an 8-byte load of each code to the same
// stores, so the block is read and written once and its 8 threefry hashes are
// independent.  On the general path (other blocks and alignments, bfloat16 and
// float32 moments) the lanes take the block's elements 32 apart, and with int8
// moments the warp runs the block twice: pass 1 computes the new m and v for the
// absmax, pass 2 computes them again -- the same operations on the same inputs,
// so the same bits -- and writes; pass 2's re-reads hit L1 / L2.
//
// What bounds it on the H100: with stochastic rounding, the hash, about 75
// int32 operations an element (see `threefry.cuh`), against about 10 bytes an
// element moved (p and g read, the two codes read and written, p written).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

// the arguments of one update, mirrored field for field by the ctypes structure in
// `ops/me_adamw.py` (outside the anonymous namespace: the C entry point takes it)
struct PrtMeAdamwArgs {
  void* p;            // the parameter [n], written
  const void* g;      // its gradient [n], the parameter's type
  float* master;      // float32 master [n] or null
  void* m;            // int8 codes / bfloat16 / float32 [n]
  void* v;            // uint8 codes / bfloat16 / float32 [n]
  float* m_scale;     // [ceil(n / block)] with int8 moments
  float* v_scale;
  uint64_t n;
  int64_t block;      // quantization block (flat elements a scale)
  float lr, b1, b2, omb1, omb2, bc1, bc2, eps, wd, l1, l2;
  uint32_t k0, k1;    // stochastic rounding key
  int dtype, moments, has_master, sr;
};

namespace {

using Args = PrtMeAdamwArgs;

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;          // parameter / gradient type
constexpr int kMomF32 = 0, kMomBF16 = 1, kMomInt8 = 2;  // moment storage
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

// 8 elements from 16-byte aligned memory: one 16-byte load (two for float32)
template <typename T>
__device__ __forceinline__ void load8(const T* src, float* out) {
  if constexpr (sizeof(T) == 4) {
    const float4 lo = reinterpret_cast<const float4*>(src)[0];
    const float4 hi = reinterpret_cast<const float4*>(src)[1];
    out[0] = lo.x, out[1] = lo.y, out[2] = lo.z, out[3] = lo.w;
    out[4] = hi.x, out[5] = hi.y, out[6] = hi.z, out[7] = hi.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = to_f32(e[j]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float* x) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) store(e + j, x[j]);
    *reinterpret_cast<uint4*>(dst) = u;
  }
}

struct Moments {
  float m, v;
};

// g with the L1 / L2 decay of the parameter p
__device__ __forceinline__ float decayed(const Args& a, float p, float g) {
  if (a.l1 != 0.0f) {
    const float s = p > 0.0f ? 1.0f : (p < 0.0f ? -1.0f : 0.0f);
    g = __fadd_rn(g, __fmul_rn(a.l1, s));
  }
  if (a.l2 != 0.0f) g = __fadd_rn(g, __fmul_rn(a.l2, p));
  return g;
}

// the int8 codes' old moments: the code times the scale (m), its square (v)
__device__ __forceinline__ float m_of_code(int8_t c, float s) {
  return __fmul_rn(static_cast<float>(c), s);
}
__device__ __forceinline__ float v_of_code(uint8_t c, float s) {
  const float r = __fmul_rn(static_cast<float>(c), s);
  return __fmul_rn(r, r);
}

// the new moments from the gradient and the old ones
__device__ __forceinline__ Moments step_moments(const Args& a, float g, float m0, float v0) {
  Moments r;
  r.m = __fadd_rn(__fmul_rn(a.b1, m0), __fmul_rn(a.omb1, g));
  r.v = __fadd_rn(__fmul_rn(a.b2, v0), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  return r;
}

// the updated float32 parameter
__device__ __forceinline__ float adam_up(const Args& a, float p, Moments mv) {
  const float mhat = __fdiv_rn(mv.m, a.bc1);
  const float vhat = __fdiv_rn(mv.v, a.bc2);
  float upd = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), a.eps));
  if (a.wd != 0.0f) upd = __fadd_rn(upd, __fmul_rn(a.wd, p));
  return __fsub_rn(p, __fmul_rn(a.lr, upd));
}

__device__ __forceinline__ int8_t m_code(float m, float q) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(m, q)), -127.0f), 127.0f));
}
__device__ __forceinline__ uint8_t v_code(float v, float q) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(__fdiv_rn(__fsqrt_rn(v), q)), 0.0f), 255.0f));
}

// the bfloat16 bits of up stochastically rounded with the bits of flat index i
__device__ __forceinline__ uint16_t sr_bits(const Args& a, float up, uint64_t i) {
  const uint32_t bits = __float_as_uint(up);
  const uint32_t noise = prt::threefry_bits_at(a.k0, a.k1, i) & 0xFFFFu;
  uint32_t top = isfinite(up) ? (bits + noise) >> 16 : bits >> 16;
  if (isnan(up)) top = (top & 0x8000u) | 0x7FC0u;
  return static_cast<uint16_t>(top);
}

// the element's float32 parameter and its decayed gradient
template <typename T>
__device__ __forceinline__ float2 load_pg(const Args& a, uint64_t i) {
  const float p = a.has_master ? a.master[i] : to_f32(static_cast<const T*>(a.p)[i]);
  return make_float2(p, decayed(a, p, to_f32(static_cast<const T*>(a.g)[i])));
}

// the new m and v of element i from its gradient and its old moments
__device__ __forceinline__ Moments new_moments(const Args& a, uint64_t i, float g, float ms,
                                               float vs) {
  float m0, v0;
  if (a.moments == kMomInt8) {
    m0 = m_of_code(static_cast<const int8_t*>(a.m)[i], ms);
    v0 = v_of_code(static_cast<const uint8_t*>(a.v)[i], vs);
  } else if (a.moments == kMomBF16) {
    m0 = __bfloat162float(static_cast<const __nv_bfloat16*>(a.m)[i]);
    v0 = __bfloat162float(static_cast<const __nv_bfloat16*>(a.v)[i]);
  } else {
    m0 = static_cast<const float*>(a.m)[i];
    v0 = static_cast<const float*>(a.v)[i];
  }
  return step_moments(a, g, m0, v0);
}

// max that keeps a NaN, as jnp.max does
__device__ __forceinline__ float nan_max(float x, float y) { return (x != x || x > y) ? x : y; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// the parameter (and master) written from up
template <typename T>
__device__ __forceinline__ void write_p(const Args& a, uint64_t i, float up) {
  T* pt = static_cast<T*>(a.p);
  if (a.has_master) {
    a.master[i] = up;
    store(pt + i, up);
  } else if (a.sr) {
    reinterpret_cast<uint16_t*>(pt)[i] = sr_bits(a, up, i);
  } else {
    store(pt + i, up);
  }
}

// the Adam step, the moments stored, the parameter written
template <typename T>
__device__ __forceinline__ void finish(const Args& a, uint64_t i, float p, Moments mv,
                                       float qm, float qv) {
  const float up = adam_up(a, p, mv);
  if (a.moments == kMomInt8) {
    static_cast<int8_t*>(a.m)[i] = m_code(mv.m, qm);
    static_cast<uint8_t*>(a.v)[i] = v_code(mv.v, qv);
  } else if (a.moments == kMomBF16) {
    static_cast<__nv_bfloat16*>(a.m)[i] = __float2bfloat16_rn(mv.m);
    static_cast<__nv_bfloat16*>(a.v)[i] = __float2bfloat16_rn(mv.v);
  } else {
    static_cast<float*>(a.m)[i] = mv.m;
    static_cast<float*>(a.v)[i] = mv.v;
  }
  write_p<T>(a, i, up);
}

// One quantization block of int8 moments on the vector path (block <= 256, a
// multiple of 8, every pointer aligned): each lane keeps 8 consecutive
// elements in registers from the loads to the stores, so the block is read
// once, by 16-byte loads of p, g and the master and 8-byte loads of the codes.
template <typename T>
__device__ __forceinline__ void block_vec(const Args& a, uint64_t b, int lane) {
  const uint64_t base = b * a.block;
  const uint64_t end = base + a.block < a.n ? base + a.block : a.n;
  const uint64_t i0 = base + static_cast<uint64_t>(lane) * 8;
  const int cnt = i0 >= end ? 0 : (end - i0 < 8 ? static_cast<int>(end - i0) : 8);
  const float ms = a.m_scale[b], vs = a.v_scale[b];
  float p[8], g[8], m[8], v[8];
  // the codes, 8 bytes each in a register pair
  uint2 cmu = make_uint2(0u, 0u), cvu = make_uint2(0u, 0u);
  int8_t* cm = reinterpret_cast<int8_t*>(&cmu);
  uint8_t* cv = reinterpret_cast<uint8_t*>(&cvu);
  if (cnt == 8) {
    if (a.has_master)
      load8(a.master + i0, p);
    else
      load8(static_cast<const T*>(a.p) + i0, p);
    load8(static_cast<const T*>(a.g) + i0, g);
    cmu = *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(a.m) + i0);
    cvu = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(a.v) + i0);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < cnt) {
        p[j] = a.has_master ? a.master[i0 + j] : to_f32(static_cast<const T*>(a.p)[i0 + j]);
        g[j] = to_f32(static_cast<const T*>(a.g)[i0 + j]);
        cm[j] = static_cast<const int8_t*>(a.m)[i0 + j];
        cv[j] = static_cast<const uint8_t*>(a.v)[i0 + j];
      }
    }
  }
  float am = 0.0f, av = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < cnt) {
      const Moments mv = step_moments(a, decayed(a, p[j], g[j]), m_of_code(cm[j], ms),
                                      v_of_code(cv[j], vs));
      m[j] = mv.m;
      v[j] = mv.v;
      am = nan_max(fabsf(mv.m), am);
      av = nan_max(__fsqrt_rn(mv.v), av);
    }
  }
  am = warp_max(am);
  av = warp_max(av);
  const float sm = __fdiv_rn(am, 127.0f), sv = __fdiv_rn(av, 255.0f);
  const float qm = fmaxf(sm, 1e-38f), qv = fmaxf(sv, 1e-38f);
  float up[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < cnt) {
      Moments mv;
      mv.m = m[j];
      mv.v = v[j];
      up[j] = adam_up(a, p[j], mv);
      cm[j] = m_code(m[j], qm);
      cv[j] = v_code(v[j], qv);
    }
  }
  if (cnt == 8) {
    *reinterpret_cast<uint2*>(static_cast<int8_t*>(a.m) + i0) = cmu;
    *reinterpret_cast<uint2*>(static_cast<uint8_t*>(a.v) + i0) = cvu;
    T* pt = static_cast<T*>(a.p) + i0;
    if (a.has_master) {
      store8(a.master + i0, up);
      store8(pt, up);
    } else if (a.sr) {
      uint4 u;
      uint16_t* e = reinterpret_cast<uint16_t*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = sr_bits(a, up[j], i0 + j);
      *reinterpret_cast<uint4*>(pt) = u;
    } else {
      store8(pt, up);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < cnt) {
        static_cast<int8_t*>(a.m)[i0 + j] = cm[j];
        static_cast<uint8_t*>(a.v)[i0 + j] = cv[j];
        write_p<T>(a, i0 + j, up[j]);
      }
    }
  }
  if (lane == 0) {
    a.m_scale[b] = sm;
    a.v_scale[b] = sv;
  }
}

// One block on the general path: a lane takes the block's elements 32 apart.
// With int8 moments the warp runs the block twice, pass 2 recomputing what pass
// 1 computed for the absmax (the same operations on the same inputs).
template <typename T>
__device__ __forceinline__ void block_general(const Args& a, uint64_t b, int lane) {
  const uint64_t base = b * a.block;
  const uint64_t end = base + a.block < a.n ? base + a.block : a.n;
  if (a.moments != kMomInt8) {
    for (uint64_t i = base + lane; i < end; i += 32) {
      const float2 pg = load_pg<T>(a, i);
      finish<T>(a, i, pg.x, new_moments(a, i, pg.y, 0.0f, 0.0f), 0.0f, 0.0f);
    }
    return;
  }
  // the old scales, before pass 2 overwrites them
  const float ms = a.m_scale[b], vs = a.v_scale[b];
  float am = 0.0f, av = 0.0f;
  for (uint64_t i = base + lane; i < end; i += 32) {
    const float2 pg = load_pg<T>(a, i);
    const Moments mv = new_moments(a, i, pg.y, ms, vs);
    am = nan_max(fabsf(mv.m), am);
    av = nan_max(__fsqrt_rn(mv.v), av);
  }
  am = warp_max(am);
  av = warp_max(av);
  const float sm = __fdiv_rn(am, 127.0f), sv = __fdiv_rn(av, 255.0f);
  const float qm = fmaxf(sm, 1e-38f), qv = fmaxf(sv, 1e-38f);
  for (uint64_t i = base + lane; i < end; i += 32) {
    const float2 pg = load_pg<T>(a, i);
    finish<T>(a, i, pg.x, new_moments(a, i, pg.y, ms, vs), qm, qv);
  }
  if (lane == 0) {
    a.m_scale[b] = sm;
    a.v_scale[b] = sv;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) me_adamw_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const uint64_t nb = (a.n + a.block - 1) / a.block;
  const uint64_t warps = static_cast<uint64_t>(gridDim.x) * kWarps;
  for (uint64_t b = static_cast<uint64_t>(blockIdx.x) * kWarps + threadIdx.x / 32; b < nb;
       b += warps) {
    if constexpr (VEC)
      block_vec<T>(a, b, lane);
    else
      block_general<T>(a, b, lane);
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const uint64_t nb = (a.n + a.block - 1) / a.block;
  const uint64_t want = (nb + kWarps - 1) / kWarps;
  const uint64_t most = static_cast<uint64_t>(sms) * kBlocksPerSM;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  const auto aligned = [](const void* q, uintptr_t to) {
    return reinterpret_cast<uintptr_t>(q) % to == 0;
  };
  const bool vec = a.moments == kMomInt8 && a.block <= 256 && a.block % 8 == 0 &&
                   aligned(a.p, 16) && aligned(a.g, 16) && aligned(a.master, 16) &&
                   aligned(a.m, 8) && aligned(a.v, 8);
  if (vec)
    me_adamw_kernel<T, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    me_adamw_kernel<T, false><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes: one MemoryEfficientAdamW update of the n
// elements described by *args, on `stream`.  Returns the cudaError_t
// of the launch (0 on success); does not synchronise.
extern "C" int prt_me_adamw(const PrtMeAdamwArgs* args, void* stream) {
  const PrtMeAdamwArgs& a = *args;
  if (a.n == 0 || a.block <= 0 || a.dtype < kF32 || a.dtype > kF16 || a.moments < kMomF32 ||
      a.moments > kMomInt8 || (a.moments == kMomInt8 && (!a.m_scale || !a.v_scale)) ||
      (a.has_master && !a.master) || (a.sr && (a.has_master || a.dtype != kBF16)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dtype == kF32) return launch<float>(a, s);
  if (a.dtype == kBF16) return launch<__nv_bfloat16>(a, s);
  return launch<__half>(a, s);
}

extern "C" int prt_me_adamw_args_size() { return static_cast<int>(sizeof(PrtMeAdamwArgs)); }

extern "C" const char* prt_me_adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
