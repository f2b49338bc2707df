// Dropout under a JAX threefry key, on Hopper (sm_90a), plain CUDA C++.
//
// Replaces no Pallas kernel.  The JAX package's dropout
// (`paddle_ray_tpu/nn/functional.py:dropout`) is
//
//   y = where(bernoulli(key, 1 - p, x.shape), x / keep, 0)
//
// in plain jnp, which XLA fuses into one pass over x.  The port's plain version
// hashes the same counters with about 170 elementwise tensor operations on int64
// tensors, one launch each on the card: this kernel is that one fused pass.
//
// Per element i of the flat (row-major) index, exactly the steps of
// `core/prng.py`: the partitionable threefry2x32 (20 rounds) of the 64-bit
// counter split into high and low words under the key's two words, bits = the
// two output words xor'd, the float32 uniform (bits >> 9 as the mantissa of a
// float in [1, 2), minus 1), kept where it is below the keep probability
// rounded to float32.  A kept value is x / keep, an IEEE float32 division by
// `keep` rounded to x's type, then rounded to x's type (the plain version
// divides by a 0-d tensor: a true division on the card, where a Python number
// would be a reciprocal product); without upscaling it is x.  So the result is
// the plain version's bit for bit.  The backward of dropout is the same
// function of dy under the same key, so the wrapper calls this kernel for both
// and stores no mask: a packed 1-bit mask would spare the backward its hash
// but keep an eighth of a byte an element of every drop alive from the forward
// to the backward, and under remat the recompute would write it again.
//
// What bounds it on the H100: integer operations.  The hash is about 80 int32
// operations an element (20 rounds of add, rotate, xor; 5 key injections of two
// adds), against 2 or 4 bytes read and written: at 64 int32 lanes an SM,
// 16.7 T operations a second, about 4.8 ns of hashing for every byte an H100 moves
// in 0.3 ns.  The design keeps the integer pipes busy and adds nothing to them:
// each thread takes a 16-byte vector (8 bf16 or 4 float32 values) by one load
// and one store, so it hashes 4-8 independent counters at once; rotates are
// funnel shifts; a fixed grid of at most 8 blocks of 256 threads an SM strides
// over the vectors.  A pointer not 16-byte aligned takes the same loop one
// element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kF32 = 0, kBF16 = 1;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

struct Args {
  const void* x;
  void* y;
  uint64_t n;
  uint32_t k0, k1;
  float keep_p;   // the keep probability rounded to float32
  float divisor;  // keep rounded to x's type, as a float
  int upscale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_f32(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

// element i: kept, x / keep (or x); else 0
template <typename T>
__device__ __forceinline__ T drop_one(const Args& a, uint64_t i, T v) {
  const uint32_t bits = prt::threefry_bits_at(a.k0, a.k1, i);
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  if (!(u < a.keep_p)) return from_f32(0.0f, T());
  return a.upscale ? from_f32(__fdiv_rn(to_f32(v), a.divisor), T()) : v;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) dropout_kernel(Args a) {
  constexpr int VE = 16 / sizeof(T);
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kThreads;
  const uint64_t t0 = static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (VEC) {
    const uint64_t nv = a.n / VE;
    for (uint64_t v = t0; v < nv; v += stride) {
      const uint4 in = reinterpret_cast<const uint4*>(x)[v];
      uint4 out;
      const T* ie = reinterpret_cast<const T*>(&in);
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VE; ++j) oe[j] = drop_one(a, v * VE + j, ie[j]);
      reinterpret_cast<uint4*>(y)[v] = out;
    }
    for (uint64_t i = nv * VE + t0; i < a.n; i += stride) y[i] = drop_one(a, i, x[i]);
  } else {
    for (uint64_t i = t0; i < a.n; i += stride) y[i] = drop_one(a, i, x[i]);
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const uint64_t work = vec ? (a.n + VE - 1) / VE : a.n;
  const uint64_t want = (work + kThreads - 1) / kThreads;
  const uint64_t most = static_cast<uint64_t>(sms) * kBlocksPerSM;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  if (vec)
    dropout_kernel<T, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    dropout_kernel<T, false><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes: y[i] = dropout of x[i] for i < n, x and y
// contiguous of one type (dtype 0 = f32, 1 = bf16).  Returns the cudaError_t of
// the launch (0 on success); does not synchronise.
extern "C" int prt_dropout(const void* x, void* y, long long n, uint32_t k0, uint32_t k1,
                           float keep_p, float divisor, int upscale, int dtype, void* stream) {
  if (n <= 0 || (dtype != kF32 && dtype != kBF16)) return cudaErrorInvalidValue;
  const Args a{x, y, static_cast<uint64_t>(n), k0, k1, keep_p, divisor, upscale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kF32 ? launch<float>(a, s) : launch<__nv_bfloat16>(a, s);
}

extern "C" const char* prt_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
