// Int8 x int8 -> int32 matrix product with a dequantising epilogue, on Hopper
// (sm_90a): CUDA C++ with the int8 tensor cores through inline PTX.
//
// Replaces the TPU kernel `paddle_ray_tpu/ops/fused.py:_int8_mm_kernel`
// (`int8_matmul`):
//
//   out[m, n] = (f32(sum_k xq[m, k] * wq[k, n]) * x_scale[m]) * w_scale[n]
//
// The sum is int32 over all of K (exact: the wrapper keeps K below 2^17, so
// no sum can overflow), converted with round-to-nearest, then two rounded
// float32 products in that order, then the cast to the output type (float32 or
// bfloat16, round-to-nearest-even).  Every step is exact or one IEEE rounding,
// so the result equals the plain version's (a float64 product of the int8
// values, rounded to float32) bit for bit.  Built without fast math; the two
// products are `__fmul_rn`, which no contraction can fuse.
//
// Layouts (row-major, contiguous, as the JAX caller gives them): xq [M, K]
// int8, wq [K, N] int8, x_scale [M] f32, w_scale [N] f32, out [M, N].  Any M,
// N, K >= 1: tiles past an edge are zero-filled in shared memory, where zeros
// add nothing to the sums, and outputs past an edge are not written.
//
// What bounds it on the H100: at the fused encoder's shapes (M = 4096, K and
// N 1024-4096) bytes and operations are close -- 2 M N K int8 operations over
// 1979 TOP/s against the int8 operands read once and the float32 output
// written once over 3.35 TB/s.  The float32 output is the largest stream.
//
// Design (simple first):
//   * one block of 256 threads per 128 x 128 output tile; eight warps, 2 along
//     M x 4 along N, each owning a 64 x 32 tile: 4 x 4 `mma.sync.m16n8k32`
//     s8 products a 32-deep K step, their int32 sums in registers;
//   * K in 32-wide slabs, double-buffered in shared memory (2 x 8 KB): the
//     next slab's global loads are issued before the current slab's products
//     and stored after them, one barrier a slab;
//   * the s8 `mma` wants K contiguous in both operands, and wq arrives
//     N-contiguous.  Each thread loads a 4 (k) x 4 (n) block of wq as four
//     32-bit words and transposes it in registers with `__byte_perm`, so both
//     tiles sit in shared memory as [row][32 bytes of K]; `ldmatrix` then gives
//     every lane its fragment words directly;
//   * the two 16-byte halves of each 32-byte row are swapped by bit 2 ^ bit 4
//     of the row, and each thread writes its four transposed words in an order
//     rotated by its lane: `ldmatrix` and both tiles' stores touch each of the
//     32 banks once per wavefront;
//   * the epilogue reads the int32 sums straight from the accumulator
//     fragments and writes pairs of neighbouring outputs.
//   Left for the redesign: `wgmma` with TMA loads and a multi-stage ring, a
//   persistent grid, an epilogue that also adds the bias and casts (the TPU
//   kernel left both to XLA), and a K-major weight copy made once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kWM = 64, kWN = 32;           // a warp's tile
constexpr int kMI = kWM / 16, kNI = kWN / 8;  // its 4 x 4 mma tiles
constexpr int kTile = kBM * kBK;            // bytes of one [128][32] tile (A or B)
constexpr int kMaxK = (1 << 17) - 1;        // the wrapper's INT8_MAX_K

// Byte offset of 16-byte half `half` of row `row` in a [128][32] tile.
__device__ __forceinline__ int swz(int row, int half) {
  return row * kBK + ((half ^ (((row >> 2) ^ (row >> 4)) & 1)) << 4);
}

// 16 bytes of xq's row m from column k, zeros past the edges.  kVec: K % 16 == 0
// and xq 16-byte aligned, so a chunk is whole or wholly outside.
template <bool kVec>
__device__ __forceinline__ uint4 load_a(const int8_t* __restrict__ xq, int M, int K, int m,
                                        int k) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (m >= M) return v;
  const int8_t* p = xq + static_cast<size_t>(m) * K + k;
  if (kVec) {
    if (k < K) v = *reinterpret_cast<const uint4*>(p);
    return v;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (k + i < K) w[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << ((i & 3) * 8);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Rows k..k+3 of wq at columns n..n+3, one 32-bit word a row (byte j =
// column n + j), zeros past the edges.  kVec: N % 4 == 0 and wq 4-byte aligned.
template <bool kVec>
__device__ __forceinline__ void load_b(const int8_t* __restrict__ wq, int K, int N, int k, int n,
                                       uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = 0u;
    if (k + i >= K) continue;
    const int8_t* p = wq + static_cast<size_t>(k + i) * N + n;
    if (kVec) {
      if (n < N) r[i] = *reinterpret_cast<const uint32_t*>(p);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) r[i] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
    }
  }
}

__device__ __forceinline__ void store_a(int8_t* as, int row, int half, uint4 v) {
  *reinterpret_cast<uint4*>(as + swz(row, half)) = v;
}

// Transpose a 4 (k) x 4 (n) block held as rows r[0..3] into four words of 4
// k-values each, and store column n0 + j's word at k-word `kword` of row
// n0 + j of the [n][k] tile.  `rot` rotates the order of the four stores.
__device__ __forceinline__ void store_b(int8_t* bs, int n0, int kword, int rot,
                                        const uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // (k0,n0) (k1,n0) (k0,n1) (k1,n1)
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // (k0,n2) (k1,n2) (k0,n3) (k1,n3)
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);  // (k2,n0) (k3,n0) (k2,n1) (k3,n1)
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);  // (k2,n2) (k3,n2) (k2,n3) (k3,n3)
  const uint32_t c0 = __byte_perm(t0, t2, 0x5410), c1 = __byte_perm(t0, t2, 0x7632);
  const uint32_t c2 = __byte_perm(t1, t3, 0x5410), c3 = __byte_perm(t1, t3, 0x7632);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = (s + rot) & 3;
    const uint32_t v = j == 0 ? c0 : j == 1 ? c1 : j == 2 ? c2 : c3;
    const int n = n0 + j;
    *reinterpret_cast<uint32_t*>(bs + swz(n, kword >> 2) + (kword & 3) * 4) = v;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(v0);
  v.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

template <bool kVec, typename T>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                       const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                       T* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) int8_t smem[2][2][kTile];  // [stage][A as [m][k], B as [n][k]]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  // loaders: A one 16-byte half-row a thread; B one 4 x 4 block a thread, a
  // warp 4 k-words x 8 column groups (each global row read is a whole sector)
  const int a_row = tid >> 1, a_half = tid & 1;
  const int nq = lane & 7;
  const int b_kword = (warp >> 2) * 4 + (lane >> 3);
  const int b_n0 = ((warp & 3) * 8 + nq) * 4;
  // the warp's tile of the output
  const int wm = (warp >> 2) * kWM, wn = (warp & 3) * kWN;

  int acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (K + kBK - 1) / kBK;
  uint4 a_reg = load_a<kVec>(xq, M, K, m0 + a_row, a_half * 16);
  uint32_t b_reg[4];
  load_b<kVec>(wq, K, N, b_kword * 4, n0 + b_n0, b_reg);
  store_a(smem[0][0], a_row, a_half, a_reg);
  store_b(smem[0][1], b_n0, b_kword, nq, b_reg);
  __syncthreads();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) {
      const int k0 = (kt + 1) * kBK;
      a_reg = load_a<kVec>(xq, M, K, m0 + a_row, k0 + a_half * 16);
      load_b<kVec>(wq, K, N, k0 + b_kword * 4, n0 + b_n0, b_reg);
    }
    const int8_t* as = smem[cur][0];
    const int8_t* bs = smem[cur][1];
    uint32_t a[kMI][4], b[kNI][2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      // matrices: rows +0 / +8 (lane bit 3), K half 0 / 1 (lane bit 4)
      const int row = wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(a[mi], as + swz(row, lane >> 4));
    }
#pragma unroll
    for (int nj = 0; nj < kNI / 2; ++nj) {
      // matrices: K half 0 / 1 (lane bit 3), columns +0 / +8 (lane bit 4)
      uint32_t r[4];
      const int row = wn + nj * 16 + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(r, bs + swz(row, (lane >> 3) & 1));
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    if (more) {
      store_a(smem[cur ^ 1][0], a_row, a_half, a_reg);
      store_b(smem[cur ^ 1][1], b_n0, b_kword, nq, b_reg);
    }
    __syncthreads();
  }

  // epilogue: lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of
  // each 16 x 8 tile
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mi * 16 + g + h * 8;
      if (row >= M) continue;
      const float sx = x_scale[row];
      T* orow = out + static_cast<size_t>(row) * N;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int col = n0 + wn + ni * 8 + t * 2;
        if (col >= N) continue;
        const float v0 =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), sx), w_scale[col]);
        if (col + 1 < N) {
          const float v1 =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), sx), w_scale[col + 1]);
          if (pairs) {
            store2(orow + col, v0, v1);
          } else {
            store1(orow + col, v0);
            store1(orow + col + 1, v1);
          }
        } else {
          store1(orow + col, v0);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const int8_t* xq, const int8_t* wq, const float* xs, const float* ws, T* out,
                   int M, int N, int K, cudaStream_t st) {
  const bool vec = K % 16 == 0 && N % 4 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 4 == 0;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (vec)
    int8_matmul_kernel<true, T><<<grid, kThreads, 0, st>>>(xq, wq, xs, ws, out, M, N, K);
  else
    int8_matmul_kernel<false, T><<<grid, kThreads, 0, st>>>(xq, wq, xs, ws, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes.  out_dtype: 0 = float32, 1 = bfloat16.  Returns
// the cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int prt_int8_matmul(const void* xq, const void* wq, const void* x_scale,
                               const void* w_scale, void* out, int M, int N, int K, int out_dtype,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > kMaxK || (N + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch<float>(a, b, xs, ws, static_cast<float*>(out), M, N, K, st);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(a, b, xs, ws, static_cast<__nv_bfloat16*>(out), M, N, K, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* prt_int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
