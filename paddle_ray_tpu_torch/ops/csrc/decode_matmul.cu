// Weight-streaming int8 matmul for decode on Hopper (sm_90a), CUDA C++ with the
// bf16 tensor cores through inline PTX (mma.sync, cp.async).
//
// Replaces the TPU kernel `paddle_ray_tpu/ops/decode_matmul.py:_kernel`
// (`int8_stream_matmul`): y = (x @ w_q) * scale (+ bias) for a small batch of
// rows, accumulated in f32 and returned in x's dtype.  The int8 weight is
// widened to x's type (exact in bf16 and f32), each product is exact in f32.
//
// Layouts (all contiguous):
//   x         [B, K]        f32 or bf16, B <= 128
//   w         [K, N]        int8, any N (the ragged edge is masked)
//   scale     [N]           f32
//   bias      [N]           f32 or bf16 (read in its own type), or null
//   ws        [tiles, S, 1024] f32 split-K partials when the K range is split (S > 1)
//   counters  [tiles]       int32, zero before the launch and left zero by it
//   out       [B, N]        x's dtype
//
// What bounds it on the H100: the weight bytes.  At decode (B = 8) the
// operations are 2 * B = 16 per weight byte, far below the card's
// operations-per-byte line, so the least time is K * N bytes over 3.35 TB/s
// (NVIDIA H100 SXM data sheet, at its 700 W limit): a 1 MB layer 0.3 us, the
// 51.5 MB LM head 15 us.  On the CUDA cores that line is out of reach at B = 8:
// 8 FMAs a weight byte need some 80 % of the card's f32 FMA rate at 3.35 TB/s.
//
// Design: one launch a call.  A block of 128 threads (4 warps) owns a tile of
// 128 output columns, a run of K rows (its split) and a group of up to 8 input
// rows (blockIdx.z: more rows read the same weight tile again, from L2).
//   * the weight streams through a ring of four stages of 64 K rows x 128
//     columns (8 KB) by 16-byte `cp.async`, three stages in flight while one
//     is summed (six or eight stages measured no faster), with the block's 8 x 64 slab of x beside each stage; the 16
//     byte chunks of a weight row are swizzled (chunk ^ 2 ((row / 4) % 4)) so
//     the fragment reads below are free of bank conflicts, x rows padded by 32
//     bytes likewise.  Where N is not a multiple of 16, K not one of 8 or a
//     pointer not 16-byte aligned, plain loads fill the same layout (the
//     masked path); edges are zero-filled either way;
//   * bf16 x: the tensor cores, `mma.sync.m16n8k16` bf16 with f32 sums, on the
//     transposed product y^T = w^T x^T: the weight is the A operand (16
//     columns of w as the rows of an mma), x the N = 8 operand, so batch 8
//     fills the product without padding.  A warp owns 32 columns: each lane
//     reads four 32-bit words of the stage -- K rows 4 t .. 4 t + 3 (t = lane
//     % 4) at columns 4 g .. 4 g + 3 (g = lane / 4) -- and widens the 16 bytes
//     to bf16 in registers (byte ^ 0x80 into the low byte of 2^23 by
//     `__byte_perm`, minus 2^23 + 128, exact; the upper halves of two such
//     floats packed by `__byte_perm` form a bf16 pair).  The pairing of K rows
//     transposes the 4 x 4 bytes for free: mma K positions (2t, 2t+1, 2t+8,
//     2t+9) stand for rows 4t .. 4t+3, in the weight's A fragments and in x's
//     B fragment alike, which is then one 8-byte read of x's row g.  Two mmas
//     a lane a 16-row K step; a lane ends with four neighbouring columns of
//     two rows;
//   * f32 x (the test-only type: bf16 products would change its numbers and
//     TF32 is not allowed): the CUDA cores, a thread per column, eight rows;
//   * split-K in the same launch: where the column tiles are too few to fill
//     the card, K is cut into runs (the wrapper's plan: 2-4 stages a run);
//     every block of a tile writes its f32 partial sums to the workspace and
//     arrives on the tile's counter (one acq_rel atomic by thread 0 after a
//     barrier, no separate fence), and the last block to arrive -- which
//     resets the counter -- loads the runs eight at a time and adds them in
//     the fixed order 0..S-1 (the same bits every call), then applies scale
//     and bias;
//   * scale and bias are applied as (sum * scale) + bias, two roundings, then
//     the cast to x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kTileN = 128;            // output columns per block
constexpr int kRows = 8;               // input rows per block
constexpr int kStageK = 64;            // K rows per stage
constexpr int kStages = 4;
constexpr int kWBytes = kStageK * kTileN;  // 8 KB of weight a stage
constexpr int kPart = kRows * kTileN;      // floats of a block's partial sums

template <typename T>
struct Stage {
  static constexpr int kXPitch = kStageK * static_cast<int>(sizeof(T)) + 32;  // bytes of an x row
  static constexpr int kXChunks = kStageK * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a row
  static constexpr int kBytes = kWBytes + kRows * kXPitch;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, the bytes past `src_bytes` zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// counter += 1 at gpu scope, with release (the caller's earlier writes, and
// those its block's barrier ordered before it) and acquire (the writes of the
// earlier arrivals); returns the old count
__device__ __forceinline__ int arrive_acq_rel(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// byte offset of 16-byte chunk c of weight row r in a stage
__device__ __forceinline__ int w_off(int r, int c) {
  return r * kTileN + ((c ^ (((r >> 2) & 3) << 1)) << 4);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One stage: weight rows k0 .. k0 + 63 (below k1) at columns n0 .., and x rows
// b0 .. b0 + 7 (below B) at the same K range, into `dst`.
template <typename T, bool kVec>
__device__ __forceinline__ void load_stage(uint8_t* dst, const T* __restrict__ x,
                                           const int8_t* __restrict__ w, int B, int K, int N,
                                           int b0, int n0, int k0, int k1) {
  using S = Stage<T>;
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < kStageK * (kTileN / 16); i += kThreads) {
    const int r = i / (kTileN / 16), c = i % (kTileN / 16);
    const int k = k0 + r, n = n0 + 16 * c;
    uint8_t* d = dst + w_off(r, c);
    if (kVec) {
      const bool ok = k < k1 && n < N;  // N % 16 == 0: a chunk is whole or wholly outside
      cp_async16(d, ok ? w + static_cast<size_t>(k) * N + n : w, ok ? 16 : 0);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (k < k1) {
        const int8_t* p = w + static_cast<size_t>(k) * N + n;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n + j < N) v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  for (int i = threadIdx.x; i < kRows * S::kXChunks; i += kThreads) {
    const int r = i / S::kXChunks, c = i % S::kXChunks;
    const int b = b0 + r, k = k0 + c * kPerChunk;
    uint8_t* d = dst + kWBytes + r * S::kXPitch + c * 16;
    if (kVec) {
      const bool ok = b < B && k < k1;  // K % 8 == 0: a chunk is whole or wholly outside
      cp_async16(d, ok ? x + static_cast<size_t>(b) * K + k : x, ok ? 16 : 0);
    } else {
      __align__(16) T v[kPerChunk];
#pragma unroll
      for (int j = 0; j < kPerChunk; ++j)
        v[j] = (b < B && k + j < k1) ? x[static_cast<size_t>(b) * K + k + j] : T(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Two f32 values that hold integers of at most 8 significant bits, as a bf16
// pair (lo in the low half): their upper halves, exactly.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 x: one stage's products on the tensor cores.  acc[4 j + q] holds column
// 32 warp + 4 g + 2 j + q / 2 of row 2 t + q % 2.
__device__ __forceinline__ void stage_mma(const uint8_t* st, float (&acc)[8]) {
  using S = Stage<__nv_bfloat16>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  // the lane's four columns are bytes 4 (g % 4) .. of chunk 2 warp + g / 4 of a
  // row; its rows 16 ks + 4 t + i all take the swizzle 2 t
  const uint8_t* wp = st + (((2 * warp + g / 4) ^ (2 * t)) << 4) + 4 * (g % 4);
  const uint8_t* xp = st + kWBytes + g * S::kXPitch + 8 * t;
#pragma unroll
  for (int ks = 0; ks < kStageK / 16; ++ks) {
    float f[4][4];  // [K row 4 t + i][column 4 g + c]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u =
          *reinterpret_cast<const uint32_t*>(wp + (16 * ks + 4 * t + i) * kTileN) ^ 0x80808080u;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        f[i][c] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + c)) - 8388736.f;
    }
    const uint2 xv = *reinterpret_cast<const uint2*>(xp + 32 * ks);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t a[4] = {pack_bf16(f[0][2 * j], f[1][2 * j]),
                             pack_bf16(f[0][2 * j + 1], f[1][2 * j + 1]),
                             pack_bf16(f[2][2 * j], f[3][2 * j]),
                             pack_bf16(f[2][2 * j + 1], f[3][2 * j + 1])};
      mma_bf16(acc + 4 * j, a, xv.x, xv.y);
    }
  }
}

// f32 x: one stage on the CUDA cores.  acc[r] holds column threadIdx.x of row r.
__device__ __forceinline__ void stage_fma(const uint8_t* st, float (&acc)[8]) {
  using S = Stage<float>;
  const int c = threadIdx.x / 16, within = threadIdx.x % 16;
#pragma unroll 4
  for (int r = 0; r < kStageK; ++r) {
    const float wv = static_cast<float>(static_cast<int8_t>(st[w_off(r, c) + within]));
#pragma unroll
    for (int b = 0; b < kRows; ++b)
      acc[b] = fmaf(reinterpret_cast<const float*>(st + kWBytes + b * S::kXPitch)[r], wv, acc[b]);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_stream_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                          const float* __restrict__ scale, const void* __restrict__ bias,
                          int bias_bf16, float* __restrict__ ws, int* __restrict__ counters,
                          T* __restrict__ out, int B, int K, int N, int rows_per_split) {
  using S = Stage<T>;
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) uint8_t smem[];  // kStages x S::kBytes
  __shared__ int last;
  const int n0 = blockIdx.x * kTileN, split = blockIdx.y, b0 = blockIdx.z * kRows;
  const int k0 = split * rows_per_split, k1 = min(K, k0 + rows_per_split);
  const int n_st = (k1 - k0 + kStageK - 1) / kStageK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st)
      load_stage<T, kVec>(smem + s * S::kBytes, x, w, B, K, N, b0, n0, k0 + s * kStageK, k1);
    cp_async_commit();
  }
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s has landed, and every thread is done with stage s - 1
    const int nxt = s + kStages - 1;
    if (nxt < n_st)
      load_stage<T, kVec>(smem + (nxt % kStages) * S::kBytes, x, w, B, K, N, b0, n0,
                          k0 + nxt * kStageK, k1);
    cp_async_commit();
    const uint8_t* st = smem + (s % kStages) * S::kBytes;
    if constexpr (kTc)
      stage_mma(st, acc);
    else
      stage_fma(st, acc);
  }

  const int n_splits = gridDim.y;
  if (n_splits > 1) {
    // split-K: the partial sums to the workspace, and the last block of the
    // tile adds the runs in split order
    const int tile = blockIdx.z * gridDim.x + blockIdx.x;
    float4* mine = reinterpret_cast<float4*>(
        ws + (static_cast<size_t>(tile) * n_splits + split) * kPart + threadIdx.x * 8);
    mine[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    mine[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    // the block's stores ordered before thread 0's release (the barrier
    // makes them the thread's own), the other blocks' runs after its acquire
    __syncthreads();
    if (threadIdx.x == 0) last = arrive_acq_rel(&counters[tile]) == n_splits - 1;
    __syncthreads();
    if (!last) return;
    const float4* runs = reinterpret_cast<const float4*>(
        ws + static_cast<size_t>(tile) * n_splits * kPart + threadIdx.x * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    // eight runs' loads in flight at once, added in split order
    for (int s0 = 0; s0 < n_splits; s0 += 8) {
      float4 p[8][2];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < n_splits) {
          p[u][0] = __ldcg(runs + (s0 + u) * (kPart / 4));
          p[u][1] = __ldcg(runs + (s0 + u) * (kPart / 4) + 1);
        }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < n_splits) {
          acc[0] += p[u][0].x; acc[1] += p[u][0].y; acc[2] += p[u][0].z; acc[3] += p[u][0].w;
          acc[4] += p[u][1].x; acc[5] += p[u][1].y; acc[6] += p[u][1].z; acc[7] += p[u][1].w;
        }
    }
    if (threadIdx.x == 0) counters[tile] = 0;  // ready for the next launch
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int row = b0 + (kTc ? 2 * (lane % 4) + e % 2 : e);
    const int col = n0 + (kTc ? 32 * warp + 4 * (lane / 4) + 2 * (e / 4) + (e / 2) % 2 : threadIdx.x);
    if (row >= B || col >= N) continue;
    float v = __fmul_rn(acc[e], scale[col]);
    if (bias != nullptr)
      v = __fadd_rn(v, bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col])
                                 : static_cast<const float*>(bias)[col]);
    store(out + static_cast<size_t>(row) * N + col, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* scale, const void* bias,
                   int bias_bf16, float* ws, int* counters, void* out, int B, int K, int N,
                   int rows_per_split, int n_splits, cudaStream_t st) {
  const bool vec = N % 16 == 0 && K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kern = vec ? &int8_stream_matmul_kernel<T, true> : &int8_stream_matmul_kernel<T, false>;
  constexpr int smem = kStages * Stage<T>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kTileN - 1) / kTileN, n_splits, (B + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(x), static_cast<const int8_t*>(w), scale,
                                  bias, bias_bf16, ws, counters, static_cast<T*>(out), B, K, N,
                                  rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes.  dtype: 0 = float32, 1 = bfloat16 (x and out);
// bias_dtype likewise (bias may be null).  K is cut into runs of
// `rows_per_split` rows (a multiple of 64); with more than one run, `ws` holds
// tiles * runs * 1024 floats and `counters` tiles zeroed ints, tiles being
// ceil(N / 128) * ceil(B / 8).  Returns the cudaError_t of the launch (0 on
// success); it does not synchronise.
extern "C" int prt_int8_stream_matmul(const void* x, const void* w, const void* scale,
                                      const void* bias, int bias_dtype, void* ws, void* counters,
                                      void* out, int B, int K, int N, int rows_per_split,
                                      int dtype, void* stream) {
  if (B <= 0 || B > 128 || K <= 0 || N <= 0 || rows_per_split <= 0 ||
      rows_per_split % kStageK != 0 || (bias_dtype != 0 && bias_dtype != 1))
    return cudaErrorInvalidValue;
  const int n_splits = (K + rows_per_split - 1) / rows_per_split;
  if (n_splits > 65535 || (n_splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  float* wsp = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, sc, bias, bias_dtype, wsp, cnt, out, B, K, N, rows_per_split,
                         n_splits, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, sc, bias, bias_dtype, wsp, cnt, out, B, K, N,
                                 rows_per_split, n_splits, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* prt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
