// Int8 x int8 -> int32 matrix product with a dequantising, bias-adding and
// casting epilogue, on Hopper (sm_90a): CUDA C++ with the int8 tensor cores
// through inline PTX (wgmma, TMA, mbarrier).
//
// Replaces the TPU kernel `paddle_ray_tpu/ops/fused.py:_int8_mm_kernel`
// (`int8_matmul`), and the bias add and cast that the JAX `QuantizedLinear`
// leaves to XLA after it:
//
//   out[m, n] = cast(((f32(sum_k xq[m, k] * wq[k, n]) * x_scale[m]) * w_scale[n]) + bias[n])
//
// The sum is int32 over all of K (exact: the wrapper keeps K below 2^17, so no
// sum can overflow), converted with round-to-nearest, then two rounded float32
// products in that order, then the float32 bias add, then the cast to the
// output type (float32 or bfloat16, round-to-nearest-even).  Each step is
// `__fmul_rn` / `__fadd_rn`, which no contraction can fuse into an FMA, so the
// result equals the plain version's (a float64 product of the int8 values,
// rounded to float32, then the same steps in PyTorch) bit for bit.  A null
// x_scale stands for ones (the product by 1 is skipped: the same bits), a null
// bias for none.  `QuantizedLinear` calls it with no x_scale, w_scale = s_x *
// s_w and its bias: JAX's `acc.f32 * (s_x * s_w) + bias.f32`, cast to x's
// type, in one launch.
//
// Layouts (row-major, contiguous): xq [M, K] int8, wt [N, K] int8 -- the
// weight K-major, as `wgmma` takes 8-bit operands only with K contiguous in
// both; `QuantizedLinear` keeps this copy beside its [K, N] weight and the
// wrapper makes it for any other caller -- x_scale [M] f32, w_scale [N] f32,
// bias [N] f32 or bf16, out [M, N].  Any M, N, K >= 1.
//
// What bounds it on the H100: at the fused encoder's shapes (M = 4096, K and
// N 1024-4096) the 2 M N K operations over the int8 tensor cores' 1979 TOP/s
// (NVIDIA H100 SXM data sheet, at its 700 W limit) take longer than moving the
// operands and the output once over 3.35 TB/s, by 1.1-1.6x: operations.  Only
// `wgmma` reaches that rate; `mma.sync` cannot on Hopper.
//
// Design: one block of 384 threads per 128 x 256 output tile (128 tiles on
// the 132 SMs at N = 1024 and M = 4096; 384 and 512, three and four waves at N
// = 3072 and 4096).
//   * warpgroup 0 is the producer: one thread issues two TMA loads a stage --
//     a [128 rows][128 K bytes] box of xq and a [256][128] box of wt, both in
//     the 128-byte swizzle -- into a ring of four 48 KB stages, each with a
//     `full` mbarrier (TMA bytes) and an `empty` one (the 256 consumer
//     threads); it gives back its registers (`setmaxnreg` 40).  TMA fills
//     boxes past M, N or K with zeros, which add nothing to the sums;
//   * warpgroups 1 and 2 are the consumers (`setmaxnreg` 232), each owning 64
//     rows of the tile: four `wgmma.mma_async` m64n256k32 s8 products a stage,
//     both operands K-major from shared memory, the int32 sums in 128
//     registers a thread; one product group stays in flight while the stage
//     before it is released to the producer;
//   * where K is not a multiple of 16 or an operand not 16-byte aligned (TMA
//     needs both), the producer warpgroup's 128 threads fill the same swizzled
//     layout with byte loads, zeros past the edges (the masked path);
//   * the epilogue stages the int32 sums of the tile through the ring (rows
//     padded by 32 bytes: the fragment stores are free of bank conflicts),
//     then each thread takes four neighbouring columns of a row: the scales,
//     the bias and the cast, and one 16-byte (float32) or 8-byte (bfloat16)
//     store, a warp's stores one contiguous stretch of a row.  A bfloat16
//     output moves half the bytes of a float32 one.
//   Measured alternatives and what holds it back: see PERF.md.

#include <cuda.h>  // CUtensorMap and its enums; the driver entry point comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 256;  // output tile
constexpr int kBK = 128;             // K bytes a stage: one 128-byte swizzle atom a row
constexpr int kStages = 4;
constexpr int kWG = 128;             // threads of a warpgroup
constexpr int kThreads = 3 * kWG;    // the producer warpgroup and two consumers
constexpr int kATile = kBM * kBK;    // 16 KB
constexpr int kBTile = kBN * kBK;    // 32 KB
constexpr int kStageBytes = kATile + kBTile;
constexpr int kPitch = kBN * 4 + 32;  // bytes of a staged row of int32 sums
constexpr int kMaxK = (1 << 17) - 1;  // the wrapper's INT8_MAX_K
constexpr size_t kSmem = 1024 + static_cast<size_t>(kStages) * kStageBytes + 2 * kStages * 8;
static_assert(kBM * kPitch <= kStages * kStageBytes, "the epilogue's tile fits the ring");

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

// TMA: the box at (c0 column, c1 row) of a 2-D map into shared memory
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
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
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma writes: no instruction that touches
// them moves across this point.
__device__ __forceinline__ void fence_regs(int (&r)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma's shared-memory descriptor of a K-major operand in the 128-byte swizzle
// (layout type 1): the start address, and 8-row groups 1024 bytes apart (the
// leading offset is unused), in 16-byte units.  The k-th 32-byte slice of the
// atom starts 32 k bytes in; the hardware applies the swizzle to the address.
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

// d (64 x 256 int32, 128 a thread) += a (64 x 32 s8) * b (32 x 256 s8), both
// K-major in shared memory; acc = 0 overwrites d
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

// The masked path's fill of one [rows][128 K bytes] box of the [n_rows, K]
// operand `src` at (row r0, K byte k0) by the producer warpgroup, zeros past
// the edges, in the TMA's 128-byte swizzle: 16-byte chunk c of row r sits at
// chunk c ^ (r % 8).
template <int kRows>
__device__ __forceinline__ void fill_box(uint8_t* dst, const int8_t* __restrict__ src, int n_rows,
                                         int K, int r0, int k0, int tid) {
  for (int i = tid; i < kRows * (kBK / 16); i += kWG) {
    const int r = i / (kBK / 16), c = i % (kBK / 16);
    const int row = r0 + r, k = k0 + 16 * c;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (row < n_rows) {
      const int8_t* p = src + static_cast<size_t>(row) * K + k;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (k + j < K) v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * (j & 3));
    }
    *reinterpret_cast<uint4*>(dst + r * kBK + ((c ^ (r & 7)) << 4)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float bias_at(const void* bias, int bias_bf16, int col) {
  return bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col])
                   : static_cast<const float*>(bias)[col];
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <bool kTma, typename T>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   const int8_t* __restrict__ xq, const int8_t* __restrict__ wt,
                   const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                   const void* __restrict__ bias, int bias_bf16, T* __restrict__ out, int M, int N,
                   int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);  // kStages x (A [128][128], B [256][128])
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kTma ? 1 : kWG);
      mbar_init(&empty[s], 2 * kWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // the producer, paced by `empty`
    setmaxnreg_dec<40>();
    if (kTma) {
      if (threadIdx.x == 0) {
        for (int kb = 0; kb < nk; ++kb) {
          const int s = kb % kStages;
          mbar_wait(&empty[s], ((kb / kStages) & 1) ^ 1);
          mbar_arrive_tx(&full[s], kStageBytes);
          uint8_t* st = ring + s * kStageBytes;
          tma_load2(st, &ta, &full[s], kb * kBK, m0);
          tma_load2(st + kATile, &tb, &full[s], kb * kBK, n0);
        }
      }
    } else {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        mbar_wait(&empty[s], ((kb / kStages) & 1) ^ 1);
        uint8_t* st = ring + s * kStageBytes;
        fill_box<kBM>(st, xq, M, K, m0, kb * kBK, threadIdx.x);
        fill_box<kBN>(st + kATile, wt, N, K, n0, kb * kBK, threadIdx.x);
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int w = threadIdx.x / kWG - 1;  // this consumer's 64 rows: 64 w ..
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % kStages;
    mbar_wait(&full[s], (kb / kStages) & 1);
    const uint8_t* a = ring + s * kStageBytes + w * 64 * kBK;
    const uint8_t* b = ring + s * kStageBytes + kATile;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) wgmma_s8(acc, desc_k(a + 32 * kk), desc_k(b + 32 * kk), 1);
    wg_commit();
    // the stage before this one is read: hand it back to the producer
    wg_wait<1>();
    if (kb > 0) mbar_arrive(&empty[(kb - 1) % kStages]);
  }
  wg_wait<0>();
  fence_regs(acc);

  // stage the int32 sums through the ring (every TMA load has landed and both
  // consumers are done reading it): thread (warp, lane) holds rows
  // 16 warp + lane / 4 (+ 8) and columns 8 j + 2 (lane % 4) (+ 1) at acc[4 j ..]
  named_bar_sync(1, 2 * kWG);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row = 64 * w + 16 * warp + lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    *reinterpret_cast<int2*>(ring + row * kPitch + (8 * j + col) * 4) = make_int2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<int2*>(ring + (row + 8) * kPitch + (8 * j + col) * 4) =
        make_int2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_bar_sync(1, 2 * kWG);

  // four neighbouring columns of a row a thread: scales, bias, cast, one store
  const bool vec = (N & 3) == 0;
  for (int i = threadIdx.x - kWG; i < kBM * (kBN / 4); i += 2 * kWG) {
    const int r = i / (kBN / 4), q = i % (kBN / 4);
    const int m = m0 + r, n = n0 + 4 * q;
    if (m >= M || n >= N) continue;
    const int4 v = *reinterpret_cast<const int4*>(ring + r * kPitch + q * 16);
    const int sums[4] = {v.x, v.y, v.z, v.w};
    const float xs = x_scale != nullptr ? x_scale[m] : 1.f;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = min(n + e, N - 1);  // columns past N are computed and not stored
      float f = __int2float_rn(sums[e]);
      if (x_scale != nullptr) f = __fmul_rn(f, xs);
      f = __fmul_rn(f, w_scale[c]);
      if (bias != nullptr) f = __fadd_rn(f, bias_at(bias, bias_bf16, c));
      y[e] = f;
    }
    T* o = out + static_cast<size_t>(m) * N + n;
    if (vec) {
      store4(o, y);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) store1(o + e, y[e]);
    }
  }
}

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

// A 2-D TMA map over a contiguous int8 [rows, K] operand, in boxes of `box_rows`
// rows by 128 K bytes in the 128-byte swizzle: rows past `rows` and bytes past
// K arrive as zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const int8_t* xq, const int8_t* wt, const float* xs, const float* ws,
                   const void* bias, int bias_bf16, T* out, int M, int N, int K, cudaStream_t st) {
  const bool tma = K % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  CUtensorMap ta{}, tb{};
  cudaError_t err = cudaSuccess;
  if (tma) {
    err = make_map(&ta, xq, M, K, kBM);
    if (err == cudaSuccess) err = make_map(&tb, wt, N, K, kBN);
    if (err != cudaSuccess) return err;
  }
  auto kern = tma ? int8_matmul_kernel<true, T> : int8_matmul_kernel<false, T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kern<<<grid, kThreads, kSmem, st>>>(ta, tb, xq, wt, xs, ws, bias, bias_bf16, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes.  wt is the K-major [N, K] weight; x_scale and
// bias may be null.  bias_dtype, out_dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success); it does not
// synchronise.
extern "C" int prt_int8_matmul(const void* xq, const void* wt, const void* x_scale,
                               const void* w_scale, const void* bias, int bias_dtype, void* out,
                               int M, int N, int K, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > kMaxK || (M + kBM - 1) / kBM > 65535 ||
      (bias_dtype != 0 && bias_dtype != 1))
    return cudaErrorInvalidValue;
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wt);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch<float>(a, b, xs, ws, bias, bias_dtype, static_cast<float*>(out), M, N, K, st);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(a, b, xs, ws, bias, bias_dtype, static_cast<__nv_bfloat16*>(out),
                                 M, N, K, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* prt_int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
