// Pieces shared by the GroupNorm(32)+SiLU kernels K2 (group_norm_silu.cu)
// and K2b (group_norm_silu_backward.cu): 16-byte vectors of fp32 or bf16,
// fixed-order warp sums, 1-D bulk async copies into shared memory that
// complete on mbarriers, thread-block cluster barriers, and the launch and
// occupancy set-up of a kernel launched in clusters of up to 16 blocks.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// 16 bytes of T, converted to and from fp32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to T and back to fp32 (v itself for fp32).
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The norm+SiLU site in the JAX package's default order (flax's GroupNorm,
// then `nn.silu` in the activation dtype T), one operation at a time as the
// plain version (`_flax_site`) rounds it, none fused into an fma:
//   h = (x - mean) * mul + beta in fp32, mul = rstd * gamma_c, rounded to T;
//   s = 1 / (1 + exp(-h)), each of exp, the add and the reciprocal rounded
//       to T (in fp32 one sigmoid), with the accurate expf;
//   out = h * s (rounded by the caller's store).
__device__ __forceinline__ float flax_norm_value(float x, float mean,
                                                 float mul, float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), beta);
}
// (__frcp_rn(d), the same correctly rounded 1 / d, timed no faster at the
// fp32 sites: scripts/torch_k2_layouts.py and torch_k2b_layouts.py
// --dtype float32.)
template <typename T>
__device__ __forceinline__ float jax_sigmoid(float h) {
  const float e = round_to<T>(expf(-h));
  return round_to<T>(__fdiv_rn(1.0f, round_to<T>(__fadd_rn(1.0f, e))));
}

// At a bf16 site h is a bf16 value, so the flax order's SiLU is an exact
// function of h's 16 bits: the kernels read it from a table filled once per
// card by `jax_sigmoid<__nv_bfloat16>` itself, in place of the per-element
// expf, the division and their roundings.  Per sign, slot 0 serves every
// |h| < 2^-8 (s = 1/2 there), slots 1..1920 the bf16 values of |h| in
// [2^-8, 2^7) one each, slot 1921 every |h| >= 2^7 and inf (s = 1 for h > 0,
// 0 for h < 0) and slot 1922 NaN.  Slot (sign, k) sits at sign * ROW + k;
// the array is padded to whole 16-byte copies.
constexpr int FLAX_TABLE_ROW = 1923;
constexpr int FLAX_TABLE_ENTRIES = 3848;   // 2 * ROW, padded to 8
constexpr uint32_t FLAX_TABLE_LO = 119u << 7;  // bits of 2^-8 (sign off)
constexpr uint32_t BF16_INF = 0x7F80u;

// The slot of the bf16 value with bits b.
__device__ __forceinline__ int flax_table_index(uint32_t b) {
  const uint32_t e = b & 0x7FFFu;
  const int k = min(max((int)e - (int)FLAX_TABLE_LO + 1, 0), 1921) +
                (e > BF16_INF);
  return (int)(b >> 15) * FLAX_TABLE_ROW + k;
}

// The h that fills slot i (a padding slot gets 0).
__device__ __forceinline__ float flax_table_h(int i) {
  const uint32_t sign = i >= FLAX_TABLE_ROW ? 0x8000u : 0u;
  const int k = i % FLAX_TABLE_ROW;
  uint32_t e = 0;                                   // +-0 for |h| < 2^-8
  if (i >= 2 * FLAX_TABLE_ROW) return 0.0f;
  if (k >= 1 && k <= 1920) e = FLAX_TABLE_LO + (uint32_t)(k - 1);
  if (k == 1921) e = BF16_INF;
  if (k == 1922) e = 0x7FC0u;                       // a quiet NaN
  return __uint_as_float((sign | e) << 16);
}

// Launch the kernel `fill` (one thread per entry of a table in device
// memory, no arguments) once per card, on a stream of its own, and wait for
// it; each source that includes this header keeps its own record of the
// cards it filled.
cudaError_t fill_table_once(void (*fill)(), int entries) {
  constexpr int MAX_DEVICES = 64;
  static bool filled[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device >= MAX_DEVICES || filled[device]) return err;
  cudaStream_t stream;
  err = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel((const void*)fill, dim3((entries + 255) / 256),
                         dim3(256), nullptr, 0, stream);
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  const cudaError_t destroyed = cudaStreamDestroy(stream);
  if (err == cudaSuccess) err = destroyed;
  filled[device] = err == cudaSuccess;
  return err;
}

// h rounded to bf16, and its bits.
__device__ __forceinline__ float bf16_round_bits(float v, uint32_t& bits) {
  bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  return __uint_as_float(bits << 16);
}

// Sum a and b over the warp in a fixed order; every lane gets the totals.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive on `bar` (initialised for one arrival) and expect `bytes` of bulk
// copies to complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, completing them on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One copy that completes `bar` when its bytes have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Wait for the first phase of `bar` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

cudaLaunchConfig_t launch_config(int blocks, int cluster, int threads,
                                 int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// Allow `kernel` the most dynamic shared memory a block can opt into and
// clusters above the portable 8, then count how many clusters of this shape
// the card can hold at once (0: it cannot be scheduled, for example for more
// shared memory than a block can have).
template <typename Kernel>
cudaError_t prepare_kernel(Kernel kernel, int cluster, int threads, int smem,
                           int* max_clusters) {
  int device = 0, optin = 0;
  cudaFuncAttributes attrs;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attrs.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *max_clusters = 0;
  if (smem > optin - (int)attrs.sharedSizeBytes) return cudaSuccess;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(cluster, cluster, threads, smem, nullptr, &attr);
  cfg.numAttrs = 1;  // the query needs the cluster shape, even of 1 block
  return cudaOccupancyMaxActiveClusters(max_clusters, (void*)kernel, &cfg);
}

}  // namespace
