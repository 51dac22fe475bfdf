// Fused GroupNorm(32) + affine + SiLU, forward.
//
// Replaces the TPU kernel `_kernel` of anoddpm_tpu/ops/pallas_norm.py
// (launched by `_fused_call`, wrapped by `group_norm_silu`).
//
//   mean, rstd = per (sample, group): E[x], rsqrt(max(E[x^2] - mean^2, 0) + eps)
//   y = x * (rstd * gamma_c) + (beta_c - mean * rstd * gamma_c)
//   out = y * sigmoid(y), stored in x's dtype (fp32 or bf16)
//
// Bound: bytes.  The least traffic is one read and one write of x.  This
// simple design reads x twice (once for the statistics, once for the
// output), so it moves 1.5x the bound's bytes.
//
// Design: x is NCHW-contiguous, so each (n, g) group is one contiguous run
// of (C/32) H W elements.  Unlike the TPU kernel, which holds one sample in
// VMEM, blocks here run in parallel with nothing carried between them, so
// the statistics are a split reduction:
//   pass 1  grid (chunks, 32, N): each block sums one chunk of one group in
//           fp32 into partial sums of x and x^2 (wrapper-allocated scratch),
//           with enough chunks that N * 32 * chunks fills the 132 SMs;
//   pass 2  one thread per (n, g) adds its chunks' partials and writes mean
//           and rstd, which stay available for the backward;
//   pass 3  elementwise silu(x * scale_c + shift_c) over all of x, one
//           column of blocks per (n, c) plane (grid.x = N C, so any batch
//           fits the grid; grid.y splits the plane).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int GROUPS = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void partial_sums_kernel(const T* __restrict__ x,
                                    float* __restrict__ partial,
                                    int64_t group_len, int64_t chunk_len,
                                    int chunks) {
  const int chunk = blockIdx.x, g = blockIdx.y, n = blockIdx.z;
  const int64_t base = ((int64_t)n * GROUPS + g) * group_len;
  const int64_t begin = (int64_t)chunk * chunk_len;
  int64_t end = begin + chunk_len;
  if (end > group_len) end = group_len;
  float s = 0.0f, ss = 0.0f;
  for (int64_t i = begin + threadIdx.x; i < end; i += THREADS) {
    const float v = load_f(x, base + i);
    s += v;
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    ss += __shfl_down_sync(0xffffffffu, ss, off);
  }
  __shared__ float sh_s[THREADS / 32], sh_ss[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) { sh_s[warp] = s; sh_ss[warp] = ss; }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.0f, tss = 0.0f;
    for (int k = 0; k < THREADS / 32; ++k) { ts += sh_s[k]; tss += sh_ss[k]; }
    const int64_t slot = ((int64_t)n * GROUPS + g) * chunks + chunk;
    partial[2 * slot] = ts;
    partial[2 * slot + 1] = tss;
  }
}

__global__ void finalize_kernel(const float* __restrict__ partial,
                                float* __restrict__ mean,
                                float* __restrict__ rstd, int ngroups,
                                int chunks, int64_t group_len, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // n * GROUPS + g
  if (i >= ngroups) return;
  float s = 0.0f, ss = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    s += partial[2 * ((int64_t)i * chunks + c)];
    ss += partial[2 * ((int64_t)i * chunks + c) + 1];
  }
  const float inv_n = 1.0f / (float)group_len;
  const float m = s * inv_n;
  const float var = fmaxf(ss * inv_n - m * m, 0.0f);
  mean[i] = m;
  rstd[i] = rsqrtf(var + eps);
}

// One block column per (n, c) plane: the channel's scale and shift are
// computed once, then the block walks its share of the H W elements.
template <typename T>
__global__ void apply_kernel(const T* __restrict__ x,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             T* __restrict__ out, int c, int64_t hw) {
  const int64_t row = blockIdx.x;  // n * c + ch
  const int ch = (int)(row % c);
  const int64_t ng = (row / c) * GROUPS + ch / (c / GROUPS);
  const float scale = rstd[ng] * gamma[ch];
  const float shift = beta[ch] - mean[ng] * scale;
  const int64_t base = row * hw;
  for (int64_t j = (int64_t)blockIdx.y * THREADS + threadIdx.x; j < hw;
       j += (int64_t)gridDim.y * THREADS) {
    const float y = load_f(x, base + j) * scale + shift;
    store_f(out, base + j, y / (1.0f + __expf(-y)));
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out,
           void* mean, void* rstd, void* partial, int n, int c, int64_t hw,
           int chunks, float eps, cudaStream_t stream) {
  const int64_t group_len = (int64_t)(c / GROUPS) * hw;
  const int64_t chunk_len = (group_len + chunks - 1) / chunks;
  partial_sums_kernel<T><<<dim3(chunks, GROUPS, n), THREADS, 0, stream>>>(
      (const T*)x, (float*)partial, group_len, chunk_len, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ngroups = n * GROUPS;
  finalize_kernel<<<(ngroups + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      (const float*)partial, (float*)mean, (float*)rstd, ngroups, chunks,
      group_len, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Up to 4 elements a thread; the plane split stays within grid.y's 65535.
  int64_t per_row = (hw + 4 * THREADS - 1) / (4 * THREADS);
  if (per_row > 65535) per_row = 65535;
  apply_kernel<T><<<dim3((unsigned)(n * c), (unsigned)per_row), THREADS, 0,
                    stream>>>(
      (const T*)x, (const float*)gamma, (const float*)beta,
      (const float*)mean, (const float*)rstd, (T*)out, c, hw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x, out: (n, c, hw) NCHW-contiguous, fp32 (dtype_code 0) or bf16 (1);
// gamma, beta: (c,) fp32; mean, rstd: (n, 32) fp32;
// partial: (n, 32, chunks, 2) fp32 scratch.
int group_norm_silu_forward(const void* x, const void* gamma, const void* beta,
                            void* out, void* mean, void* rstd, void* partial,
                            int n, int c, long long hw, int chunks, float eps,
                            int dtype_code, void* stream) {
  if (dtype_code == 0)
    return launch<float>(x, gamma, beta, out, mean, rstd, partial, n, c, hw,
                         chunks, eps, (cudaStream_t)stream);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, out, mean, rstd, partial, n,
                                 c, hw, chunks, eps, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
