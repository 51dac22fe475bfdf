// Fused GroupNorm(32) + affine + SiLU, forward (kernel K2).
//
// Replaces the TPU kernel `_kernel` of anoddpm_tpu/ops/pallas_norm.py
// (launched by `_fused_call`, wrapped by `group_norm_silu`).
//
//   mean, rstd = per (sample, group): E[x], rsqrt(max(E[x^2] - mean^2, 0) + eps)
//   y = x * (rstd * gamma_c) + (beta_c - mean * rstd * gamma_c)
//   out = y * sigmoid(y), stored in x's dtype (fp32 or bf16)
//
// Bound: bytes.  The least traffic is one read and one write of x; the
// arithmetic is a few operations per element.
//
// Design: one launch that reads x once.  x is NCHW-contiguous, so each
// (n, g) group is one contiguous run of L = (C/32) H W elements.  The group
// is cut into `cluster` slices of `slice_len` elements, one slice per block;
// the blocks of one group form a thread-block cluster (up to 16 blocks; one
// block when the group is small).  Each block
//   1. stages its slice in shared memory with 1-D bulk async copies
//      (cp.async.bulk in 4 chunks, each completing on its own mbarrier) and
//      sums x and x^2 in fp32 over each chunk as it lands;
//   2. combines the cluster's partial sums through distributed shared
//      memory: every block adds all partials in rank order, so all blocks
//      hold the same mean and rstd, and rank 0 writes them out;
//   3. writes silu(x * scale_c + shift_c) from shared memory with 16-byte
//      stores (8 bf16 or 4 fp32 a thread).
// The wrapper (anoddpm_torch/ops/group_norm_silu.py, `plan`) picks the
// cluster size, slice length, threads and shared-memory bytes.  A slice
// larger than its staging budget is not staged: the block reads it twice
// from global memory, the second time mostly from L2.  Where x or out is not
// 16-byte aligned, or H W is not a multiple of the 16-byte vector, the block
// runs the same two passes with scalar accesses straight from global memory.

#include <cooperative_groups.h>

#include "cluster_staging.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GROUPS = 32;
constexpr int MAX_THREADS = 256;
constexpr int CHUNKS = 4;

struct Params {
  const void* x;
  const float* gamma;
  const float* beta;
  void* out;
  float* mean;
  float* rstd;
  int c;          // channels
  int hw;         // H W
  int group_len;  // (C / 32) H W
  int cluster;    // blocks per group
  int slice_len;  // elements per block, a multiple of the vector width
  int vec;        // 16-byte accesses
  int staged;     // stage the slice in shared memory (16-byte mode only)
  float eps;
};

__device__ __forceinline__ float silu(float y) {
  return __fdividef(y, 1.0f + __expf(-y));
}

// s += x, ss += x^2 over the 16-byte vectors at src[i], i = begin, begin +
// step, ... < end.
template <typename T>
__device__ __forceinline__ void add_vectors(const T* src, int begin, int end,
                                            int step, float& s, float& ss) {
  constexpr int W = Vec<T>::N;
  for (int i = begin; i < end; i += step) {
    float v[W];
    Vec<T>::load(src + i, v);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      s += v[j];
      ss += v[j] * v[j];
    }
  }
}

// grid: (N * 32 * cluster) blocks; block b owns slice b % cluster of group
// b / cluster.  Launched with cluster dims (cluster, 1, 1) when cluster > 1.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    group_norm_silu_kernel(const Params p) {
  using V = Vec<T>;
  constexpr int W = V::N;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[CHUNKS];
  __shared__ float warp_sums[MAX_THREADS / 32][2];
  __shared__ float block_sums[2];
  __shared__ float stats[2];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rank = (int)(blockIdx.x % (unsigned)p.cluster);
  const int64_t group = blockIdx.x / (unsigned)p.cluster;  // n * 32 + g
  const int lo = rank * p.slice_len;  // slice start within the group
  const int len = min(p.slice_len, p.group_len - lo);
  const int64_t base = group * (int64_t)p.group_len + lo;
  const T* x = static_cast<const T*>(p.x) + base;
  T* out = static_cast<T*>(p.out) + base;
  T* buf = reinterpret_cast<T*>(smem);

  // Pass 1: fp32 sum and sum of squares of the slice.
  float s = 0.0f, ss = 0.0f;
  if (p.staged) {
    const int chunk = (len / W + CHUNKS - 1) / CHUNKS * W;
    if (tid == 0) {
      for (int k = 0; k < CHUNKS; ++k) mbar_init(&bars[k]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 0; k < CHUNKS; ++k) {
        const int b = k * chunk, e = min(len, b + chunk);
        if (e > b)
          bulk_load(buf + b, x + b, (uint32_t)((e - b) * sizeof(T)), &bars[k]);
      }
    }
    for (int k = 0; k < CHUNKS; ++k) {
      const int b = k * chunk, e = min(len, b + chunk);
      if (e <= b) break;
      mbar_wait(&bars[k]);
      add_vectors(buf, b + tid * W, e, nthreads * W, s, ss);
    }
  } else if (p.vec) {
    add_vectors(x, tid * W, len, nthreads * W, s, ss);
  } else {
    for (int i = tid; i < len; i += nthreads) {
      const float v = to_f(x[i]);
      s += v;
      ss += v * v;
    }
  }

  // The block's sums: each warp's, then warp 0 adds the warps'.
  const int lane = tid % 32;
  warp_sum2(s, ss);
  if (lane == 0) {
    warp_sums[tid / 32][0] = s;
    warp_sums[tid / 32][1] = ss;
  }
  __syncthreads();
  if (tid < 32) {
    const bool has = lane < nthreads / 32;
    s = has ? warp_sums[lane][0] : 0.0f;
    ss = has ? warp_sums[lane][1] : 0.0f;
    warp_sum2(s, ss);
    if (lane == 0) {
      block_sums[0] = s;
      block_sums[1] = ss;
    }
  }
  // The group's sums: warp 0 of every block of the cluster reads all blocks'
  // sums through distributed shared memory, lane r those of rank r, and adds
  // them in the same order, so that every block gets the same statistics.
  if (p.cluster > 1) {
    cluster_arrive();
    cluster_wait();
    if (tid < 32) {
      s = ss = 0.0f;
      if (lane < p.cluster) {
        const float* other =
            cg::this_cluster().map_shared_rank(block_sums, lane);
        s = other[0];
        ss = other[1];
      }
      warp_sum2(s, ss);
    }
  }
  if (tid == 0) {
    const float inv_n = 1.0f / (float)p.group_len;
    const float m = s * inv_n;
    const float var = fmaxf(ss * inv_n - m * m, 0.0f);
    const float r = rsqrtf(var + p.eps);
    stats[0] = m;
    stats[1] = r;
    if (rank == 0 && p.mean != nullptr) {
      p.mean[group] = m;
      p.rstd[group] = r;
    }
  }
  __syncthreads();
  // This block has read the others' sums; they may exit once all have.
  if (p.cluster > 1) cluster_arrive();

  // Pass 2: silu(x * scale_c + shift_c); channel = g C/32 + (offset / H W).
  const float mean = stats[0], rstd = stats[1];
  const int ch0 = (int)(group % GROUPS) * (p.c / GROUPS);
  if (p.vec) {
    const T* src = p.staged ? buf : x;
    for (int i = tid * W; i < len; i += nthreads * W) {
      const int ch = ch0 + (lo + i) / p.hw;
      const float scale = rstd * __ldg(p.gamma + ch);
      const float shift = __ldg(p.beta + ch) - mean * scale;
      float v[W];
      V::load(src + i, v);
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = silu(v[j] * scale + shift);
      V::store(out + i, v);
    }
  } else {
    for (int i = tid; i < len; i += nthreads) {
      const int ch = ch0 + (lo + i) / p.hw;
      const float scale = rstd * __ldg(p.gamma + ch);
      const float shift = __ldg(p.beta + ch) - mean * scale;
      from_f(out + i, silu(to_f(x[i]) * scale + shift));
    }
  }
  if (p.cluster > 1) cluster_wait();
}

template <typename T>
cudaError_t prepare(int cluster, int threads, int smem, int* max_clusters) {
  return prepare_kernel(group_norm_silu_kernel<T>, cluster, threads, smem,
                        max_clusters);
}

template <typename T>
cudaError_t launch(const Params& p, int n, int threads, int smem,
                   cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      n * GROUPS * p.cluster, p.cluster, threads, smem, stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, group_norm_silu_kernel<T>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Set the kernel's attributes on the current device and count the clusters
// of (cluster, threads, smem) it can hold at once into *max_clusters.
int group_norm_silu_prepare(int dtype_code, int cluster, int threads, int smem,
                            int* max_clusters) {
  if (dtype_code == 0)
    return (int)prepare<float>(cluster, threads, smem, max_clusters);
  if (dtype_code == 1)
    return (int)prepare<__nv_bfloat16>(cluster, threads, smem, max_clusters);
  return (int)cudaErrorInvalidValue;
}

// x, out: (n, c, hw) NCHW-contiguous, fp32 (dtype_code 0) or bf16 (1);
// gamma, beta: (c,) fp32; stats: (2, n, 32) fp32, mean then rstd, or null
// to skip them.
// cluster, slice_len, threads, smem: the wrapper's plan.
int group_norm_silu_forward(const void* x, const void* gamma, const void* beta,
                            void* out, void* stats, int n, int c, int hw,
                            int cluster, int slice_len, int threads, int smem,
                            float eps, int dtype_code, void* stream) {
  const int width = dtype_code == 0 ? 4 : 8;  // elements in 16 bytes
  Params p;
  p.x = x;
  p.gamma = (const float*)gamma;
  p.beta = (const float*)beta;
  p.out = out;
  p.mean = (float*)stats;
  p.rstd = stats == nullptr ? nullptr : (float*)stats + n * GROUPS;
  p.c = c;
  p.hw = hw;
  p.group_len = c / GROUPS * hw;
  p.cluster = cluster;
  p.slice_len = slice_len;
  p.vec = hw % width == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  p.staged = smem > 0 && p.vec;
  p.eps = eps;
  if (dtype_code == 0)
    return (int)launch<float>(p, n, threads, smem, (cudaStream_t)stream);
  if (dtype_code == 1)
    return (int)launch<__nv_bfloat16>(p, n, threads, smem,
                                      (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
