// Fused GroupNorm(32) + affine + SiLU, forward (kernel K2).
//
// Replaces the TPU kernel `_kernel` of anoddpm_tpu/ops/pallas_norm.py
// (launched by `_fused_call`, wrapped by `group_norm_silu`).
//
//   mean, rstd = per (sample, group): E[x], rsqrt(max(E[x^2] - mean^2, 0) + eps)
//   y = x * (rstd * gamma_c) + (beta_c - mean * rstd * gamma_c)
//   out = y * sigmoid(y), stored in x's dtype (fp32 or bf16)
//
// A second order (ORDER_FLAX) computes the same site in the order of the
// JAX package's default UNet, flax's GroupNorm32 then `nn.silu` in x's
// dtype (anoddpm_tpu/models/unet.py:48-83, plain XLA there): var =
// max(E[x^2] - mean^2, 0) with the mean and E[x^2] divided by the group's
// length, rstd = 1 / sqrt(var + eps), h = (x - mean) * (rstd * gamma_c) +
// beta_c rounded once to x's dtype, then SiLU op by op in that dtype
// (`flax_norm_value`, `jax_sigmoid` in cluster_staging.cuh).  Everything
// else, the layout and the passes, is the same.  At a bf16 site the SiLU
// of h takes its sigmoid from a table over h's bits (cluster_staging.cuh,
// `flax_table_index`): `flax_sigmoid_table` holds s(h) as bf16 for each
// slot, filled once per card by the same device function
// (`group_norm_silu_prepare` launches `fill_flax_table`), so that the
// outputs keep their bits while the expf, the division and three roundings
// per element become one table load (out = h s is one multiply).  Each
// block copies the table into shared memory beside its slice as its first
// bulk copy (timed 15% faster a forward than reading it from global memory
// through L1: scripts/torch_k2_layouts.py --root on such a copy);
// `group_norm_silu_flax_table_probe` holds the table against the direct
// computation at all 65,536 bf16 values of h.
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
constexpr int ORDER_KERNEL = 0;  // the TPU kernel's order
constexpr int ORDER_FLAX = 1;    // flax's GroupNorm, then SiLU in x's dtype

// The flax order's sigmoid s(h) per slot of h (bf16 bits).
__device__ __align__(16) uint16_t flax_sigmoid_table[FLAX_TABLE_ENTRIES];
constexpr int FLAX_TABLE_BYTES = FLAX_TABLE_ENTRIES * 2;

// Whether ORDER's kernel at T reads the table, and the table's bytes in a
// block's dynamic shared memory.
template <typename T, int ORDER>
__host__ __device__ constexpr bool uses_table() {
  return ORDER == ORDER_FLAX && sizeof(T) == 2;
}
template <typename T, int ORDER>
__host__ __device__ constexpr int table_smem() {
  return uses_table<T, ORDER>() ? FLAX_TABLE_BYTES : 0;
}

// The direct flax-order sigmoid of the bf16 value h, as bf16 bits.
__device__ __forceinline__ uint16_t flax_sigmoid_direct(float h) {
  return (uint16_t)(__float_as_uint(jax_sigmoid<__nv_bfloat16>(h)) >> 16);
}

__global__ void fill_flax_table() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < FLAX_TABLE_ENTRIES)
    flax_sigmoid_table[i] = flax_sigmoid_direct(flax_table_h(i));
}

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

// One output element from x's value v: in ORDER's order, with (a, b) the
// channel's (scale, shift) for ORDER_KERNEL and (mul, beta) for ORDER_FLAX;
// at a bf16 site of ORDER_FLAX from the staged table `tab`.
template <typename T, int ORDER>
__device__ __forceinline__ float site(float v, float mean, float a, float b,
                                      const uint16_t* tab) {
  if constexpr (ORDER == ORDER_KERNEL) {
    return silu(v * a + b);
  } else if constexpr (uses_table<T, ORDER>()) {
    uint32_t bits;
    const float h = bf16_round_bits(flax_norm_value(v, mean, a, b), bits);
    const int i = flax_table_index(bits);
    return __fmul_rn(h, __uint_as_float((uint32_t)tab[i] << 16));
  } else {
    const float h = round_to<T>(flax_norm_value(v, mean, a, b));
    return __fmul_rn(h, jax_sigmoid<T>(h));
  }
}

// grid: (N * 32 * cluster) blocks; block b owns slice b % cluster of group
// b / cluster.  Launched with cluster dims (cluster, 1, 1) when cluster > 1.
template <typename T, int ORDER>
__global__ void __launch_bounds__(MAX_THREADS)
    group_norm_silu_kernel(const Params p) {
  using V = Vec<T>;
  constexpr int W = V::N;
  extern __shared__ __align__(16) unsigned char smem[];
  // the chunks' mbarriers, then the table's where it is staged
  __shared__ __align__(8) uint64_t bars[CHUNKS + (table_smem<T, ORDER>() > 0)];
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
  // the sigmoid table: behind the staged slice, copied in first
  const uint16_t* tab = flax_sigmoid_table;
  if constexpr (table_smem<T, ORDER>() > 0) {
    uint16_t* staged_tab = reinterpret_cast<uint16_t*>(
        smem + (p.staged ? p.slice_len * sizeof(T) : 0));
    if (tid == 0) {
      mbar_init(&bars[CHUNKS]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      bulk_load(staged_tab, flax_sigmoid_table, FLAX_TABLE_BYTES,
                &bars[CHUNKS]);
    }
    tab = staged_tab;
  }

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
    float m, r;
    if constexpr (ORDER == ORDER_KERNEL) {
      const float inv_n = 1.0f / (float)p.group_len;
      m = s * inv_n;
      r = rsqrtf(fmaxf(ss * inv_n - m * m, 0.0f) + p.eps);
    } else {
      const float len = (float)p.group_len;
      m = __fdiv_rn(s, len);
      const float var = fmaxf(__fsub_rn(__fdiv_rn(ss, len), __fmul_rn(m, m)),
                              0.0f);
      r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps)));
    }
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

  // Pass 2: each element of channel g C/32 + (offset / H W), from the
  // channel's (scale, shift) = (rstd gamma_c, beta_c - mean scale) in K2's
  // order, (mul, beta_c) = (rstd gamma_c, beta_c) in flax's.
  const float mean = stats[0], rstd = stats[1];
  if constexpr (table_smem<T, ORDER>() > 0) mbar_wait(&bars[CHUNKS]);
  const int ch0 = (int)(group % GROUPS) * (p.c / GROUPS);
  auto channel = [&](int ch, float& a, float& b) {
    a = __fmul_rn(rstd, __ldg(p.gamma + ch));
    b = ORDER == ORDER_KERNEL ? __ldg(p.beta + ch) - mean * a
                              : __ldg(p.beta + ch);
  };
  if (p.vec) {
    const T* src = p.staged ? buf : x;
    for (int i = tid * W; i < len; i += nthreads * W) {
      float a, b;
      channel(ch0 + (lo + i) / p.hw, a, b);
      float v[W];
      V::load(src + i, v);
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = site<T, ORDER>(v[j], mean, a, b, tab);
      V::store(out + i, v);
    }
  } else {
    for (int i = tid; i < len; i += nthreads) {
      float a, b;
      channel(ch0 + (lo + i) / p.hw, a, b);
      from_f(out + i, site<T, ORDER>(to_f(x[i]), mean, a, b, tab));
    }
  }
  if (p.cluster > 1) cluster_wait();
}

// Fill the current card's sigmoid table once (outside any graph capture: the
// wrapper's prepare step).
cudaError_t ensure_flax_table() {
  return fill_table_once(fill_flax_table, FLAX_TABLE_ENTRIES);
}

// Both orders' kernels set up (the flax order's bf16 kernel with its
// table's shared memory too); the clusters the card holds at once of the
// one that holds fewer.
template <typename T>
cudaError_t prepare(int cluster, int threads, int smem, int* max_clusters) {
  int flax = 0;
  cudaError_t err = prepare_kernel(group_norm_silu_kernel<T, ORDER_KERNEL>,
                                   cluster, threads, smem, max_clusters);
  if (err == cudaSuccess)
    err = prepare_kernel(group_norm_silu_kernel<T, ORDER_FLAX>, cluster,
                         threads, smem + table_smem<T, ORDER_FLAX>(), &flax);
  if (flax < *max_clusters) *max_clusters = flax;
  return err;
}

template <typename T, int ORDER>
cudaError_t launch(const Params& p, int n, int threads, int smem,
                   cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(n * GROUPS * p.cluster, p.cluster, threads,
                    smem + table_smem<T, ORDER>(), stream, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, group_norm_silu_kernel<T, ORDER>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_order(const Params& p, int n, int threads, int smem,
                         int order, cudaStream_t stream) {
  return order == ORDER_KERNEL
             ? launch<T, ORDER_KERNEL>(p, n, threads, smem, stream)
             : launch<T, ORDER_FLAX>(p, n, threads, smem, stream);
}

// Every bf16 value h (by its bits): the table's sigmoid and the direct one.
__global__ void flax_table_probe_kernel(uint16_t* from_table,
                                        uint16_t* direct) {
  const uint32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b > 0xFFFFu) return;
  from_table[b] = flax_sigmoid_table[flax_table_index(b)];
  direct[b] = flax_sigmoid_direct(__uint_as_float(b << 16));
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Fill the current device's flax-order table if it is not yet, set the
// kernels' attributes and count the clusters of (cluster, threads, smem)
// they can hold at once into *max_clusters.
int group_norm_silu_prepare(int dtype_code, int cluster, int threads, int smem,
                            int* max_clusters) {
  const cudaError_t err = ensure_flax_table();
  if (err != cudaSuccess) return (int)err;
  if (dtype_code == 0)
    return (int)prepare<float>(cluster, threads, smem, max_clusters);
  if (dtype_code == 1)
    return (int)prepare<__nv_bfloat16>(cluster, threads, smem, max_clusters);
  return (int)cudaErrorInvalidValue;
}

// The sigmoid table against the direct computation (both as bf16 bits) at
// every bf16 value h = bits b: from_table[b], direct[b], 65,536 each.
int group_norm_silu_flax_table_probe(void* from_table, void* direct,
                                     void* stream) {
  cudaError_t err = ensure_flax_table();
  if (err != cudaSuccess) return (int)err;
  flax_table_probe_kernel<<<256, 256, 0, (cudaStream_t)stream>>>(
      (uint16_t*)from_table, (uint16_t*)direct);
  return (int)cudaGetLastError();
}

// x, out: (n, c, hw) NCHW-contiguous, fp32 (dtype_code 0) or bf16 (1);
// gamma, beta: (c,) fp32; stats: (2, n, 32) fp32, mean then rstd, or null
// to skip them.
// cluster, slice_len, threads, smem: the wrapper's plan.
// order: 0 the TPU kernel's, 1 flax's (ORDER_KERNEL, ORDER_FLAX).
int group_norm_silu_forward(const void* x, const void* gamma, const void* beta,
                            void* out, void* stats, int n, int c, int hw,
                            int cluster, int slice_len, int threads, int smem,
                            float eps, int dtype_code, int order,
                            void* stream) {
  if (order != ORDER_KERNEL && order != ORDER_FLAX)
    return (int)cudaErrorInvalidValue;
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
    return (int)launch_order<float>(p, n, threads, smem, order,
                                    (cudaStream_t)stream);
  if (dtype_code == 1)
    return (int)launch_order<__nv_bfloat16>(p, n, threads, smem, order,
                                            (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
