// Fused GroupNorm(32) + affine + SiLU, backward (kernel K2b).
//
// The gradient of kernel K2 (csrc/group_norm_silu.cu).  The TPU kernel's
// backward has no Pallas form: it is the closed form `_bwd` of
// anoddpm_tpu/ops/pallas_norm.py in plain XLA ops, which this kernel
// replaces.  From x, grad_out (g), gamma, beta and the forward's per-(n,
// group) mean and rstd:
//
//   xhat = (x - mean) * rstd,  z = xhat * gamma_c + beta_c,  s = sigmoid(z)
//   dz   = g * s * (1 + z (1 - s))
//   A[n, c] = sum_hw dz,  B[n, c] = sum_hw dz * xhat
//   dbeta_c = sum_n A[n, c],  dgamma_c = sum_n B[n, c]
//   m1 = sum_{c in group} gamma_c A[n, c] / L,  m2 = likewise with B
//   dx   = (dz * gamma_c - m1 - xhat * m2) * rstd,  stored in x's dtype
//
// with L = (C / 32) H W elements per group.
//
// Bound: bytes.  The least traffic is one read of x and of grad_out and one
// write of dx; the arithmetic is a few tens of operations per element.
//
// Design: K2's design applied to the backward, one launch that reads x and
// grad_out once, and a small second one for dgamma and dbeta.  Each (n, g)
// group is one contiguous run of L elements in x and in grad_out; it is cut
// into `cluster` slices of `slice_len` elements, one per block, and the
// blocks of a group form a thread-block cluster (up to 16 blocks; one block
// when the group is small).  Each block
//   1. stages its slice of x and of grad_out in shared memory with 1-D bulk
//      async copies (cp.async.bulk in 2 chunks, each chunk of both tensors
//      completing on its own mbarrier) and, as the chunks land, sums A and
//      B in fp32 for each channel its slice touches: the slice is cut at
//      channel boundaries into segments, each summed by a team of warps in
//      a fixed order (many small segments: one warp each; a few large ones:
//      all warps);
//   2. combines the cluster's per-channel sums through distributed shared
//      memory: every block adds the blocks' sums in one fixed order, so that
//      all blocks hold the same A[n, c], B[n, c] for the group's channels
//      and the same m1, m2; rank 0 writes A and B to a small (N, 2, C)
//      scratch;
//   3. writes dx from shared memory with 16-byte stores (dz recomputed from
//      the staged x and grad_out: nothing else goes to device memory);
//   4. dgamma and dbeta without float atomics: a second launch of one thread
//      per channel adds the scratch's A and B over n = 0 .. N-1 in order.
//      (The last cluster of each group could do it in the first launch,
//      found with an integer ticket, but the counters must then be zero on
//      entry and outlive the call, one set per stream; on an H100 that
//      saved no device time, only some host time per call:
//      scripts/torch_k2b_layouts.py --root.)
// Two runs give the same bits.  The wrapper (ops/group_norm_silu.py,
// `backward_plan`) picks the cluster size, slice length, threads and
// staging bytes.  Where the two slices exceed the staging budget (the 2 MB
// groups at 256^2), the block stages the slice of x alone and reads that of
// grad_out twice from global memory, the second time mostly from L2.  The
// slices are read from shared memory with shared-memory loads (the passes
// are compiled once per staging mode, so that the compiler knows the space).
// 2 chunks timed faster than 1, 4 and 8 (scripts/torch_k2b_layouts.py
// --root on copies with CHUNKS edited).
// Where x, grad_out or dx is not 16-byte aligned, or H W is not a multiple
// of the 16-byte vector, or the slice of x alone exceeds the staging budget
// (no site of the UNet), the block runs the same passes with scalar
// accesses straight from global memory.

#include <cooperative_groups.h>

#include "cluster_staging.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GROUPS = 32;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int CHUNKS = 2;

struct Params {
  const void* x;
  const void* g;
  const float* gamma;
  const float* beta;
  const float* mean;   // (n, 32)
  const float* rstd;   // (n, 32)
  void* dx;
  float* scratch;      // (n, 2, c): A[k], B[k] of sample k
  int n;
  int c;
  int hw;
  int group_len;       // (C / 32) H W
  int cluster;         // blocks per group
  int slice_len;       // elements per block, a multiple of the vector width
  int stage_bytes;     // staging bytes (the plan's)
  int staged;          // 16-byte accesses with staged slices: 2 of x and
                       // grad_out, 1 of x; 0: scalar accesses, nothing staged
};

// Shared memory beside the staged slices, per channel of the group:
// A, B of this block (2), gamma and beta (2), and the warps' partial A, B
// (2 per warp of a segment's team).
__host__ __device__ constexpr int channel_floats(int cpg) {
  return (4 + 2 * MAX_WARPS) * cpg;
}

// N consecutive elements of T (16 bytes when N > 1) to and from fp32.
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float* v) {
  if constexpr (N == 1) v[0] = to_f(*p); else Vec<T>::load(p, v);
}
template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float* v) {
  if constexpr (N == 1) from_f(p, v[0]); else Vec<T>::store(p, v);
}

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// dz of one element of channel (gam, bet), and its xhat, in the plain
// version's order (xhat = 0 where x = mean, as there).
__device__ __forceinline__ float grad_z(float xv, float gv, float mean,
                                        float rstd, float gam, float bet,
                                        float& xhat) {
  xhat = (xv - mean) * rstd;
  const float z = fmaf(xhat, gam, bet);
  const float s = rcp_approx(1.0f + ex2_approx(z * -1.44269504f));
  return gv * (s * fmaf(z, 1.0f - s, 1.0f));
}

// The block's work in units of N elements: N = the 16-byte vector, or 1
// (scalar accesses); STAGE: what is staged in shared memory: 2 the slices
// of x and grad_out, 1 that of x (grad_out is read twice from global
// memory, the second time mostly from L2), 0 nothing (N = 1 only).  grid:
// (n * 32 * cluster) blocks; block b owns slice b % cluster of group
// b / cluster = sample * 32 + g.
template <typename T, int N, int STAGE>
__device__ __forceinline__ void backward(const Params& p, unsigned char* smem,
                                         uint64_t* bars, float* stats) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = nthreads / 32;
  const int rank = (int)(blockIdx.x % (unsigned)p.cluster);
  const int group = (int)(blockIdx.x / (unsigned)p.cluster);
  const int sample = group / GROUPS, ch0 = (group % GROUPS) * (p.c / GROUPS);
  const int cpg = p.c / GROUPS;                    // channels per group
  const int lo = rank * p.slice_len;               // slice start in the group
  const int len = min(p.slice_len, p.group_len - lo);
  const int64_t base = (int64_t)group * p.group_len + lo;
  const T* x = static_cast<const T*>(p.x) + base;
  const T* g = static_cast<const T*>(p.g) + base;
  T* dx = static_cast<T*>(p.dx) + base;
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + p.slice_len;
  float* chan = reinterpret_cast<float*>(smem + p.stage_bytes);  // A | B
  float* gam = chan + 2 * cpg;
  float* bet = gam + cpg;
  float* part = bet + cpg;             // A | B per (segment, warp of team)
  const int part_b = MAX_WARPS * cpg;  // offset of the B half
  const float mean = __ldg(p.mean + group), rstd = __ldg(p.rstd + group);

  // Units of the slice, chunks of the staging, units per channel plane.
  const int units = len / N, upc = p.hw / N, lo_u = lo / N;
  const int chunk = (units + CHUNKS - 1) / CHUNKS;
  const int chunks = (units + chunk - 1) / chunk;
  if (STAGE > 0 && tid == 0) {  // the loads first, then the block's set-up
    for (int k = 0; k < chunks; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < chunks; ++k) {
      const int b = k * chunk, e = min(units, b + chunk);
      const uint32_t bytes = (uint32_t)((e - b) * N * sizeof(T));
      mbar_expect_tx(&bars[k], STAGE * bytes);
      bulk_copy(xs + b * N, x + b * N, bytes, &bars[k]);
      if (STAGE == 2) bulk_copy(gs + b * N, g + b * N, bytes, &bars[k]);
    }
  }
  for (int c = tid; c < cpg; c += nthreads) {
    gam[c] = __ldg(p.gamma + ch0 + c);
    bet[c] = __ldg(p.beta + ch0 + c);
    chan[c] = chan[cpg + c] = 0.0f;
  }
  __syncthreads();
  // where the passes read: shared memory (the compiler then emits shared
  // loads) or global memory
  const T* xsrc = x;
  const T* gsrc = g;
  if constexpr (STAGE > 0) xsrc = xs;
  if constexpr (STAGE == 2) gsrc = gs;

  // Pass 1: A and B of each channel segment of the slice.  Segment s
  // (channel cf + s) is summed by team s % teams, of tsize warps; every
  // thread walks its units in increasing order, waiting for each chunk as
  // it reaches it.
  const int cf = lo_u / upc, nseg = (lo_u + units - 1) / upc - cf + 1;
  int teams = 1;
  if (units < 2 * nthreads * nseg)  // small segments: fewer warps each
    while (teams * 2 <= nwarps && teams * 2 <= nseg) teams *= 2;
  const int tsize = nwarps / teams, team = warp / tsize;
  const int tt = tid % (tsize * 32);
  int waited = 0, ready = 0;  // chunks waited for; units they hold
  for (int s = team; s < nseg; s += teams) {
    const int ch = cf + s;
    const int sb = max(lo_u, ch * upc) - lo_u;
    const int se = min(lo_u + units, (ch + 1) * upc) - lo_u;
    const float gm = gam[ch], bt = bet[ch];
    float av[N], bv[N];  // one sum per lane of the vector: N chains, not 1
#pragma unroll
    for (int j = 0; j < N; ++j) av[j] = bv[j] = 0.0f;
    for (int i = sb + tt; i < se; i += tsize * 32) {
      if constexpr (STAGE > 0)
        for (; i >= ready; ready += chunk) mbar_wait(&bars[waited++]);
      float xv[N], gv[N];
      load_n<T, N>(xsrc + i * N, xv);
      load_n<T, N>(gsrc + i * N, gv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float xhat;
        const float dz = grad_z(xv[j], gv[j], mean, rstd, gm, bt, xhat);
        av[j] += dz;
        bv[j] = fmaf(dz, xhat, bv[j]);
      }
    }
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a += av[j];
      b += bv[j];
    }
    warp_sum2(a, b);
    if (lane == 0) {
      part[s * tsize + warp % tsize] = a;
      part[part_b + s * tsize + warp % tsize] = b;
    }
  }
  if constexpr (STAGE > 0)  // pass 2 reads every chunk
    for (; waited < chunks; ++waited) mbar_wait(&bars[waited]);
  __syncthreads();
  // This block's A and B per channel: its team's warps in order.
  for (int s = tid; s < nseg; s += nthreads) {
    float a = 0.0f, b = 0.0f;
    for (int w = 0; w < tsize; ++w) {
      a += part[s * tsize + w];
      b += part[part_b + s * tsize + w];
    }
    chan[cf + s] = a;
    chan[cpg + cf + s] = b;
  }

  // The group's A and B per channel: warp 0 of every block reads all
  // blocks' sums through distributed shared memory and adds them in a fixed
  // order, the same in every block.  Its lanes form 32 / w segments of w
  // lanes (w: the cluster size rounded up to a power of 2); in each round
  // segment j takes one channel, lane r of it reads rank r's sums, and an
  // xor tree adds them.  Then m1 and m2.
  if (p.cluster > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (warp == 0) {
    int w = 1;
    while (w < p.cluster) w *= 2;
    const int r = lane % w;
    const float* from = chan;
    if (p.cluster > 1 && r < p.cluster)
      from = cg::this_cluster().map_shared_rank(chan, r);
    float* scratch = p.scratch + (size_t)sample * 2 * p.c + ch0;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c0 = 0; c0 < cpg; c0 += 32 / w) {
      const int c = c0 + lane / w;
      const bool has = r < p.cluster && c < cpg;
      float a = has ? from[c] : 0.0f, b = has ? from[cpg + c] : 0.0f;
      for (int off = w / 2; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
      if (r == 0 && c < cpg) {
        if (rank == 0) {
          scratch[c] = a;
          scratch[p.c + c] = b;
        }
        s1 += gam[c] * a;
        s2 += gam[c] * b;
      }
    }
    warp_sum2(s1, s2);
    if (lane == 0) {
      const float inv_len = 1.0f / (float)p.group_len;
      stats[0] = s1 * inv_len;
      stats[1] = s2 * inv_len;
    }
  }
  __syncthreads();
  // This block has read the others' sums; they may exit once all have.
  if (p.cluster > 1) cluster_arrive();

  // Pass 2: dx = (dz gamma_c - m1 - xhat m2) rstd; each thread follows the
  // channel of its units as it walks them.
  const float m1 = stats[0], m2 = stats[1];
  int ch = (lo_u + tid) / upc, next = (ch + 1) * upc - lo_u;
  float gm = gam[min(ch, cpg - 1)], bt = bet[min(ch, cpg - 1)];
  for (int i = tid; i < units; i += nthreads) {
    if (i >= next) {
      do {
        ++ch;
        next += upc;
      } while (i >= next);
      gm = gam[ch];
      bt = bet[ch];
    }
    float xv[N], gv[N];
    load_n<T, N>(xsrc + i * N, xv);
    load_n<T, N>(gsrc + i * N, gv);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float xhat;
      const float dz = grad_z(xv[j], gv[j], mean, rstd, gm, bt, xhat);
      xv[j] = fmaf(-xhat, m2, fmaf(dz, gm, -m1)) * rstd;
    }
    store_n<T, N>(dx + i * N, xv);
  }
  if (p.cluster > 1) cluster_wait();
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    group_norm_silu_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[CHUNKS];
  __shared__ float stats[2];  // m1, m2
  if (p.staged == 2)
    backward<T, Vec<T>::N, 2>(p, smem, bars, stats);
  else if (p.staged == 1)
    backward<T, Vec<T>::N, 1>(p, smem, bars, stats);
  else
    backward<T, 1, 0>(p, smem, bars, stats);
}

// dbeta_c = sum_n A[n, c] and dgamma_c = sum_n B[n, c] from the (n, 2, c)
// scratch, in order of n: one thread per channel.
constexpr int SUM_THREADS = 128;

__global__ void __launch_bounds__(SUM_THREADS)
    group_norm_silu_bwd_sum_kernel(const float* scratch, float* dgamma,
                                   float* dbeta, int n, int c) {
  const int ch = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (ch >= c) return;
  float a = 0.0f, b = 0.0f;
  for (int k = 0; k < n; ++k) {
    a += scratch[(size_t)k * 2 * c + ch];
    b += scratch[(size_t)k * 2 * c + c + ch];
  }
  dbeta[ch] = a;
  dgamma[ch] = b;
}

// Dynamic shared memory of a block: the staged slices and the per-channel
// floats.
int dynamic_smem(int c, int stage_bytes) {
  return stage_bytes + channel_floats(c / GROUPS) * (int)sizeof(float);
}

// The two launches of one call on `stream`.
template <typename T>
cudaError_t launch(const Params& p, int threads, float* dgamma, float* dbeta,
                   cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      p.n * GROUPS * p.cluster, p.cluster, threads,
      dynamic_smem(p.c, p.stage_bytes), stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, group_norm_silu_bwd_kernel<T>, p);
  if (err != cudaSuccess) return err;
  group_norm_silu_bwd_sum_kernel<<<(p.c + SUM_THREADS - 1) / SUM_THREADS,
                                   SUM_THREADS, 0, stream>>>(
      p.scratch, dgamma, dbeta, p.n, p.c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Set the kernel's attributes on the current device and count the clusters
// of (cluster, threads, staging bytes) at c channels that it can hold at
// once into *max_clusters.
int group_norm_silu_backward_prepare(int dtype_code, int c, int cluster,
                                     int threads, int smem,
                                     int* max_clusters) {
  const int bytes = dynamic_smem(c, smem);
  if (dtype_code == 0)
    return (int)prepare_kernel(group_norm_silu_bwd_kernel<float>, cluster,
                               threads, bytes, max_clusters);
  if (dtype_code == 1)
    return (int)prepare_kernel(group_norm_silu_bwd_kernel<__nv_bfloat16>,
                               cluster, threads, bytes, max_clusters);
  return (int)cudaErrorInvalidValue;
}

// The arguments of one call, packed by the wrapper
// (ops/group_norm_silu.py, `_backward_launch_args`) in this order.
struct Call {
  const void* x;         // (n, c, hw) NCHW-contiguous, fp32 or bf16
  const void* grad_out;  // as x
  const void* gamma;     // (c,) fp32
  const void* beta;      // (c,) fp32
  const void* mean;      // (n, 32) fp32
  const void* rstd;      // (n, 32) fp32
  void* dx;              // as x
  void* dgamma;          // (c,) fp32
  void* dbeta;           // (c,) fp32
  void* scratch;         // (n, 2, c) fp32
  void* stream;
  int n, c, hw;
  int cluster, slice_len, threads, smem;  // the wrapper's plan
  int dtype_code;        // 0: fp32, 1: bf16
};

// The call's two launches on a->stream.
int group_norm_silu_backward(const Call* a) {
  const int width = a->dtype_code == 0 ? 4 : 8;  // elements in 16 bytes
  Params p;
  p.x = a->x;
  p.g = a->grad_out;
  p.gamma = (const float*)a->gamma;
  p.beta = (const float*)a->beta;
  p.mean = (const float*)a->mean;
  p.rstd = (const float*)a->rstd;
  p.dx = a->dx;
  p.scratch = (float*)a->scratch;
  p.n = a->n;
  p.c = a->c;
  p.hw = a->hw;
  p.group_len = a->c / GROUPS * a->hw;
  p.cluster = a->cluster;
  p.slice_len = a->slice_len;
  p.stage_bytes = a->smem;
  const bool vec = a->hw % width == 0 && (uintptr_t)a->x % 16 == 0 &&
                   (uintptr_t)a->grad_out % 16 == 0 &&
                   (uintptr_t)a->dx % 16 == 0;
  // smem holds the slices of x and grad_out, that of x, or nothing
  p.staged = vec ? a->smem / (a->slice_len * (a->dtype_code == 0 ? 4 : 2))
                 : 0;
  float* dgamma = (float*)a->dgamma;
  float* dbeta = (float*)a->dbeta;
  const cudaStream_t stream = (cudaStream_t)a->stream;
  if (a->dtype_code == 0)
    return (int)launch<float>(p, a->threads, dgamma, dbeta, stream);
  if (a->dtype_code == 1)
    return (int)launch<__nv_bfloat16>(p, a->threads, dgamma, dbeta, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
