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
// Design (simple first): two launches per call, each reading x and grad_out
// once, so the data is read twice in all.  The (n, c) planes are cut into
// `chunks` chunks of `chunk_len` elements; one warp owns one (plane, chunk)
// unit in both launches.
//   1. reduce: each warp sums dz and dz * xhat over its unit in fp32 (each
//      lane in a fixed order, then a fixed xor-shuffle tree) and writes the
//      pair to a partials array.
//   2. apply: each warp adds its group's partials, weighted by gamma, in a
//      fixed order (every warp of a group gets the same bits), and the warp
//      of (n = 0, chunk 0) of channel c also adds channel c's partials over
//      n and chunks into dgamma_c and dbeta_c; then it writes dx for its
//      unit.
// No float atomics: two runs give the same bits.  Where x, grad_out or dx is
// not 16-byte aligned, or H W is not a multiple of the 16-byte vector, the
// warps use scalar accesses.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int GROUPS = 32;
constexpr int WARPS = 8;  // warps (units) per block

struct Params {
  const void* x;
  const void* g;
  const float* gamma;
  const float* beta;
  const float* mean;   // (n, 32)
  const float* rstd;   // (n, 32)
  float* part;         // (2, units): sums of dz, then of dz * xhat
  void* dx;
  float* dgamma;       // (c,)
  float* dbeta;        // (c,)
  int n;
  int c;
  int hw;
  int chunk_len;       // a multiple of 32 vectors
  int chunks;          // per plane
  long long units;     // n * c * chunks
  int vec;             // 16-byte accesses
};

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

// Sum a and b over the warp in a fixed order; every lane gets the totals.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// The per-unit constants: where the unit's elements lie and the scalars of
// its (n, c) plane.
struct Unit {
  long long plane;  // n * c + channel
  int n, ch, lo, hi;
  float mean, rstd, gam, bet;
};

__device__ __forceinline__ Unit unit_of(const Params& p, long long u) {
  Unit w;
  w.plane = u / p.chunks;
  const int k = (int)(u - w.plane * p.chunks);
  w.n = (int)(w.plane / p.c);
  w.ch = (int)(w.plane - (long long)w.n * p.c);
  const int grp = w.ch / (p.c / GROUPS);
  w.lo = k * p.chunk_len;
  w.hi = min(p.hw, w.lo + p.chunk_len);
  w.mean = __ldg(p.mean + w.n * GROUPS + grp);
  w.rstd = __ldg(p.rstd + w.n * GROUPS + grp);
  w.gam = __ldg(p.gamma + w.ch);
  w.bet = __ldg(p.beta + w.ch);
  return w;
}

// dz and xhat of one element.
__device__ __forceinline__ float grad_z(const Unit& w, float xv, float gv,
                                        float& xhat) {
  xhat = (xv - w.mean) * w.rstd;
  const float z = xhat * w.gam + w.bet;
  const float s = 1.0f / (1.0f + expf(-z));
  return gv * s * (1.0f + z * (1.0f - s));
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    group_norm_silu_bwd_reduce_kernel(const Params p) {
  const int lane = threadIdx.x % 32;
  const long long u = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (u >= p.units) return;  // the whole warp
  const Unit w = unit_of(p, u);
  const long long base = w.plane * p.hw;
  const T* x = static_cast<const T*>(p.x) + base;
  const T* g = static_cast<const T*>(p.g) + base;
  float a = 0.0f, b = 0.0f, xhat;
  if (p.vec) {
    constexpr int W = Vec<T>::N;
    for (int i = w.lo + lane * W; i < w.hi; i += 32 * W) {
      float xv[W], gv[W];
      Vec<T>::load(x + i, xv);
      Vec<T>::load(g + i, gv);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const float dz = grad_z(w, xv[j], gv[j], xhat);
        a += dz;
        b += dz * xhat;
      }
    }
  } else {
    for (int i = w.lo + lane; i < w.hi; i += 32) {
      const float dz = grad_z(w, to_f(x[i]), to_f(g[i]), xhat);
      a += dz;
      b += dz * xhat;
    }
  }
  warp_sum2(a, b);
  if (lane == 0) {
    p.part[u] = a;
    p.part[p.units + u] = b;
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    group_norm_silu_bwd_apply_kernel(const Params p) {
  const int lane = threadIdx.x % 32;
  const long long u = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (u >= p.units) return;  // the whole warp
  const Unit w = unit_of(p, u);
  const int cg = p.c / GROUPS;
  const float* pa = p.part;
  const float* pb = p.part + p.units;

  // m1, m2 of the unit's group: its cg planes' partials lie side by side.
  const long long first = (w.plane - w.ch % cg) * p.chunks;
  float s1 = 0.0f, s2 = 0.0f;
  for (int j = lane; j < cg * p.chunks; j += 32) {
    const float gam = __ldg(p.gamma + (w.ch - w.ch % cg) + j / p.chunks);
    s1 += gam * pa[first + j];
    s2 += gam * pb[first + j];
  }
  warp_sum2(s1, s2);
  const float inv_len = 1.0f / ((float)cg * (float)p.hw);
  const float m1 = s1 * inv_len, m2 = s2 * inv_len;

  // dgamma_c and dbeta_c, by the warp of (n = 0, chunk 0) of channel c.
  if (w.n == 0 && w.lo == 0) {
    float db = 0.0f, dg = 0.0f;
    for (int j = lane; j < p.n * p.chunks; j += 32) {
      const long long at = ((long long)(j / p.chunks) * p.c + w.ch) * p.chunks
                           + j % p.chunks;
      db += pa[at];
      dg += pb[at];
    }
    warp_sum2(db, dg);
    if (lane == 0) {
      p.dbeta[w.ch] = db;
      p.dgamma[w.ch] = dg;
    }
  }

  const long long base = w.plane * p.hw;
  const T* x = static_cast<const T*>(p.x) + base;
  const T* g = static_cast<const T*>(p.g) + base;
  T* dx = static_cast<T*>(p.dx) + base;
  float xhat;
  if (p.vec) {
    constexpr int W = Vec<T>::N;
    for (int i = w.lo + lane * W; i < w.hi; i += 32 * W) {
      float xv[W], gv[W];
      Vec<T>::load(x + i, xv);
      Vec<T>::load(g + i, gv);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const float dz = grad_z(w, xv[j], gv[j], xhat);
        xv[j] = (dz * w.gam - m1 - xhat * m2) * w.rstd;
      }
      Vec<T>::store(dx + i, xv);
    }
  } else {
    for (int i = w.lo + lane; i < w.hi; i += 32) {
      const float dz = grad_z(w, to_f(x[i]), to_f(g[i]), xhat);
      from_f(dx + i, (dz * w.gam - m1 - xhat * m2) * w.rstd);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((p.units + WARPS - 1) / WARPS);
  group_norm_silu_bwd_reduce_kernel<T><<<blocks, WARPS * 32, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_norm_silu_bwd_apply_kernel<T><<<blocks, WARPS * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x, grad_out, dx: (n, c, hw) NCHW-contiguous, fp32 (dtype_code 0) or bf16
// (1); gamma, beta: (c,) fp32; mean, rstd: (n, 32) fp32; part: (2, n c
// chunks) fp32 scratch; dgamma, dbeta: (c,) fp32 outputs.  chunk_len and
// chunks: the wrapper's plan.  Launches two kernels on `stream`.
int group_norm_silu_backward(const void* x, const void* grad_out,
                             const void* gamma, const void* beta,
                             const void* mean, const void* rstd, void* part,
                             void* dx, void* dgamma, void* dbeta, int n, int c,
                             int hw, int chunk_len, int chunks, int dtype_code,
                             void* stream) {
  const int width = dtype_code == 0 ? 4 : 8;  // elements in 16 bytes
  Params p;
  p.x = x;
  p.g = grad_out;
  p.gamma = (const float*)gamma;
  p.beta = (const float*)beta;
  p.mean = (const float*)mean;
  p.rstd = (const float*)rstd;
  p.part = (float*)part;
  p.dx = dx;
  p.dgamma = (float*)dgamma;
  p.dbeta = (float*)dbeta;
  p.n = n;
  p.c = c;
  p.hw = hw;
  p.chunk_len = chunk_len;
  p.chunks = chunks;
  p.units = (long long)n * c * chunks;
  p.vec = hw % width == 0 && (uintptr_t)x % 16 == 0 &&
          (uintptr_t)grad_out % 16 == 0 && (uintptr_t)dx % 16 == 0;
  if (dtype_code == 0) return (int)launch<float>(p, (cudaStream_t)stream);
  if (dtype_code == 1)
    return (int)launch<__nv_bfloat16>(p, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
