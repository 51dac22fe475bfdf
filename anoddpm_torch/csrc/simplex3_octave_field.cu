// Multi-octave 3-D OpenSimplex field on a fixed z = t plane, hash path.
//
// Replaces the TPU kernel `_field_kernel` of scripts/pallas_vs_xla_noise.py
// (launched by `fields_pallas`), whose production form in the JAX package is
// `anoddpm_tpu/ops/simplex.py:batched_fractal3_fixed_t` over `opensimplex3_hash`.
//
//   out[i, y, x] = sum_{o < octaves} persistence^o
//                  * noise3_hash(seed_i, x * 2^o / f, y * 2^o / f, t_i * 2^o / f)
//
// Bound: operations.  The only memory traffic is the 4 n H W-byte store (and
// 12 bytes of seed and t per field); each pixel runs the cell walk, ten
// lattice hashes and the region logic once per octave, all in registers.
//
// Design: one thread per output pixel, blocks of 32 x 8 pixels, grid
// (W/32, H/8, n).  Each block reads its own field's seed and t (no scalar
// prefetch).  The octave loop runs in registers with the hash in native
// uint32 and one fp32 store.  Every float multiply, and every add that
// could meet one, is an __f*_rn intrinsic, which the compiler never
// contracts into an FMA: above all the skew, the x + stretch terms and the
// squish, so that floor() picks the same lattice cell as the plain PyTorch
// version (anoddpm_torch/ops/simplex.py), which rounds after every
// operation.  The octave scale is (1/f) * 2^o and the amplitude a running
// product of the persistence, both as in the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float STRETCH3 = (float)(-1.0 / 6.0);
constexpr float SQUISH3 = (float)(1.0 / 3.0);
constexpr float NORM3 = 103.0f;

__device__ __forceinline__ unsigned hash_grad_id(unsigned seed, int xi, int yi,
                                                 int zi) {
  unsigned h = ((unsigned)xi * 0x8DA6B343u) ^ ((unsigned)yi * 0xD8163841u) ^
               ((unsigned)zi * 0xCB1AB31Fu) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h % 24u;
}

// Radial-falloff contribution of the lattice vertex (xsb+ox, ysb+oy, zsb+oz).
__device__ __forceinline__ float contrib(unsigned seed, int xsb, int ysb,
                                         int zsb, float dx0, float dy0,
                                         float dz0, int ox, int oy, int oz) {
  const float sq = __fmul_rn(SQUISH3, (float)(ox + oy + oz));
  const float dx = __fsub_rn(__fsub_rn(dx0, (float)ox), sq);
  const float dy = __fsub_rn(__fsub_rn(dy0, (float)oy), sq);
  const float dz = __fsub_rn(__fsub_rn(dz0, (float)oz), sq);
  float attn = __fsub_rn(__fsub_rn(__fsub_rn(2.0f, __fmul_rn(dx, dx)),
                                   __fmul_rn(dy, dy)),
                         __fmul_rn(dz, dz));
  const unsigned gid = hash_grad_id(seed, xsb + ox, ysb + oy, zsb + oz);
  const unsigned m = gid % 3u, q = gid / 3u;
  const float gx = ((q & 1u) ? 1.0f : -1.0f) * (m == 0u ? 11.0f : 4.0f);
  const float gy = ((q & 2u) ? -1.0f : 1.0f) * (m == 1u ? 11.0f : 4.0f);
  const float gz = ((q & 4u) ? -1.0f : 1.0f) * (m == 2u ? 11.0f : 4.0f);
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(gx, dx), __fmul_rn(gy, dy)),
                              __fmul_rn(gz, dz));
  attn = fmaxf(attn, 0.0f);
  const float a2 = __fmul_rn(attn, attn);
  return __fmul_rn(__fmul_rn(a2, a2), dot);
}

// Extra-vertex offsets, (0,0,0)-tetrahedron region
// (anoddpm_tpu/ops/simplex.py:118-159).
__device__ __forceinline__ void ext_region1(float xins, float yins, float zins,
                                            float in_sum, int e[6]) {
  int a_pt = 1, b_pt = 2;
  float a_sc = xins, b_sc = yins;
  const bool cond_b = (xins >= yins) && (zins > yins);
  if (cond_b) { b_pt = 4; b_sc = zins; }
  const bool cond_a = !cond_b && (xins < yins) && (zins > xins);
  if (cond_a) { a_pt = 4; a_sc = zins; }
  const float wins = 1.0f - in_sum;
  if ((wins > a_sc) || (wins > b_sc)) {
    const int c = (b_sc > a_sc) ? b_pt : a_pt;
    const bool cx = c & 1, cy = c & 2, cz = c & 4;
    e[0] = cx ? 1 : -1;
    e[3] = cx ? 1 : 0;
    e[1] = cy ? 1 : (cx ? -1 : 0);
    e[4] = cy ? 1 : (cx ? 0 : -1);
    e[2] = cz ? 1 : 0;
    e[5] = cz ? 1 : -1;
  } else {
    const int c = a_pt | b_pt;
    e[0] = (c & 1) ? 1 : 0; e[3] = (c & 1) ? 1 : -1;
    e[1] = (c & 2) ? 1 : 0; e[4] = (c & 2) ? 1 : -1;
    e[2] = (c & 4) ? 1 : 0; e[5] = (c & 4) ? 1 : -1;
  }
}

// Extra-vertex offsets, (1,1,1)-tetrahedron region
// (anoddpm_tpu/ops/simplex.py:162-202).
__device__ __forceinline__ void ext_region2(float xins, float yins, float zins,
                                            float in_sum, int e[6]) {
  int a_pt = 6, b_pt = 5;
  float a_sc = xins, b_sc = yins;
  const bool cond_b = (xins <= yins) && (zins < yins);
  if (cond_b) { b_pt = 3; b_sc = zins; }
  const bool cond_a = !cond_b && (xins > yins) && (zins < xins);
  if (cond_a) { a_pt = 3; a_sc = zins; }
  const float wins = 3.0f - in_sum;
  if ((wins < a_sc) || (wins < b_sc)) {
    const int c = (b_sc < a_sc) ? b_pt : a_pt;
    const bool cx = c & 1, cy = c & 2, cz = c & 4;
    e[0] = cx ? 2 : 0;
    e[3] = cx ? 1 : 0;
    e[1] = cy ? (cx ? 1 : 2) : 0;
    e[4] = cy ? (cx ? 2 : 1) : 0;
    e[2] = cz ? 1 : 0;
    e[5] = cz ? 2 : 0;
  } else {
    const int c = a_pt & b_pt;
    e[0] = (c & 1) ? 1 : 0; e[3] = (c & 1) ? 2 : 0;
    e[1] = (c & 2) ? 1 : 0; e[4] = (c & 2) ? 2 : 0;
    e[2] = (c & 4) ? 1 : 0; e[5] = (c & 4) ? 2 : 0;
  }
}

// Extra-vertex offsets, middle octahedron region
// (anoddpm_tpu/ops/simplex.py:205-271).
__device__ __forceinline__ void ext_region3(float xins, float yins, float zins,
                                            int e[6]) {
  const float p1 = xins + yins;
  bool a_fs = p1 > 1.0f;
  const float a_sc = a_fs ? p1 - 1.0f : 1.0f - p1;
  int a_pt = a_fs ? 3 : 4;
  const float p2 = xins + zins;
  bool b_fs = p2 > 1.0f;
  const float b_sc = b_fs ? p2 - 1.0f : 1.0f - p2;
  int b_pt = b_fs ? 5 : 2;
  const float p3 = yins + zins;
  const bool far = p3 > 1.0f;
  const float score = far ? p3 - 1.0f : 1.0f - p3;
  const bool repl_a = (a_sc <= b_sc) && (a_sc < score);
  const bool repl_b = !repl_a && (a_sc > b_sc) && (b_sc < score);
  if (repl_a) { a_pt = far ? 6 : 1; a_fs = far; }
  if (repl_b) { b_pt = far ? 6 : 1; b_fs = far; }
  if (a_fs == b_fs) {
    if (a_fs) {  // both on the (1,1,1) side
      const int c = a_pt & b_pt;
      e[0] = 1; e[1] = 1; e[2] = 1;
      e[3] = (c & 1) ? 2 : 0;
      e[4] = (!(c & 1) && (c & 2)) ? 2 : 0;
      e[5] = (!(c & 1) && !(c & 2)) ? 2 : 0;
    } else {  // both on the (0,0,0) side
      const int c = a_pt | b_pt;
      const bool miss_x = !(c & 1);
      const bool miss_y = !miss_x && !(c & 2);
      const bool miss_z = !miss_x && !miss_y;
      e[0] = 0; e[1] = 0; e[2] = 0;
      e[3] = miss_x ? -1 : 1;
      e[4] = miss_y ? -1 : 1;
      e[5] = miss_z ? -1 : 1;
    }
  } else {  // mixed sides
    const int c1 = a_fs ? a_pt : b_pt;
    const int c2 = a_fs ? b_pt : a_pt;
    const bool m1x = !(c1 & 1);
    const bool m1y = !m1x && !(c1 & 2);
    const bool m1z = !m1x && !m1y;
    e[0] = m1x ? -1 : 1;
    e[1] = m1y ? -1 : 1;
    e[2] = m1z ? -1 : 1;
    e[3] = (c2 & 1) ? 2 : 0;
    e[4] = (!(c2 & 1) && (c2 & 2)) ? 2 : 0;
    e[5] = (!(c2 & 1) && !(c2 & 2)) ? 2 : 0;
  }
}

__device__ float opensimplex3_hash(unsigned seed, float x, float y, float z) {
  const float stretch = __fmul_rn(__fadd_rn(__fadd_rn(x, y), z), STRETCH3);
  const float xs = __fadd_rn(x, stretch);
  const float ys = __fadd_rn(y, stretch);
  const float zs = __fadd_rn(z, stretch);
  const float xsb_f = floorf(xs), ysb_f = floorf(ys), zsb_f = floorf(zs);
  const int xsb = (int)xsb_f, ysb = (int)ysb_f, zsb = (int)zsb_f;
  const float xins = __fsub_rn(xs, xsb_f);
  const float yins = __fsub_rn(ys, ysb_f);
  const float zins = __fsub_rn(zs, zsb_f);
  const float in_sum = __fadd_rn(__fadd_rn(xins, yins), zins);
  const float squish =
      __fmul_rn(__fadd_rn(__fadd_rn(xsb_f, ysb_f), zsb_f), SQUISH3);
  const float dx0 = __fsub_rn(x, __fadd_rn(xsb_f, squish));
  const float dy0 = __fsub_rn(y, __fadd_rn(ysb_f, squish));
  const float dz0 = __fsub_rn(z, __fadd_rn(zsb_f, squish));

  const bool region1 = in_sum <= 1.0f;
  const bool region2 = in_sum >= 2.0f;
  const bool region3 = !region1 && !region2;

  float value = 0.0f;
  // The 8 cube corners in (ox, oy, oz) lexicographic order; a corner with
  // coordinate sum s is active in region 1 (s <= 1), region 2 (s >= 2) and
  // the middle octahedron (s in {1, 2}).
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ox = (k >> 2) & 1, oy = (k >> 1) & 1, oz = k & 1;
    const int s = ox + oy + oz;
    const bool active = (s == 0) ? region1
                        : (s == 1) ? (region1 || region3)
                        : (s == 2) ? (region2 || region3)
                                   : region2;
    if (active)
      value = __fadd_rn(
          value, contrib(seed, xsb, ysb, zsb, dx0, dy0, dz0, ox, oy, oz));
  }

  int e[6];
  if (region1)
    ext_region1(xins, yins, zins, in_sum, e);
  else if (region2)
    ext_region2(xins, yins, zins, in_sum, e);
  else
    ext_region3(xins, yins, zins, e);
  value = __fadd_rn(
      value, contrib(seed, xsb, ysb, zsb, dx0, dy0, dz0, e[0], e[1], e[2]));
  value = __fadd_rn(
      value, contrib(seed, xsb, ysb, zsb, dx0, dy0, dz0, e[3], e[4], e[5]));
  return __fdiv_rn(value, NORM3);
}

__global__ void octave_field_kernel(const int64_t* __restrict__ seeds,
                                    const float* __restrict__ ts,
                                    float* __restrict__ out, int h, int w,
                                    int octaves, float persistence,
                                    float frequency) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = blockIdx.z;
  if (px >= w || py >= h) return;
  const unsigned seed = (unsigned)(uint64_t)seeds[i];
  const float t = ts[i];
  const float xf = (float)px, yf = (float)py;
  float acc = 0.0f;
  float amp = 1.0f;
  float scale = __fdiv_rn(1.0f, frequency);
  for (int o = 0; o < octaves; ++o) {
    const float v = opensimplex3_hash(seed, __fmul_rn(xf, scale),
                                      __fmul_rn(yf, scale),
                                      __fmul_rn(t, scale));
    acc = __fadd_rn(acc, __fmul_rn(amp, v));
    amp = __fmul_rn(amp, persistence);
    scale = __fmul_rn(scale, 2.0f);
  }
  out[((size_t)i * h + py) * w + px] = acc;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// seeds: (n,) int64 holding uint32 values; ts: (n,) fp32; out: (n, h, w) fp32.
int simplex3_octave_field(const void* seeds, const void* ts, void* out, int n,
                          int h, int w, int octaves, float persistence,
                          float frequency, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8, n);
  octave_field_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int64_t*)seeds, (const float*)ts, (float*)out, h, w, octaves,
      persistence, frequency);
  return (int)cudaGetLastError();
}

}  // extern "C"
