// Multi-octave 3-D OpenSimplex field on a fixed z = t plane, hash path.
//
// Replaces the TPU kernel `_field_kernel` of scripts/pallas_vs_xla_noise.py
// (launched by `fields_pallas`), whose production form in the JAX package is
// `anoddpm_tpu/ops/simplex.py:batched_fractal3_fixed_t` over `opensimplex3_hash`.
//
//   out[i, y, x] = sum_{o < octaves} persistence^o
//                  * noise3_hash(seed_i, x * 2^o / f, y * 2^o / f, t_i * 2^o / f)
//
// Bound: instruction issue.  The only memory traffic is the 4 n H W-byte
// store (and 12 bytes of seed and t per field); each pixel runs the cell
// walk, 6 or 8 lattice hashes and its region's logic once per octave, all in
// registers.
//
// Design, for the H100:
// - Each warp covers an 8 x 4 pixel tile, so that it spans a quarter of the
//   lattice in x that a row of 32 pixels spans.  The wrapper launches as
//   many blocks of 16 warps as the card holds at once (two per SM)
//   (ops/simplex.launch_plan), and the warps walk the tiles grid-stride,
//   so that every SM gets the same number of tiles to within one per warp
//   (launch shape below).
// - Per octave, the warp votes on the region of its pixels' lattice cells
//   (__ballot_sync).  When all lie in one region it runs only that region's
//   corners (4 in a tetrahedron, 6 in the octahedron), with offsets known at
//   compile time, and that region's extra-vertex logic.  A mixed warp
//   computes the six middle corners in every pixel and masks the ones a
//   pixel does not need (branch-free, so their work interleaves), one outer
//   corner per pixel, (0,0,0) or (1,1,1), and the tetrahedra's shared or the
//   octahedron's extra-vertex logic.  The vote pays in the coarse octaves,
//   where most warps hold one region, and costs a little in the fine ones;
//   over the main path's six octaves it measured 0.5-0.8% faster than every
//   warp on the mixed walk (PERF.md).  Lanes past a ragged edge compute
//   with their warp and only skip the store.
// - Per lattice vertex: the hash's coordinate products are formed once per
//   pixel and octave for offsets 0 and 1 (a unit offset adds the constant
//   mod 2^32), with the seed folded into z, so a corner combines three words
//   with one xor; the gradient comes from a table in shared memory, three
//   arrays of 24 floats, so every lane reads one word without bank conflicts.
// - Every float multiply, and every add that could meet one, is an __f*_rn
//   intrinsic, which the compiler never contracts into an FMA: above all the
//   skew, the x + stretch terms and the squish, so that floor() picks the
//   same lattice cell as the plain PyTorch version
//   (anoddpm_torch/ops/simplex.py), which rounds after every operation.
//   Contributions are summed in the plain version's order (active corners
//   in lexicographic order, then the two extra vertices) and divided by 103
//   exactly.  The octave scale is (1/f) * 2^o and the amplitude a running
//   product of the persistence, both as in the plain version.
// - Two entries share the body and the launch plan.  One takes (octaves,
//   persistence, frequency) as arguments.  The other reads them from three
//   floats on the card, for the "simplex_randParam" noise, whose triple is
//   drawn on the device (anoddpm_tpu/ops/noise.py:118-149, over
//   `fractal3_fixed_t_masked`); its octave count is at most MAX_OCTAVES,
//   the bound of the masked loop there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float STRETCH3 = (float)(-1.0 / 6.0);
constexpr float SQUISH3 = (float)(1.0 / 3.0);
constexpr float NORM3 = 103.0f;
constexpr unsigned HX = 0x8DA6B343u, HY = 0xD8163841u, HZ = 0xCB1AB31Fu;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Launch shape, chosen by measurement (PERF.md): a warp covers WARP_W x
// WARP_H pixels (ops/simplex.TILE_W, TILE_H), a block holds WARPS warps,
// and __launch_bounds__ asks for MIN_BLOCKS resident blocks per SM, which
// holds the kernel to 64 registers without spills.
constexpr int WARP_W = 8, WARP_H = 4;
constexpr int WARPS = 16, THREADS = 32 * WARPS, MIN_BLOCKS = 2;
constexpr int MAX_OCTAVES = 10;
static_assert(WARP_W * WARP_H == 32, "a warp tile holds 32 pixels");

// The 24 OpenSimplex gradients in shared memory, x then y then z
// components: id r has magnitude 11 on axis r % 3 and the signs of r / 3.
struct GradTable {
  float x[24], y[24], z[24];
};

// One pixel's lattice cell at one octave.
struct Cell {
  float dx[2], dy[2], dz[2];  // from the cell's origin vertex, minus 0 and 1
  unsigned hx[2], hy[2];      // (xsb + o) * HX, (ysb + o) * HY, o = 0, 1
  unsigned hz[2];             // ((zsb + o) * HZ) ^ seed
  unsigned hz0, seed;         // zsb * HZ, and the seed, for the extra vertices
  unsigned table;             // shared-memory address of the GradTable
};

// One float of shared memory at a 32-bit shared address (keeps the table's
// address in a register instead of rebuilding it at every load).
__device__ __forceinline__ float load_shared(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Radial-falloff contribution of a vertex at (dx, dy, dz) whose coordinate
// products and seed xor to h.
__device__ __forceinline__ float falloff_dot(const Cell& c, unsigned h,
                                             float dx, float dy, float dz) {
  float attn = __fsub_rn(__fsub_rn(__fsub_rn(2.0f, __fmul_rn(dx, dx)),
                                   __fmul_rn(dy, dy)),
                         __fmul_rn(dz, dz));
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  const unsigned addr = c.table + (h % 24u) * 4u;
  const float gx = load_shared(addr);
  const float gy = load_shared(addr + 24 * 4);
  const float gz = load_shared(addr + 48 * 4);
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(gx, dx), __fmul_rn(gy, dy)),
                              __fmul_rn(gz, dz));
  attn = fmaxf(attn, 0.0f);
  const float a2 = __fmul_rn(attn, attn);
  return __fmul_rn(__fmul_rn(a2, a2), dot);
}

// Cube corner (OX, OY, OZ) of the cell.
template <int OX, int OY, int OZ>
__device__ __forceinline__ float corner(const Cell& c) {
  const float sq = __fmul_rn(SQUISH3, (float)(OX + OY + OZ));
  return falloff_dot(c, c.hx[OX] ^ c.hy[OY] ^ c.hz[OZ],
                     __fsub_rn(c.dx[OX], sq), __fsub_rn(c.dy[OY], sq),
                     __fsub_rn(c.dz[OZ], sq));
}

// Extra vertex at runtime offsets (ox, oy, oz) from the cell's origin.
__device__ __forceinline__ float extra(const Cell& c, int ox, int oy, int oz) {
  const float sq = __fmul_rn(SQUISH3, (float)(ox + oy + oz));
  const unsigned h = (c.hx[0] + (unsigned)ox * HX) ^
                     (c.hy[0] + (unsigned)oy * HY) ^
                     (c.hz0 + (unsigned)oz * HZ) ^ c.seed;
  return falloff_dot(c, h, __fsub_rn(__fsub_rn(c.dx[0], (float)ox), sq),
                     __fsub_rn(__fsub_rn(c.dy[0], (float)oy), sq),
                     __fsub_rn(__fsub_rn(c.dz[0], (float)oz), sq));
}

// Extra-vertex offsets in a tetrahedron: the (0,0,0) one
// (anoddpm_tpu/ops/simplex.py:118-159) or, when `high`, the (1,1,1) one
// (:162-202).  The second is the first with the in-cell coordinates and the
// score negated, which is exact and turns each of its comparisons into the
// first's, and with the points and offsets mirrored (p -> 7 - p, e -> 1 - e).
__device__ __forceinline__ void ext_tetra(bool high, float xins, float yins,
                                          float zins, float in_sum, int e[6]) {
  const float x = high ? -xins : xins;
  const float y = high ? -yins : yins;
  const float z = high ? -zins : zins;
  const float wins = high ? -(3.0f - in_sum) : 1.0f - in_sum;
  int a_pt = 1, b_pt = 2;
  float a_sc = x, b_sc = y;
  const bool cond_b = (x >= y) && (z > y);
  if (cond_b) { b_pt = 4; b_sc = z; }
  const bool cond_a = !cond_b && (x < y) && (z > x);
  if (cond_a) { a_pt = 4; a_sc = z; }
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
  if (high)
    for (int k = 0; k < 6; ++k) e[k] = 1 - e[k];
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

__device__ __forceinline__ float add_extras(const Cell& c, float value,
                                            const int e[6]) {
  value = __fadd_rn(value, extra(c, e[0], e[1], e[2]));
  return __fadd_rn(value, extra(c, e[3], e[4], e[5]));
}

// The walks of a warp whose pixels all lie in region 1 (in_sum <= 1), all in
// region 2 (in_sum >= 2), all in the octahedron, or in more than one region.
// A corner with coordinate sum s belongs to region 1 when s <= 1, to
// region 2 when s >= 2 and to the octahedron when s is 1 or 2.
__device__ __forceinline__ float walk_region1(const Cell& c, float xins,
                                              float yins, float zins,
                                              float in_sum) {
  float v = corner<0, 0, 0>(c);
  v = __fadd_rn(v, corner<0, 0, 1>(c));
  v = __fadd_rn(v, corner<0, 1, 0>(c));
  v = __fadd_rn(v, corner<1, 0, 0>(c));
  int e[6];
  ext_tetra(false, xins, yins, zins, in_sum, e);
  return add_extras(c, v, e);
}

__device__ __forceinline__ float walk_region2(const Cell& c, float xins,
                                              float yins, float zins,
                                              float in_sum) {
  float v = corner<0, 1, 1>(c);
  v = __fadd_rn(v, corner<1, 0, 1>(c));
  v = __fadd_rn(v, corner<1, 1, 0>(c));
  v = __fadd_rn(v, corner<1, 1, 1>(c));
  int e[6];
  ext_tetra(true, xins, yins, zins, in_sum, e);
  return add_extras(c, v, e);
}

__device__ __forceinline__ float walk_octahedron(const Cell& c, float xins,
                                                 float yins, float zins) {
  float v = corner<0, 0, 1>(c);
  v = __fadd_rn(v, corner<0, 1, 0>(c));
  v = __fadd_rn(v, corner<0, 1, 1>(c));
  v = __fadd_rn(v, corner<1, 0, 0>(c));
  v = __fadd_rn(v, corner<1, 0, 1>(c));
  v = __fadd_rn(v, corner<1, 1, 0>(c));
  int e[6];
  ext_region3(xins, yins, zins, e);
  return add_extras(c, v, e);
}

// Corner (0,0,0), or (1,1,1) when `far`.
__device__ __forceinline__ float pole(const Cell& c, bool far) {
  const float sq = far ? __fmul_rn(SQUISH3, 3.0f) : 0.0f;
  const unsigned h = far ? c.hx[1] ^ c.hy[1] ^ c.hz[1]
                         : c.hx[0] ^ c.hy[0] ^ c.hz[0];
  return falloff_dot(c, h, __fsub_rn(far ? c.dx[1] : c.dx[0], sq),
                     __fsub_rn(far ? c.dy[1] : c.dy[0], sq),
                     __fsub_rn(far ? c.dz[1] : c.dz[0], sq));
}

// In a mixed warp every pixel computes the six corners of sum 1 and 2, which
// some pixel of the warp needs, and adds those of its own region, and one
// pole: corner (0,0,0), which region 1 adds first, or (1,1,1), which
// region 2 adds last.  A corner a pixel does not need is masked to +0 with
// its bits, not skipped by a branch, so that the compiler interleaves the
// corners' work; adding +0 leaves the sum as the plain version's, which
// adds that corner's zero (the sum is never -0).
__device__ __forceinline__ float walk_mixed(const Cell& c, float xins,
                                            float yins, float zins,
                                            float in_sum) {
  const bool r1 = in_sum <= 1.0f, r2 = in_sum >= 2.0f;
  const unsigned m1 = r1 ? FULL : 0u, m2 = r2 ? FULL : 0u;
  const unsigned low = ~m2, high = ~m1;  // the corners of sum 1, of sum 2
  const auto masked = [](float k, unsigned m) {
    return __uint_as_float(__float_as_uint(k) & m);
  };
  const float outer = pole(c, r2);
  float v = __fadd_rn(0.0f, masked(outer, m1));
  v = __fadd_rn(v, masked(corner<0, 0, 1>(c), low));
  v = __fadd_rn(v, masked(corner<0, 1, 0>(c), low));
  v = __fadd_rn(v, masked(corner<0, 1, 1>(c), high));
  v = __fadd_rn(v, masked(corner<1, 0, 0>(c), low));
  v = __fadd_rn(v, masked(corner<1, 0, 1>(c), high));
  v = __fadd_rn(v, masked(corner<1, 1, 0>(c), high));
  v = __fadd_rn(v, masked(outer, m2));
  int e[6];
  if (r1 || r2)
    ext_tetra(r2, xins, yins, zins, in_sum, e);
  else
    ext_region3(xins, yins, zins, e);
  return add_extras(c, v, e);
}

// One octave of noise at (x, y, z); every lane of the warp calls it.
__device__ __forceinline__ float opensimplex3_hash(unsigned table,
                                                   unsigned seed, float x,
                                                   float y, float z) {
  const float stretch = __fmul_rn(__fadd_rn(__fadd_rn(x, y), z), STRETCH3);
  const float xs = __fadd_rn(x, stretch);
  const float ys = __fadd_rn(y, stretch);
  const float zs = __fadd_rn(z, stretch);
  const float xsb_f = floorf(xs), ysb_f = floorf(ys), zsb_f = floorf(zs);
  const unsigned xsb = (unsigned)(int)xsb_f, ysb = (unsigned)(int)ysb_f,
                 zsb = (unsigned)(int)zsb_f;
  const float xins = __fsub_rn(xs, xsb_f);
  const float yins = __fsub_rn(ys, ysb_f);
  const float zins = __fsub_rn(zs, zsb_f);
  const float in_sum = __fadd_rn(__fadd_rn(xins, yins), zins);
  const float squish =
      __fmul_rn(__fadd_rn(__fadd_rn(xsb_f, ysb_f), zsb_f), SQUISH3);
  Cell c;
  c.dx[0] = __fsub_rn(x, __fadd_rn(xsb_f, squish));
  c.dy[0] = __fsub_rn(y, __fadd_rn(ysb_f, squish));
  c.dz[0] = __fsub_rn(z, __fadd_rn(zsb_f, squish));
  c.dx[1] = __fsub_rn(c.dx[0], 1.0f);
  c.dy[1] = __fsub_rn(c.dy[0], 1.0f);
  c.dz[1] = __fsub_rn(c.dz[0], 1.0f);
  c.hx[0] = xsb * HX;
  c.hx[1] = c.hx[0] + HX;
  c.hy[0] = ysb * HY;
  c.hy[1] = c.hy[0] + HY;
  c.hz0 = zsb * HZ;
  c.hz[0] = c.hz0 ^ seed;
  c.hz[1] = (c.hz0 + HZ) ^ seed;
  c.seed = seed;
  c.table = table;

  const unsigned in1 = __ballot_sync(FULL, in_sum <= 1.0f);
  const unsigned in2 = __ballot_sync(FULL, in_sum >= 2.0f);
  float value;
  if (in1 == FULL)
    value = walk_region1(c, xins, yins, zins, in_sum);
  else if (in2 == FULL)
    value = walk_region2(c, xins, yins, zins, in_sum);
  else if ((in1 | in2) == 0u)
    value = walk_octahedron(c, xins, yins, zins);
  else
    value = walk_mixed(c, xins, yins, zins, in_sum);
  return __fdiv_rn(value, NORM3);
}

// FROM_DEVICE: (octaves, persistence, frequency) are params[0..2] on the
// card instead of the arguments.
template <bool FROM_DEVICE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    octave_field_kernel(const int64_t* __restrict__ seeds,
                        const float* __restrict__ ts, float* __restrict__ out,
                        int n, int h, int w, int octaves, float persistence,
                        float frequency, const float* __restrict__ params) {
  if (FROM_DEVICE) {
    octaves = min((int)params[0], MAX_OCTAVES);
    persistence = params[1];
    frequency = params[2];
  }
  __shared__ GradTable g;
  if (threadIdx.x < 24) {
    const unsigned r = threadIdx.x, m = r % 3u, q = r / 3u;
    g.x[r] = ((q & 1u) ? 1.0f : -1.0f) * (m == 0u ? 11.0f : 4.0f);
    g.y[r] = ((q & 2u) ? -1.0f : 1.0f) * (m == 1u ? 11.0f : 4.0f);
    g.z[r] = ((q & 4u) ? -1.0f : 1.0f) * (m == 2u ? 11.0f : 4.0f);
  }
  __syncthreads();
  const unsigned table = (unsigned)__cvta_generic_to_shared(&g);
  // Warp k of block b is warp k * gridDim.x + b of the grid, so that the
  // warps that take one tile more than others are spread over the SMs.
  const int lane = threadIdx.x & 31;
  const int warps = WARPS * gridDim.x;
  const int first = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int tiles_x = (w + WARP_W - 1) / WARP_W;
  const int per_field = tiles_x * ((h + WARP_H - 1) / WARP_H);
  const int tiles = n * per_field;
  const float scale0 = __fdiv_rn(1.0f, frequency);
  for (int tile = first; tile < tiles; tile += warps) {
    const int i = tile / per_field, rest = tile - i * per_field;
    const int ty = rest / tiles_x, tx = rest - ty * tiles_x;
    const int px = tx * WARP_W + lane % WARP_W;
    const int py = ty * WARP_H + lane / WARP_W;
    const unsigned seed = (unsigned)(uint64_t)seeds[i];
    const float t = ts[i];
    const float xf = (float)px, yf = (float)py;
    float acc = 0.0f, amp = 1.0f, scale = scale0;
    for (int o = 0; o < octaves; ++o) {
      const float v = opensimplex3_hash(table, seed, __fmul_rn(xf, scale),
                                        __fmul_rn(yf, scale),
                                        __fmul_rn(t, scale));
      acc = __fadd_rn(acc, __fmul_rn(amp, v));
      amp = __fmul_rn(amp, persistence);
      scale = __fmul_rn(scale, 2.0f);
    }
    if (px < w && py < h) out[((size_t)i * h + py) * w + px] = acc;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The kernel as built for the current device, into out[0..4]: registers per
// thread, local (spill) bytes per thread, static shared bytes per block,
// threads per block, and blocks resident per SM at once.  Both instances are
// queried (the static entry's and the parameters-from-device entry's): one
// launch plan serves both, so each figure is the worse of the two.
int simplex3_octave_field_attributes(int* out) {
  out[0] = out[1] = out[2] = 0;
  out[3] = THREADS;
  out[4] = 1 << 30;
  const void* kernels[2] = {(const void*)octave_field_kernel<false>,
                            (const void*)octave_field_kernel<true>};
  for (const void* kernel : kernels) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs > out[0]) out[0] = attr.numRegs;
    if ((int)attr.localSizeBytes > out[1]) out[1] = (int)attr.localSizeBytes;
    if ((int)attr.sharedSizeBytes > out[2]) out[2] = (int)attr.sharedSizeBytes;
    if (blocks < out[4]) out[4] = blocks;
  }
  return 0;
}

// seeds: (n,) int64 holding uint32 values; ts: (n,) fp32; out: (n, h, w) fp32.
// blocks: the grid, at least 1; its warps walk the warp tiles grid-stride.
int simplex3_octave_field(const void* seeds, const void* ts, void* out, int n,
                          int h, int w, int octaves, float persistence,
                          float frequency, int blocks, void* stream) {
  octave_field_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)seeds, (const float*)ts, (float*)out, n, h, w, octaves,
      persistence, frequency, nullptr);
  return (int)cudaGetLastError();
}

// The same with (octaves, persistence, frequency) read on the card from
// params: (3,) fp32, the octave count a whole number, at most MAX_OCTAVES.
int simplex3_octave_field_device_params(const void* seeds, const void* ts,
                                        const void* params, void* out, int n,
                                        int h, int w, int blocks,
                                        void* stream) {
  octave_field_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)seeds, (const float*)ts, (float*)out, n, h, w, 0, 0.0f,
      1.0f, (const float*)params);
  return (int)cudaGetLastError();
}

}  // extern "C"
