// OpenSimplex 3D noise: native scalar oracle and batch evaluator (host C++).
//
// The port's own copy of the JAX package's csrc/simplex3.cpp: an
// independent C++ implementation of the algorithm that the port's table
// path (anoddpm_torch/ops/simplex.py) vectorises, built from the
// canonical-contribution formulation: every lattice vertex v with integer
// offsets (ox, oy, oz) relative to the super-cell origin contributes
//     attn^4 * (g . d),  d = d0 - offset - SQUISH3 * (ox+oy+oz)
// and the control flow only selects WHICH vertices contribute (the 8 cube
// corners gated by the region of in_sum, plus two "extra" vertices).
//
// It is the float64 oracle of the table-path field (anoddpm_torch/ops/native.py,
// built by g++ at first use), exposed through a plain C ABI for ctypes.

#include <cmath>
#include <cstdint>

namespace {

constexpr double STRETCH3 = -1.0 / 6.0;
constexpr double SQUISH3 = 1.0 / 3.0;
constexpr double NORM3 = 103.0;

// 24 gradient directions (public OpenSimplex constants), row-major (24, 3).
constexpr double GRAD3[24][3] = {
    {-11, 4, 4},  {-4, 11, 4},  {-4, 4, 11},  {11, 4, 4},   {4, 11, 4},
    {4, 4, 11},   {-11, -4, 4}, {-4, -11, 4}, {-4, -4, 11}, {11, -4, 4},
    {4, -11, 4},  {4, -4, 11},  {-11, 4, -4}, {-4, 11, -4}, {-4, 4, -11},
    {11, 4, -4},  {4, 11, -4},  {4, 4, -11},  {-11, -4, -4},{-4, -11, -4},
    {-4, -4, -11},{11, -4, -4}, {4, -11, -4}, {4, -4, -11},
};

struct Ctx {
  const int32_t* perm;     // permutation of 0..255
  const int32_t* grad_id;  // perm % 24
};

inline double extrapolate(const Ctx& c, int xsv, int ysv, int zsv, double dx,
                          double dy, double dz) {
  int i1 = c.perm[xsv & 0xFF];
  int i2 = c.perm[(i1 + ysv) & 0xFF];
  int gid = c.grad_id[(i2 + zsv) & 0xFF];
  const double* g = GRAD3[gid];
  return g[0] * dx + g[1] * dy + g[2] * dz;
}

struct Cell {
  int xsb, ysb, zsb;
  double dx0, dy0, dz0;
};

inline double contrib(const Ctx& c, const Cell& cell, int ox, int oy, int oz) {
  double sq = SQUISH3 * (ox + oy + oz);
  double dx = cell.dx0 - ox - sq;
  double dy = cell.dy0 - oy - sq;
  double dz = cell.dz0 - oz - sq;
  double attn = 2.0 - dx * dx - dy * dy - dz * dz;
  if (attn <= 0) return 0.0;
  double a2 = attn * attn;
  return a2 * a2 *
         extrapolate(c, cell.xsb + ox, cell.ysb + oy, cell.zsb + oz, dx, dy, dz);
}

// Extra-vertex offsets for the (0,0,0)-tetrahedron region.
inline void ext_region1(double xins, double yins, double zins, double in_sum,
                        int e[6]) {
  int a_pt = 1, b_pt = 2;
  double a_sc = xins, b_sc = yins;
  if (xins >= yins && zins > yins) { b_pt = 4; b_sc = zins; }
  else if (xins < yins && zins > xins) { a_pt = 4; a_sc = zins; }
  double wins = 1.0 - in_sum;
  if (wins > a_sc || wins > b_sc) {          // (0,0,0) among closest two
    int cpt = (b_sc > a_sc) ? b_pt : a_pt;   // single-bit point
    bool cx = cpt & 1, cy = cpt & 2, cz = cpt & 4;
    e[0] = cx ? 1 : -1;
    e[3] = cx ? 1 : 0;
    e[1] = cy ? 1 : (cx ? -1 : 0);
    e[4] = cy ? 1 : (cx ? 0 : -1);
    e[2] = cz ? 1 : 0;
    e[5] = cz ? 1 : -1;
  } else {
    int cpt = a_pt | b_pt;                   // two-bit point
    e[0] = (cpt & 1) ? 1 : 0;
    e[3] = (cpt & 1) ? 1 : -1;
    e[1] = (cpt & 2) ? 1 : 0;
    e[4] = (cpt & 2) ? 1 : -1;
    e[2] = (cpt & 4) ? 1 : 0;
    e[5] = (cpt & 4) ? 1 : -1;
  }
}

// Extra-vertex offsets for the (1,1,1)-tetrahedron region.
inline void ext_region2(double xins, double yins, double zins, double in_sum,
                        int e[6]) {
  int a_pt = 6, b_pt = 5;
  double a_sc = xins, b_sc = yins;
  if (xins <= yins && zins < yins) { b_pt = 3; b_sc = zins; }
  else if (xins > yins && zins < xins) { a_pt = 3; a_sc = zins; }
  double wins = 3.0 - in_sum;
  if (wins < a_sc || wins < b_sc) {          // (1,1,1) among closest two
    int cpt = (b_sc < a_sc) ? b_pt : a_pt;   // two-bit point
    bool cx = cpt & 1, cy = cpt & 2, cz = cpt & 4;
    e[0] = cx ? 2 : 0;
    e[3] = cx ? 1 : 0;
    e[1] = cy ? (cx ? 1 : 2) : 0;
    e[4] = cy ? (cx ? 2 : 1) : 0;
    e[2] = cz ? 1 : 0;
    e[5] = cz ? 2 : 0;
  } else {
    int cpt = a_pt & b_pt;                   // single-bit point
    e[0] = (cpt & 1) ? 1 : 0;
    e[3] = (cpt & 1) ? 2 : 0;
    e[1] = (cpt & 2) ? 1 : 0;
    e[4] = (cpt & 2) ? 2 : 0;
    e[2] = (cpt & 4) ? 1 : 0;
    e[5] = (cpt & 4) ? 2 : 0;
  }
}

// Extra-vertex offsets for the middle octahedron region.
inline void ext_region3(double xins, double yins, double zins, int e[6]) {
  double p1 = xins + yins;
  bool a_fs = p1 > 1.0;
  double a_sc = a_fs ? p1 - 1.0 : 1.0 - p1;
  int a_pt = a_fs ? 3 : 4;

  double p2 = xins + zins;
  bool b_fs = p2 > 1.0;
  double b_sc = b_fs ? p2 - 1.0 : 1.0 - p2;
  int b_pt = b_fs ? 5 : 2;

  double p3 = yins + zins;
  bool far = p3 > 1.0;
  double score = far ? p3 - 1.0 : 1.0 - p3;
  if (a_sc <= b_sc && a_sc < score) { a_pt = far ? 6 : 1; a_fs = far; }
  else if (a_sc > b_sc && b_sc < score) { b_pt = far ? 6 : 1; b_fs = far; }

  if (a_fs == b_fs) {
    if (a_fs) {                              // both on the (1,1,1) side
      int cpt = a_pt & b_pt;
      e[0] = e[1] = e[2] = 1;
      e[3] = (cpt & 1) ? 2 : 0;
      e[4] = (!(cpt & 1) && (cpt & 2)) ? 2 : 0;
      e[5] = (!(cpt & 1) && !(cpt & 2)) ? 2 : 0;
    } else {                                 // both on the (0,0,0) side
      int cpt = a_pt | b_pt;
      e[0] = e[1] = e[2] = 0;
      bool mx = !(cpt & 1);
      bool my = !mx && !(cpt & 2);
      bool mz = !mx && !my;
      e[3] = mx ? -1 : 1;
      e[4] = my ? -1 : 1;
      e[5] = mz ? -1 : 1;
    }
  } else {                                   // mixed sides
    int c1 = a_fs ? a_pt : b_pt;
    int c2 = a_fs ? b_pt : a_pt;
    bool mx = !(c1 & 1);
    bool my = !mx && !(c1 & 2);
    bool mz = !mx && !my;
    e[0] = mx ? -1 : 1;
    e[1] = my ? -1 : 1;
    e[2] = mz ? -1 : 1;
    e[3] = (c2 & 1) ? 2 : 0;
    e[4] = (!(c2 & 1) && (c2 & 2)) ? 2 : 0;
    e[5] = (!(c2 & 1) && !(c2 & 2)) ? 2 : 0;
  }
}

double noise3(const Ctx& c, double x, double y, double z) {
  double stretch = (x + y + z) * STRETCH3;
  double xs = x + stretch, ys = y + stretch, zs = z + stretch;
  double xsbf = std::floor(xs), ysbf = std::floor(ys), zsbf = std::floor(zs);
  Cell cell;
  cell.xsb = static_cast<int>(xsbf);
  cell.ysb = static_cast<int>(ysbf);
  cell.zsb = static_cast<int>(zsbf);
  double xins = xs - xsbf, yins = ys - ysbf, zins = zs - zsbf;
  double in_sum = xins + yins + zins;
  double squish = (xsbf + ysbf + zsbf) * SQUISH3;
  cell.dx0 = x - (xsbf + squish);
  cell.dy0 = y - (ysbf + squish);
  cell.dz0 = z - (zsbf + squish);

  double value = 0.0;
  int e[6];
  if (in_sum <= 1.0) {
    value += contrib(c, cell, 0, 0, 0);
    value += contrib(c, cell, 1, 0, 0);
    value += contrib(c, cell, 0, 1, 0);
    value += contrib(c, cell, 0, 0, 1);
    ext_region1(xins, yins, zins, in_sum, e);
  } else if (in_sum >= 2.0) {
    value += contrib(c, cell, 1, 1, 0);
    value += contrib(c, cell, 1, 0, 1);
    value += contrib(c, cell, 0, 1, 1);
    value += contrib(c, cell, 1, 1, 1);
    ext_region2(xins, yins, zins, in_sum, e);
  } else {
    value += contrib(c, cell, 1, 0, 0);
    value += contrib(c, cell, 0, 1, 0);
    value += contrib(c, cell, 0, 0, 1);
    value += contrib(c, cell, 1, 1, 0);
    value += contrib(c, cell, 1, 0, 1);
    value += contrib(c, cell, 0, 1, 1);
    ext_region3(xins, yins, zins, e);
  }
  value += contrib(c, cell, e[0], e[1], e[2]);
  value += contrib(c, cell, e[3], e[4], e[5]);
  return value / NORM3;
}

}  // namespace

extern "C" {

// LCG Fisher-Yates permutation init, bit-exact with the reference
// (reference: simplex.py:174-192, c_int64 overflow semantics).
void anoddpm_init_perm(int64_t seed, int32_t* perm, int32_t* grad_id) {
  int32_t source[256];
  for (int i = 0; i < 256; ++i) source[i] = i;
  for (int i = 0; i < 3; ++i)
    seed = seed * 6364136223846793005LL + 1442695040888963407LL;
  for (int i = 255; i >= 0; --i) {
    seed = seed * 6364136223846793005LL + 1442695040888963407LL;
    int64_t r = (seed + 31) % (i + 1);
    if (r < 0) r += i + 1;
    perm[i] = source[r];
    grad_id[i] = perm[i] % 24;
    source[r] = source[i];
  }
}

double anoddpm_noise3(double x, double y, double z, const int32_t* perm,
                      const int32_t* grad_id) {
  Ctx c{perm, grad_id};
  return noise3(c, x, y, z);
}

void anoddpm_noise3_batch(const double* xs, const double* ys, const double* zs,
                          int64_t n, const int32_t* perm,
                          const int32_t* grad_id, double* out) {
  Ctx c{perm, grad_id};
  for (int64_t i = 0; i < n; ++i) out[i] = noise3(c, xs[i], ys[i], zs[i]);
}

// Multi-octave field on a fixed z=t plane: out[h][w] accumulates
// persistence^o * noise3(w * 2^o / freq, h * 2^o / freq, t * 2^o / freq)
// (matches rand_3d_fixed_T_octaves, reference: simplex.py:75-93).
void anoddpm_fractal_fixed_t(int32_t h, int32_t w, double t, int32_t octaves,
                             double persistence, double frequency,
                             const int32_t* perm, const int32_t* grad_id,
                             double* out) {
  Ctx c{perm, grad_id};
  for (int64_t i = 0; i < static_cast<int64_t>(h) * w; ++i) out[i] = 0.0;
  double amplitude = 1.0;
  // divide by the halving frequency (not multiply by a reciprocal): keeps
  // float64 bit-parity with the reference octave mixer (simplex.py:88-92)
  for (int o = 0; o < octaves; ++o) {
    for (int yy = 0; yy < h; ++yy) {
      for (int xx = 0; xx < w; ++xx) {
        out[static_cast<int64_t>(yy) * w + xx] +=
            amplitude * noise3(c, xx / frequency, yy / frequency,
                               t / frequency);
      }
    }
    frequency /= 2.0;
    amplitude *= persistence;
  }
}

}  // extern "C"
