// Independent CPU re-derivation of the reference's per-ray march semantics
// (the PyTorch port's copy of gaussian_ray_tracing_tpu/native/refmarch.cpp;
// the port's oracle, models/oracle.py, is held against it the same way).
//
// Purpose (round-1 verdict item: "validation against an actual reference
// render"): the JAX oracle (models/oracle.py) is a transcription of the
// reference CUDA semantics (shaders/tracer.cuh:328-373, tracer.cu:124-153,
// src/GaussianTracer.cpp:297-317); without GPU hardware the reference
// binary cannot be run, so this file re-derives the SAME math from the
// equations, in a different language, with a SEQUENTIAL per-ray loop
// (sort-all-hits = the exact limit of the k-buffer re-traversal) instead
// of the oracle's vectorized cumulative-product reformulation. Agreement
// between two independently-written implementations pins the transcription.
//
// Semantics re-derived here (no code copied; equations only):
//   - canonical frame     M = diag(1/s) R^T, R from a wxyz quaternion
//                         (glm::mat3_cast convention, GaussianData.cpp:104)
//   - adaptive iso radius r = sqrt(2 ln(opacity / alpha_min))
//                         (GaussianTracer.cpp:306)
//   - hit event           entry root of |o_g + t d_g| = r, exit when the
//                         entry precedes the segment start (the face OptiX
//                         would report within [t_lo, t_hi])
//   - peak response       exp(-1/2 |o_g + t* d_g|^2), t* = -<o_g,d_g>/|d_g|^2
//                         (tracer.cuh:187-214)
//   - SH radiance         max(0, 0.5 + sum C_i B_i(d) sh_i), degrees 0..3
//                         (tracer.cuh:216-264, constants Parameters.h:10-23)
//   - composite           front-to-back in exact per-ray t order with the
//                         alpha_min gate and minTransmittance early stop
//                         (tracer.cuh:341-369); hit_multiplicity m composites
//                         the same hit m times, re-checking T between passes
//                         exactly as the reference's double hull hit does.
//
// Build: bindings.py compiles it with g++ at first use into build/native/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// SH band constants (Parameters.h:10-23 values; standard real SH)
constexpr double C0 = 0.28209479177387814;
constexpr double C1 = 0.4886025119029199;
constexpr double C2[5] = {1.0925484305920792, -1.0925484305920792,
                          0.31539156525252005, -1.0925484305920792,
                          0.5462742152960396};
constexpr double C3[7] = {-0.5900435899266435, 2.890611442640554,
                          -0.4570457994644658, 0.3731763325901154,
                          -0.4570457994644658, 1.445305721320277,
                          -0.5900435899266435};

struct Hit {
  float t;
  int32_t id;
  bool operator<(const Hit& o) const { return t < o.t; }
};

}  // namespace

extern "C" int32_t grt_ref_render(
    const float* means,      // (n, 3)
    const float* scales,     // (n, 3) activated
    const float* quats,      // (n, 4) wxyz, unnormalized ok
    const float* opacities,  // (n,)
    const float* sh,         // (n, K, 3) DC first
    int64_t n, int32_t K,
    const float* origins,    // (r, 3)
    const float* dirs,       // (r, 3) normalized; |d| <= 0.1 => dead ray
    int64_t r,
    const float* t_lo,       // (r,)
    const float* t_hi,       // (r,)
    float alpha_min, float alpha_clamp, float min_trans,
    int32_t hit_mult, int32_t sh_degree,
    float* out_rgb,          // (r, 3)
    float* out_alpha         // (r,)
) {
  if (n < 0 || r < 0 || K < (sh_degree + 1) * (sh_degree + 1)) return 1;

  // Precompute per-gaussian canonical frames and adaptive radii.
  std::vector<double> M(n * 9);
  std::vector<double> rad(n);
  for (int64_t g = 0; g < n; ++g) {
    double w = quats[g * 4 + 0], x = quats[g * 4 + 1];
    double y = quats[g * 4 + 2], z = quats[g * 4 + 3];
    double qn = std::sqrt(w * w + x * x + y * y + z * z);
    if (qn < 1e-12) qn = 1e-12;
    w /= qn; x /= qn; y /= qn; z /= qn;
    // glm::mat3_cast rotation (column-vector convention)
    double R[9] = {
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)};
    // M = diag(1/s) R^T: M[i][j] = R[j][i] / s_i
    for (int i = 0; i < 3; ++i) {
      double inv_s = 1.0 / (double)scales[g * 3 + i];
      for (int j = 0; j < 3; ++j) M[g * 9 + i * 3 + j] = R[j * 3 + i] * inv_s;
    }
    double ratio = (double)opacities[g] / (double)alpha_min;
    rad[g] = ratio > 1.0 ? std::sqrt(2.0 * std::log(ratio)) : 0.0;
  }

  std::vector<Hit> hits;
  std::vector<float> alphas(n);
  hits.reserve(1024);

  for (int64_t ri = 0; ri < r; ++ri) {
    const V3 o = {origins[ri * 3], origins[ri * 3 + 1], origins[ri * 3 + 2]};
    const V3 d = {dirs[ri * 3], dirs[ri * 3 + 1], dirs[ri * 3 + 2]};
    out_rgb[ri * 3] = out_rgb[ri * 3 + 1] = out_rgb[ri * 3 + 2] = 0.f;
    out_alpha[ri] = 0.f;
    if (dot(d, d) <= 0.01) continue;  // |dir| > 0.1 guard (tracer.cu:59)
    const double lo = t_lo[ri], hi = t_hi[ri];

    hits.clear();
    for (int64_t g = 0; g < n; ++g) {
      if (rad[g] <= 0.0) continue;
      const double* m = &M[g * 9];
      V3 rel = sub(o, {means[g * 3], means[g * 3 + 1], means[g * 3 + 2]});
      V3 og = {m[0] * rel.x + m[1] * rel.y + m[2] * rel.z,
               m[3] * rel.x + m[4] * rel.y + m[5] * rel.z,
               m[6] * rel.x + m[7] * rel.y + m[8] * rel.z};
      V3 dg = {m[0] * d.x + m[1] * d.y + m[2] * d.z,
               m[3] * d.x + m[4] * d.y + m[5] * d.z,
               m[6] * d.x + m[7] * d.y + m[8] * d.z};
      double a = dot(dg, dg);
      if (a < 1e-12) a = 1e-12;
      double b = dot(og, dg);  // half-b
      double c = dot(og, og) - rad[g] * rad[g];
      double disc = b * b - a * c;
      if (disc < 0.0) continue;
      double sq = std::sqrt(disc);
      double t_entry = (-b - sq) / a;
      double t_exit = (-b + sq) / a;
      double t_event = t_entry < lo ? t_exit : t_entry;
      if (t_event < lo || t_event > hi) continue;
      // peak response along the FULL ray (segment-independent)
      double dd = dot(dg, dg);
      double t_star = -b / (dd < 1e-6 ? 1e-6 : dd);
      double px = og.x + t_star * dg.x, py = og.y + t_star * dg.y,
             pz = og.z + t_star * dg.z;
      double resp = std::exp(-0.5 * (px * px + py * py + pz * pz));
      double alpha = resp * (double)opacities[g];
      if (alpha > alpha_clamp) alpha = alpha_clamp;
      if (alpha <= alpha_min) continue;
      alphas[g] = (float)alpha;
      hits.push_back({(float)t_event, (int32_t)g});
    }
    std::sort(hits.begin(), hits.end());

    // sequential front-to-back composite (tracer.cuh:341-369)
    double T = 1.0, cr = 0.0, cg = 0.0, cb = 0.0;
    for (const Hit& h : hits) {
      if (T <= (double)min_trans) break;
      const int64_t g = h.id;
      // SH radiance at this ray's direction
      const float* s = &sh[(int64_t)g * K * 3];
      double col[3];
      for (int ch = 0; ch < 3; ++ch) col[ch] = 0.5 + C0 * s[0 * 3 + ch];
      if (sh_degree >= 1) {
        double xx = d.x, yy = d.y, zz = d.z;
        for (int ch = 0; ch < 3; ++ch)
          col[ch] += C1 * (-yy * s[1 * 3 + ch] + zz * s[2 * 3 + ch] -
                           xx * s[3 * 3 + ch]);
      }
      if (sh_degree >= 2) {
        double xx = d.x * d.x, yy = d.y * d.y, zz = d.z * d.z;
        double xy = d.x * d.y, xz = d.x * d.z, yz = d.y * d.z;
        for (int ch = 0; ch < 3; ++ch)
          col[ch] += C2[0] * xy * s[4 * 3 + ch] + C2[1] * yz * s[5 * 3 + ch] +
                     C2[2] * (2 * zz - xx - yy) * s[6 * 3 + ch] +
                     C2[3] * xz * s[7 * 3 + ch] +
                     C2[4] * (xx - yy) * s[8 * 3 + ch];
        if (sh_degree >= 3) {
          for (int ch = 0; ch < 3; ++ch)
            col[ch] += C3[0] * d.y * (3 * xx - yy) * s[9 * 3 + ch] +
                       C3[1] * xy * d.z * s[10 * 3 + ch] +
                       C3[2] * d.y * (4 * zz - xx - yy) * s[11 * 3 + ch] +
                       C3[3] * d.z * (2 * zz - 3 * xx - 3 * yy) * s[12 * 3 + ch] +
                       C3[4] * d.x * (4 * zz - xx - yy) * s[13 * 3 + ch] +
                       C3[5] * d.z * (xx - yy) * s[14 * 3 + ch] +
                       C3[6] * d.x * (xx - 3 * yy) * s[15 * 3 + ch];
        }
      }
      for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] > 0.0 ? col[ch] : 0.0;
      // hit_multiplicity m: m sequential passes of the SAME hit, re-checking
      // T between passes — the icosahedron hull's double anyhit, verbatim
      // semantics (not the closed-form 1-(1-a)^m the fast paths use)
      double a = (double)alphas[h.id];
      for (int p = 0; p < hit_mult && T > (double)min_trans; ++p) {
        cr += T * col[0] * a;
        cg += T * col[1] * a;
        cb += T * col[2] * a;
        T *= (1.0 - a);
      }
    }
    out_rgb[ri * 3 + 0] = (float)cr;
    out_rgb[ri * 3 + 1] = (float)cg;
    out_rgb[ri * 3 + 2] = (float)cb;
    out_alpha[ri] = (float)(1.0 - T);
  }
  return 0;
}
