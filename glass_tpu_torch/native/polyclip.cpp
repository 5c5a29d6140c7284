// Native polygon geometry for the evaluation harness.
//
// The reference evaluates with GEOS-backed Polygon3/shapely (C libraries);
// this is the framework's own native equivalent: exact intersection areas
// for arbitrary *simple* polygons via signed fan-triangulation — each
// polygon is decomposed into signed triangles fanned from its first vertex,
// and area(P ∩ Q) = Σ_ij sign_i·sign_j·area(T_i ∩ T_j), with each
// triangle-triangle intersection an exact Sutherland–Hodgman clip.  Works
// for concave polygons (curved-text masks) without rasterization.
//
// Exposed via a C ABI for ctypes (no PyTorch or pybind11 headers).  A copy
// of glass_tpu/native/polyclip.cpp: the port keeps its own sources.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Shoelace signed area (positive for counter-clockwise in math coords).
double signed_area(const Pt* pts, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& a = pts[i];
    const Pt& b = pts[(i + 1) % n];
    s += a.x * b.y - b.x * a.y;
  }
  return 0.5 * s;
}

// Clip convex polygon `subject` (n verts) by the half-plane left of a->b.
// Writes into `out`, returns new count.  Buffers must hold n+1 points.
int clip_halfplane(const Pt* subject, int n, const Pt& a, const Pt& b,
                   Pt* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& cur = subject[i];
    const Pt& prev = subject[(i + n - 1) % n];
    double s_cur = cross(a, b, cur);
    double s_prev = cross(a, b, prev);
    bool cur_in = s_cur >= 0.0;
    bool prev_in = s_prev >= 0.0;
    if (cur_in != prev_in) {
      double denom = s_prev - s_cur;
      double t = std::fabs(denom) > 1e-14 ? s_prev / denom : 0.0;
      out[m++] = {prev.x + t * (cur.x - prev.x), prev.y + t * (cur.y - prev.y)};
    }
    if (cur_in) out[m++] = cur;
  }
  return m;
}

// Intersection area of two triangles (CCW orientation each).
double tri_tri_area(const Pt* t1, const Pt* t2) {
  Pt buf1[8], buf2[8];
  std::memcpy(buf1, t1, 3 * sizeof(Pt));
  int n = 3;
  Pt* cur = buf1;
  Pt* nxt = buf2;
  for (int e = 0; e < 3 && n >= 3; ++e) {
    n = clip_halfplane(cur, n, t2[e], t2[(e + 1) % 3], nxt);
    std::swap(cur, nxt);
  }
  if (n < 3) return 0.0;
  return std::fabs(signed_area(cur, n));
}

// Exact intersection area of two simple polygons via signed triangulation.
double polygon_intersection_area(const Pt* p, int np, const Pt* q, int nq) {
  double total = 0.0;
  for (int i = 1; i + 1 < np; ++i) {
    Pt tp[3] = {p[0], p[i], p[i + 1]};
    double sp = signed_area(tp, 3);
    if (std::fabs(sp) < 1e-14) continue;
    // Orient CCW for the clipper; remember the sign.
    double sign_p = sp > 0 ? 1.0 : -1.0;
    if (sign_p < 0) std::swap(tp[1], tp[2]);
    for (int j = 1; j + 1 < nq; ++j) {
      Pt tq[3] = {q[0], q[j], q[j + 1]};
      double sq = signed_area(tq, 3);
      if (std::fabs(sq) < 1e-14) continue;
      double sign_q = sq > 0 ? 1.0 : -1.0;
      if (sign_q < 0) std::swap(tq[1], tq[2]);
      total += sign_p * sign_q * tri_tri_area(tp, tq);
    }
  }
  return std::fabs(total);
}

double polygon_area_abs(const Pt* p, int n) {
  return std::fabs(signed_area(p, n));
}

}  // namespace

extern "C" {

// Single pair: points as [x0,y0,x1,y1,...].
double polyclip_intersection_area(const double* p, int np, const double* q,
                                  int nq) {
  return polygon_intersection_area(reinterpret_cast<const Pt*>(p), np,
                                   reinterpret_cast<const Pt*>(q), nq);
}

double polyclip_area(const double* p, int n) {
  return polygon_area_abs(reinterpret_cast<const Pt*>(p), n);
}

// Batched pairwise IoU between two ragged polygon sets.
//   flat coordinate buffers + per-polygon offsets (offsets[i]..offsets[i+1]
//   index vertex slots).  Output is row-major (n_p, n_q).
void polyclip_pairwise_iou(const double* p_coords, const int32_t* p_offsets,
                           int32_t n_p, const double* q_coords,
                           const int32_t* q_offsets, int32_t n_q,
                           double* out_iou) {
  std::vector<double> p_areas(n_p), q_areas(n_q);
  for (int i = 0; i < n_p; ++i) {
    const Pt* pts = reinterpret_cast<const Pt*>(p_coords) + p_offsets[i];
    p_areas[i] = polygon_area_abs(pts, p_offsets[i + 1] - p_offsets[i]);
  }
  for (int j = 0; j < n_q; ++j) {
    const Pt* pts = reinterpret_cast<const Pt*>(q_coords) + q_offsets[j];
    q_areas[j] = polygon_area_abs(pts, q_offsets[j + 1] - q_offsets[j]);
  }
  for (int i = 0; i < n_p; ++i) {
    const Pt* pp = reinterpret_cast<const Pt*>(p_coords) + p_offsets[i];
    int np = p_offsets[i + 1] - p_offsets[i];
    for (int j = 0; j < n_q; ++j) {
      const Pt* qq = reinterpret_cast<const Pt*>(q_coords) + q_offsets[j];
      int nq = q_offsets[j + 1] - q_offsets[j];
      double inter = polygon_intersection_area(pp, np, qq, nq);
      double uni = p_areas[i] + q_areas[j] - inter;
      out_iou[i * n_q + j] = uni > 1e-12 ? inter / uni : 0.0;
    }
  }
}

// Batched "intersection over first-polygon area" (for don't-care coverage).
void polyclip_pairwise_ioa_first(const double* p_coords,
                                 const int32_t* p_offsets, int32_t n_p,
                                 const double* q_coords,
                                 const int32_t* q_offsets, int32_t n_q,
                                 double* out) {
  for (int i = 0; i < n_p; ++i) {
    const Pt* pp = reinterpret_cast<const Pt*>(p_coords) + p_offsets[i];
    int np = p_offsets[i + 1] - p_offsets[i];
    double ap = polygon_area_abs(pp, np);
    for (int j = 0; j < n_q; ++j) {
      const Pt* qq = reinterpret_cast<const Pt*>(q_coords) + q_offsets[j];
      int nq = q_offsets[j + 1] - q_offsets[j];
      double inter = polygon_intersection_area(pp, np, qq, nq);
      out[i * n_q + j] = ap > 1e-12 ? inter / ap : 0.0;
    }
  }
}
}
