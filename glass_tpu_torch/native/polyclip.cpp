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
//
// polyclip_pairwise_iou_quads, at the end, serves the post-processor's
// rotated IoU instead: the convex-quad clip of postprocess/np_geometry.py,
// pass for pass and bit for bit (built without FMA contraction).

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

// Intersection area of convex quads p and q, as np_geometry.py's
// _quad_intersection_areas_batch computes one pair: q's 4 half-planes clip
// p in turn, each pass keeping [intersection, current] for every vertex in
// order, |denom| > 1e-12, at most 8 vertices; the area's 8 shoelace terms
// (zeros past the last vertex) summed in numpy's pairwise order.  False
// when a pass keeps more than 8 vertices (quads that share an edge): numpy
// takes its scalar clip for such a pair, and so does the caller.
bool quad_intersection_area(const Pt* p, const Pt* q, double* area) {
  Pt v[8], out[16];
  double s[8];
  std::memcpy(v, p, 4 * sizeof(Pt));
  int nv = 4;
  for (int e = 0; e < 4; ++e) {
    const Pt a = q[e];
    const double bax = q[(e + 1) % 4].x - a.x;
    const double bay = q[(e + 1) % 4].y - a.y;
    for (int k = 0; k < nv; ++k)
      s[k] = bax * (v[k].y - a.y) - bay * (v[k].x - a.x);
    int m = 0;
    for (int k = 0; k < nv; ++k) {
      const int pk = (k + nv - 1) % nv;
      const bool in = s[k] >= 0.0;
      if (in != (s[pk] >= 0.0)) {
        const double denom = s[pk] - s[k];
        const double t = std::fabs(denom) > 1e-12 ? s[pk] / denom : 0.0;
        out[m++] = {v[pk].x + t * (v[k].x - v[pk].x),
                    v[pk].y + t * (v[k].y - v[pk].y)};
      }
      if (in) out[m++] = v[k];
    }
    if (m > 8) return false;
    std::memcpy(v, out, m * sizeof(Pt));
    nv = m;
  }
  double c[8];
  for (int k = 0; k < 8; ++k) {
    if (k < nv) {
      const Pt& nx = v[(k + 1) % nv];
      c[k] = v[k].x * nx.y - nx.x * v[k].y;
    } else {
      c[k] = 0.0;
    }
  }
  const double sum =
      ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7]));
  *area = nv >= 3 ? 0.5 * std::fabs(sum) : 0.0;
  return true;
}

struct Aabb {
  double lo_x, lo_y, hi_x, hi_y;
  bool nan;  // numpy's min and max spread a NaN, which fails every test
};

Aabb quad_aabb(const Pt* p) {
  Aabb b{p[0].x, p[0].y, p[0].x, p[0].y, false};
  for (int k = 0; k < 4; ++k) {
    b.nan |= std::isnan(p[k].x) || std::isnan(p[k].y);
    b.lo_x = std::fmin(b.lo_x, p[k].x);
    b.lo_y = std::fmin(b.lo_y, p[k].y);
    b.hi_x = std::fmax(b.hi_x, p[k].x);
    b.hi_y = std::fmax(b.hi_y, p[k].y);
  }
  return b;
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

// Pairwise rotated IoU of quads, bit for bit np_geometry.py's numpy body of
// pairwise_iou_rotated_np: p (n, 4, 2) and q (m, 4, 2) the float64
// polygons, area_p and area_q the float64 box areas, out (n, m) float32.
// A pair enters the clip when both areas exceed 1e-14 and the quads' AABBs
// meet; its IoU is inter / union where union = area_p + area_q - inter
// exceeds 1e-12, else 0.  The flat indices i * m + j of pairs whose clip
// overflows go to `overflow` (room for n * m), their entries left 0 for the
// caller's scalar clip; returns how many.
int64_t polyclip_pairwise_iou_quads(const double* p, const double* area_p,
                                    int32_t n, const double* q,
                                    const double* area_q, int32_t m,
                                    float* out, int64_t* overflow) {
  const Pt* pp = reinterpret_cast<const Pt*>(p);
  const Pt* qq = reinterpret_cast<const Pt*>(q);
  std::vector<Aabb> bq(m);
  for (int j = 0; j < m; ++j) bq[j] = quad_aabb(qq + 4 * j);
  int64_t n_over = 0;
  for (int i = 0; i < n; ++i) {
    const Aabb bp = quad_aabb(pp + 4 * i);
    for (int j = 0; j < m; ++j) {
      const int64_t k = static_cast<int64_t>(i) * m + j;
      out[k] = 0.0f;
      const Aabb& b = bq[j];
      if (bp.nan || b.nan || !(area_p[i] > 1e-14) || !(area_q[j] > 1e-14) ||
          !(bp.lo_x <= b.hi_x && b.lo_x <= bp.hi_x && bp.lo_y <= b.hi_y &&
            b.lo_y <= bp.hi_y))
        continue;
      double inter;
      if (!quad_intersection_area(pp + 4 * i, qq + 4 * j, &inter)) {
        overflow[n_over++] = k;
        continue;
      }
      const double uni = area_p[i] + area_q[j] - inter;
      out[k] = static_cast<float>(uni > 1e-12 ? inter / uni : 0.0);
    }
  }
  return n_over;
}
}
