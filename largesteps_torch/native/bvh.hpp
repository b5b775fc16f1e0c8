// Shared small-geometry library: V3 and an AABB tree with
// closest-point-on-triangle queries (used by the remesher's surface
// projection and the Hausdorff metric).
#pragma once

#include <cstdint>
#include <cmath>
#include <vector>
#include <array>
#include <algorithm>
#include <unordered_map>

namespace lsgeom {

struct V3 {
  double x = 0, y = 0, z = 0;
  V3() = default;
  V3(double a, double b, double c) : x(a), y(b), z(c) {}
  V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const V3& o) const { return x * o.x + y * o.y + z * o.z; }
  V3 cross(const V3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm2() const { return dot(*this); }
  double norm() const { return std::sqrt(norm2()); }
};

using Tri = std::array<int, 3>;

struct EdgeKey {
  int a, b;
  bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
};
struct EdgeHash {
  size_t operator()(const EdgeKey& e) const {
    return std::hash<int64_t>()(((int64_t)e.a << 32) | (uint32_t)e.b);
  }
};
inline EdgeKey mk(int a, int b) { return a < b ? EdgeKey{a, b} : EdgeKey{b, a}; }

// ---------------- AABB tree for closest-point projection ----------------

struct BVHNode {
  V3 lo, hi;
  int left = -1, right = -1;   // children, or
  int start = 0, count = 0;    // leaf triangle range
};

struct BVH {
  std::vector<BVHNode> nodes;
  std::vector<int> tri_order;
  const std::vector<V3>* verts;
  const std::vector<Tri>* tris;
  std::vector<V3> centroids;

  int build(int start, int count) {
    BVHNode node;
    V3 lo(1e300, 1e300, 1e300), hi(-1e300, -1e300, -1e300);
    for (int t = start; t < start + count; ++t) {
      const Tri& f = (*tris)[tri_order[t]];
      for (int k = 0; k < 3; ++k) {
        const V3& p = (*verts)[f[k]];
        lo = {std::min(lo.x, p.x), std::min(lo.y, p.y), std::min(lo.z, p.z)};
        hi = {std::max(hi.x, p.x), std::max(hi.y, p.y), std::max(hi.z, p.z)};
      }
    }
    node.lo = lo;
    node.hi = hi;
    int idx = (int)nodes.size();
    nodes.push_back(node);
    if (count <= 4) {
      nodes[idx].start = start;
      nodes[idx].count = count;
      return idx;
    }
    V3 ext = hi - lo;
    int axis = (ext.x > ext.y && ext.x > ext.z) ? 0 : (ext.y > ext.z ? 1 : 2);
    auto key = [&](int t) {
      const V3& c = centroids[t];
      return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
    };
    std::nth_element(tri_order.begin() + start,
                     tri_order.begin() + start + count / 2,
                     tri_order.begin() + start + count,
                     [&](int a, int b) { return key(a) < key(b); });
    int mid = count / 2;
    int l = build(start, mid);
    int r = build(start + mid, count - mid);
    nodes[idx].left = l;
    nodes[idx].right = r;
    nodes[idx].count = 0;
    return idx;
  }

  void init(const std::vector<V3>& v, const std::vector<Tri>& f) {
    verts = &v;
    tris = &f;
    tri_order.resize(f.size());
    centroids.resize(f.size());
    for (size_t i = 0; i < f.size(); ++i) {
      tri_order[i] = (int)i;
      centroids[i] = (v[f[i][0]] + v[f[i][1]] + v[f[i][2]]) * (1.0 / 3.0);
    }
    nodes.reserve(2 * f.size());
    if (!f.empty()) build(0, (int)f.size());
  }

  static double box_dist2(const BVHNode& n, const V3& p) {
    double d2 = 0;
    auto clampd = [](double v, double lo, double hi) {
      return v < lo ? lo - v : (v > hi ? v - hi : 0.0);
    };
    double dx = clampd(p.x, n.lo.x, n.hi.x);
    double dy = clampd(p.y, n.lo.y, n.hi.y);
    double dz = clampd(p.z, n.lo.z, n.hi.z);
    d2 = dx * dx + dy * dy + dz * dz;
    return d2;
  }

  static V3 closest_on_tri(const V3& p, const V3& a, const V3& b, const V3& c) {
    // Ericson, Real-Time Collision Detection, closest point on triangle.
    V3 ab = b - a, ac = c - a, ap = p - a;
    double d1 = ab.dot(ap), d2 = ac.dot(ap);
    if (d1 <= 0 && d2 <= 0) return a;
    V3 bp = p - b;
    double d3 = ab.dot(bp), d4 = ac.dot(bp);
    if (d3 >= 0 && d4 <= d3) return b;
    double vc = d1 * d4 - d3 * d2;
    if (vc <= 0 && d1 >= 0 && d3 <= 0) {
      double v = d1 / (d1 - d3);
      return a + ab * v;
    }
    V3 cp = p - c;
    double d5 = ab.dot(cp), d6 = ac.dot(cp);
    if (d6 >= 0 && d5 <= d6) return c;
    double vb = d5 * d2 - d1 * d6;
    if (vb <= 0 && d2 >= 0 && d6 <= 0) {
      double w = d2 / (d2 - d6);
      return a + ac * w;
    }
    double va = d3 * d6 - d5 * d4;
    if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
      double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
      return b + (c - b) * w;
    }
    double denom = 1.0 / (va + vb + vc);
    double v = vb * denom, w = vc * denom;
    return a + ab * v + ac * w;
  }

  V3 closest_point(const V3& p) const {
    double best_d2 = 1e300;
    V3 best = p;
    // iterative traversal with a small stack
    int stack[128];
    int top = 0;
    if (nodes.empty()) return p;
    stack[top++] = 0;
    while (top > 0) {
      int ni = stack[--top];
      const BVHNode& n = nodes[ni];
      if (box_dist2(n, p) >= best_d2) continue;
      if (n.left < 0) {
        for (int t = n.start; t < n.start + n.count; ++t) {
          const Tri& f = (*tris)[tri_order[t]];
          V3 q = closest_on_tri(p, (*verts)[f[0]], (*verts)[f[1]], (*verts)[f[2]]);
          double d2 = (q - p).norm2();
          if (d2 < best_d2) { best_d2 = d2; best = q; }
        }
      } else {
        // visit nearer child first
        double dl = box_dist2(nodes[n.left], p);
        double dr = box_dist2(nodes[n.right], p);
        if (dl < dr) {
          if (top < 126) { stack[top++] = n.right; stack[top++] = n.left; }
        } else {
          if (top < 126) { stack[top++] = n.left; stack[top++] = n.right; }
        }
      }
    }
    return best;
  }
};


}  // namespace lsgeom
