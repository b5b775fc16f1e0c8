// Incremental isotropic remeshing (Botsch–Kobbelt 2004).
//
// Native host-side equivalent of the reference's pyremesh module
// (ext/botsch-kobbelt-remesher-libigl, called at scripts/main.py:149 as
// remesh_botsch(v, f, 5, h, True)): per iteration —
//   1. split edges longer than 4/3·h
//   2. collapse edges shorter than 4/5·h (link-condition guarded)
//   3. flip edges to equalize vertex valences (target 6)
//   4. tangential relaxation toward the 1-ring centroid
//   5. project vertices back onto the ORIGINAL surface (AABB-tree
//      closest-point queries)
//
// Runs on host between TPU optimization phases; output vertex/face counts
// are dynamic, so results flow back through a malloc'd buffer the caller
// frees with ls_free_buf.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <array>
#include <algorithm>
#include <unordered_map>
#include <unordered_set>

#include "bvh.hpp"

namespace {

using namespace lsgeom;

// ---------------- remesher core ----------------------------------------

struct Mesh {
  std::vector<V3> v;
  std::vector<Tri> f;
  std::vector<char> fdead;

  void compact() {
    std::vector<Tri> nf;
    nf.reserve(f.size());
    for (size_t i = 0; i < f.size(); ++i)
      if (!fdead[i]) nf.push_back(f[i]);
    f = std::move(nf);
    fdead.assign(f.size(), 0);
    // drop unused vertices
    std::vector<int> remap(v.size(), -1);
    std::vector<V3> nv;
    nv.reserve(v.size());
    for (auto& t : f)
      for (int k = 0; k < 3; ++k) {
        if (remap[t[k]] < 0) {
          remap[t[k]] = (int)nv.size();
          nv.push_back(v[t[k]]);
        }
        t[k] = remap[t[k]];
      }
    v = std::move(nv);
  }
};

// edge -> adjacent live faces
using EdgeFaces = std::unordered_map<EdgeKey, std::vector<int>, EdgeHash>;

EdgeFaces build_edge_faces(const Mesh& m) {
  EdgeFaces ef;
  ef.reserve(m.f.size() * 3);
  for (size_t i = 0; i < m.f.size(); ++i) {
    if (m.fdead[i]) continue;
    for (int k = 0; k < 3; ++k)
      ef[mk(m.f[i][k], m.f[i][(k + 1) % 3])].push_back((int)i);
  }
  return ef;
}

std::vector<std::vector<int>> vertex_adjacency(const Mesh& m) {
  std::vector<std::vector<int>> adj(m.v.size());
  for (size_t i = 0; i < m.f.size(); ++i) {
    if (m.fdead[i]) continue;
    for (int k = 0; k < 3; ++k) {
      int a = m.f[i][k], b = m.f[i][(k + 1) % 3];
      adj[a].push_back(b);
      adj[b].push_back(a);
    }
  }
  for (auto& a : adj) {
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
  }
  return adj;
}

void split_long_edges(Mesh& m, double hmax) {
  double h2 = hmax * hmax;
  for (int pass = 0; pass < 10; ++pass) {
    auto ef = build_edge_faces(m);
    std::vector<char> dirty(m.f.size(), 0);
    bool any = false;
    for (auto& [e, fl] : ef) {
      if ((m.v[e.a] - m.v[e.b]).norm2() <= h2) continue;
      bool skip = false;
      for (int fi : fl)
        if (m.fdead[fi] || dirty[fi]) { skip = true; break; }
      if (skip) continue;
      any = true;
      int mid = (int)m.v.size();
      m.v.push_back((m.v[e.a] + m.v[e.b]) * 0.5);
      for (int fi : fl) {
        dirty[fi] = 1;
        Tri t = m.f[fi];
        // find the edge within the face and split into two faces
        for (int k = 0; k < 3; ++k) {
          int a = t[k], b = t[(k + 1) % 3], c = t[(k + 2) % 3];
          if (mk(a, b) == e) {
            m.fdead[fi] = 1;
            m.f.push_back({a, mid, c});
            m.fdead.push_back(0);
            m.f.push_back({mid, b, c});
            m.fdead.push_back(0);
            break;
          }
        }
      }
    }
    if (!any) break;
    m.compact();
  }
}

void collapse_short_edges(Mesh& m, double hmin, double hmax) {
  double lo2 = hmin * hmin, hi2 = hmax * hmax;
  for (int pass = 0; pass < 10; ++pass) {
    auto ef = build_edge_faces(m);
    auto adj = vertex_adjacency(m);
    std::vector<std::vector<int>> vfaces(m.v.size());
    for (size_t i = 0; i < m.f.size(); ++i) {
      if (m.fdead[i]) continue;
      for (int k = 0; k < 3; ++k) vfaces[m.f[i][k]].push_back((int)i);
    }
    std::vector<char> vtouched(m.v.size(), 0);
    bool any = false;
    for (auto& [e, fl] : ef) {
      if (vtouched[e.a] || vtouched[e.b]) continue;
      if ((m.v[e.a] - m.v[e.b]).norm2() >= lo2) continue;
      if (fl.size() != 2) continue;  // boundary / non-manifold: skip
      // link condition: common neighbors of a and b must be exactly the
      // two opposite vertices of the shared faces
      std::unordered_set<int> na(adj[e.a].begin(), adj[e.a].end());
      int common = 0;
      bool bad = false;
      for (int x : adj[e.b])
        if (na.count(x)) ++common;
      std::unordered_set<int> opposite;
      for (int fi : fl)
        for (int k = 0; k < 3; ++k)
          if (m.f[fi][k] != e.a && m.f[fi][k] != e.b) opposite.insert(m.f[fi][k]);
      if (common != (int)opposite.size()) bad = true;
      if (bad) continue;
      // collapse to midpoint; reject if it would create an over-long edge
      V3 mid = (m.v[e.a] + m.v[e.b]) * 0.5;
      bool toolong = false;
      for (int x : adj[e.a])
        if (x != e.b && (m.v[x] - mid).norm2() > hi2) { toolong = true; break; }
      if (!toolong)
        for (int x : adj[e.b])
          if (x != e.a && (m.v[x] - mid).norm2() > hi2) { toolong = true; break; }
      if (toolong) continue;

      any = true;
      m.v[e.a] = mid;
      // faces on b: rewire b -> a; faces on both a and b die
      for (int fi : vfaces[e.b]) {
        if (m.fdead[fi]) continue;
        Tri& t = m.f[fi];
        bool has_a = false;
        for (int k = 0; k < 3; ++k) has_a |= (t[k] == e.a);
        if (has_a) {
          m.fdead[fi] = 1;
        } else {
          for (int k = 0; k < 3; ++k)
            if (t[k] == e.b) t[k] = e.a;
        }
      }
      vtouched[e.a] = 1;
      vtouched[e.b] = 1;
      for (int x : adj[e.a]) vtouched[x] = 1;
      for (int x : adj[e.b]) vtouched[x] = 1;
    }
    m.compact();
    if (!any) break;
  }
}

void flip_for_valence(Mesh& m) {
  auto valence_of = [&](const std::vector<std::vector<int>>& adj, int v) {
    return (int)adj[v].size();
  };
  for (int pass = 0; pass < 5; ++pass) {
    auto ef = build_edge_faces(m);
    auto adj = vertex_adjacency(m);
    std::vector<char> fdirty(m.f.size(), 0);
    std::unordered_set<EdgeKey, EdgeHash> existing;
    existing.reserve(ef.size());
    for (auto& [e, fl] : ef) existing.insert(e);
    bool any = false;
    for (auto& [e, fl] : ef) {
      if (fl.size() != 2) continue;
      int f0 = fl[0], f1 = fl[1];
      if (m.fdead[f0] || m.fdead[f1] || fdirty[f0] || fdirty[f1]) continue;
      int c0 = -1, c1 = -1;
      for (int k = 0; k < 3; ++k) {
        if (m.f[f0][k] != e.a && m.f[f0][k] != e.b) c0 = m.f[f0][k];
        if (m.f[f1][k] != e.a && m.f[f1][k] != e.b) c1 = m.f[f1][k];
      }
      if (c0 < 0 || c1 < 0 || c0 == c1) continue;
      if (existing.count(mk(c0, c1))) continue;  // flip would duplicate edge
      int va = valence_of(adj, e.a), vb = valence_of(adj, e.b);
      int vc0 = valence_of(adj, c0), vc1 = valence_of(adj, c1);
      auto dev = [](int val) { int d = val - 6; return d * d; };
      int before = dev(va) + dev(vb) + dev(vc0) + dev(vc1);
      int after = dev(va - 1) + dev(vb - 1) + dev(vc0 + 1) + dev(vc1 + 1);
      if (after >= before) continue;
      // geometric guard: don't flip through the surface (normal agreement)
      V3 n_before = (m.v[e.b] - m.v[e.a]).cross(m.v[c0] - m.v[e.a]) +
                    (m.v[c1] - m.v[e.a]).cross(m.v[e.b] - m.v[e.a]);
      V3 n_after = (m.v[c1] - m.v[c0]).cross(m.v[e.a] - m.v[c0]) +
                   (m.v[e.b] - m.v[c0]).cross(m.v[c1] - m.v[c0]);
      if (n_before.dot(n_after) <= 0) continue;

      // orient new faces consistently with f0's winding
      int a = e.a, b = e.b;
      // find orientation of (a, b) in f0
      bool ab_in_f0 = false;
      for (int k = 0; k < 3; ++k)
        if (m.f[f0][k] == a && m.f[f0][(k + 1) % 3] == b) ab_in_f0 = true;
      if (!ab_in_f0) std::swap(a, b);
      // f0 was (a, b, c0); f1 was (b, a, c1)
      m.f[f0] = {a, c1, c0};
      m.f[f1] = {c1, b, c0};
      fdirty[f0] = fdirty[f1] = 1;
      any = true;
      existing.insert(mk(c0, c1));
    }
    if (!any) break;
  }
}

void tangential_relax(Mesh& m, const BVH* bvh, bool project) {
  // area-weighted vertex normals + uniform 1-ring centroids
  std::vector<V3> normal(m.v.size());
  std::vector<V3> centroid(m.v.size());
  std::vector<double> wsum(m.v.size(), 0.0);
  for (size_t i = 0; i < m.f.size(); ++i) {
    if (m.fdead[i]) continue;
    const Tri& t = m.f[i];
    V3 n = (m.v[t[1]] - m.v[t[0]]).cross(m.v[t[2]] - m.v[t[0]]);
    for (int k = 0; k < 3; ++k) normal[t[k]] = normal[t[k]] + n;
  }
  auto adj = vertex_adjacency(m);
  for (size_t i = 0; i < m.v.size(); ++i) {
    V3 c(0, 0, 0);
    for (int x : adj[i]) c = c + m.v[x];
    if (!adj[i].empty()) c = c * (1.0 / adj[i].size());
    centroid[i] = c;
    (void)wsum;
  }
  for (size_t i = 0; i < m.v.size(); ++i) {
    if (adj[i].empty()) continue;
    V3 n = normal[i];
    double nn = n.norm();
    V3 d = centroid[i] - m.v[i];
    if (nn > 1e-300) {
      n = n * (1.0 / nn);
      d = d - n * n.dot(d);  // tangential component only
    }
    V3 p = m.v[i] + d * 0.5;
    if (project && bvh) p = bvh->closest_point(p);
    m.v[i] = p;
  }
}

}  // namespace

extern "C" {

int ls_remesh(const double* v_in, int nv, const int* f_in, int nf,
              int iterations, double h, int project,
              double** out_v, int* out_nv, int** out_f, int* out_nf) {
  Mesh m;
  m.v.resize(nv);
  for (int i = 0; i < nv; ++i) m.v[i] = {v_in[3 * i], v_in[3 * i + 1], v_in[3 * i + 2]};
  m.f.resize(nf);
  for (int i = 0; i < nf; ++i) m.f[i] = {f_in[3 * i], f_in[3 * i + 1], f_in[3 * i + 2]};
  m.fdead.assign(nf, 0);

  // original surface for projection
  std::vector<V3> ov = m.v;
  std::vector<Tri> of = m.f;
  BVH bvh;
  if (project) bvh.init(ov, of);

  double hmax = 4.0 * h / 3.0;
  double hmin = 4.0 * h / 5.0;
  for (int it = 0; it < iterations; ++it) {
    split_long_edges(m, hmax);
    collapse_short_edges(m, hmin, hmax);
    flip_for_valence(m);
    tangential_relax(m, project ? &bvh : nullptr, project != 0);
  }
  m.compact();

  *out_nv = (int)m.v.size();
  *out_nf = (int)m.f.size();
  *out_v = (double*)std::malloc(sizeof(double) * 3 * m.v.size());
  *out_f = (int*)std::malloc(sizeof(int) * 3 * m.f.size());
  for (size_t i = 0; i < m.v.size(); ++i) {
    (*out_v)[3 * i] = m.v[i].x;
    (*out_v)[3 * i + 1] = m.v[i].y;
    (*out_v)[3 * i + 2] = m.v[i].z;
  }
  for (size_t i = 0; i < m.f.size(); ++i) {
    (*out_f)[3 * i] = m.f[i][0];
    (*out_f)[3 * i + 1] = m.f[i][1];
    (*out_f)[3 * i + 2] = m.f[i][2];
  }
  return 0;
}

void ls_free_buf(void* p) { std::free(p); }

}  // extern "C"
