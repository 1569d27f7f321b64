// Closest-point-on-mesh queries via an AABB BVH (host-side, C++).
//
// Native equivalent of trimesh.proximity.closest_point used by the reference
// Chamfer metric (chamfer_dist.py:24-25): exact point-to-triangle distances,
// BVH-pruned.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

struct V3d {
  double x, y, z;
  V3d operator-(const V3d& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3d operator+(const V3d& o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3d operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const V3d& o) const { return x * o.x + y * o.y + z * o.z; }
};

double point_tri_dist2(const V3d& p, const V3d& a, const V3d& b, const V3d& c) {
  // Ericson, "Real-Time Collision Detection" closest-point-on-triangle
  V3d ab = b - a, ac = c - a, ap = p - a;
  double d1 = ab.dot(ap), d2 = ac.dot(ap);
  if (d1 <= 0 && d2 <= 0) { V3d d = p - a; return d.dot(d); }
  V3d bp = p - b;
  double d3 = ab.dot(bp), d4 = ac.dot(bp);
  if (d3 >= 0 && d4 <= d3) { V3d d = p - b; return d.dot(d); }
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    double v = d1 / (d1 - d3);
    V3d q = a + ab * v; V3d d = p - q; return d.dot(d);
  }
  V3d cp = p - c;
  double d5 = ab.dot(cp), d6 = ac.dot(cp);
  if (d6 >= 0 && d5 <= d6) { V3d d = p - c; return d.dot(d); }
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    double w = d2 / (d2 - d6);
    V3d q = a + ac * w; V3d d = p - q; return d.dot(d);
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    V3d q = b + (c - b) * w; V3d d = p - q; return d.dot(d);
  }
  double denom = 1.0 / (va + vb + vc);
  double v = vb * denom, w = vc * denom;
  V3d q = a + ab * v + ac * w;
  V3d d = p - q;
  return d.dot(d);
}

struct BVH {
  struct Node {
    double bmin[3], bmax[3];
    int left = -1, right = -1;   // children, or
    int start = 0, count = 0;    // leaf triangle range
  };
  std::vector<double> vert_store;   // owned copies (caller arrays may die)
  std::vector<int64_t> tri_store;
  const double* verts;
  const int64_t* tris;
  std::vector<int> order;        // triangle indices, leaf-partitioned
  std::vector<Node> nodes;

  V3d vert(int64_t vi) const {
    return {verts[3 * vi], verts[3 * vi + 1], verts[3 * vi + 2]};
  }
  V3d centroid(int t) const {
    V3d a = vert(tris[3 * t]), b = vert(tris[3 * t + 1]), c = vert(tris[3 * t + 2]);
    return (a + b + c) * (1.0 / 3.0);
  }

  void bounds(Node& n) {
    for (int d = 0; d < 3; d++) {
      n.bmin[d] = std::numeric_limits<double>::infinity();
      n.bmax[d] = -std::numeric_limits<double>::infinity();
    }
    for (int i = n.start; i < n.start + n.count; i++) {
      int t = order[i];
      for (int k = 0; k < 3; k++) {
        V3d v = vert(tris[3 * t + k]);
        double co[3] = {v.x, v.y, v.z};
        for (int d = 0; d < 3; d++) {
          n.bmin[d] = std::min(n.bmin[d], co[d]);
          n.bmax[d] = std::max(n.bmax[d], co[d]);
        }
      }
    }
  }

  int build(int start, int count) {
    int ni = (int)nodes.size();
    nodes.push_back({});
    nodes[ni].start = start;
    nodes[ni].count = count;
    bounds(nodes[ni]);
    if (count <= 4) return ni;
    // split along widest centroid axis at median
    int axis = 0;
    double ext[3];
    for (int d = 0; d < 3; d++) ext[d] = nodes[ni].bmax[d] - nodes[ni].bmin[d];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    auto mid = order.begin() + start + count / 2;
    std::nth_element(
        order.begin() + start, mid, order.begin() + start + count,
        [&](int a, int b) {
          V3d ca = centroid(a), cb = centroid(b);
          double va = axis == 0 ? ca.x : axis == 1 ? ca.y : ca.z;
          double vb = axis == 0 ? cb.x : axis == 1 ? cb.y : cb.z;
          return va < vb;
        });
    int l = build(start, count / 2);
    int r = build(start + count / 2, count - count / 2);
    nodes[ni].left = l;
    nodes[ni].right = r;
    nodes[ni].count = 0;
    return ni;
  }

  double box_dist2(const Node& n, const V3d& p) const {
    double d2 = 0, co[3] = {p.x, p.y, p.z};
    for (int d = 0; d < 3; d++) {
      double v = co[d];
      if (v < n.bmin[d]) d2 += (n.bmin[d] - v) * (n.bmin[d] - v);
      else if (v > n.bmax[d]) d2 += (v - n.bmax[d]) * (v - n.bmax[d]);
    }
    return d2;
  }

  void query(int ni, const V3d& p, double& best) const {
    const Node& n = nodes[ni];
    if (box_dist2(n, p) >= best) return;
    if (n.left < 0) {
      for (int i = n.start; i < n.start + n.count; i++) {
        int t = order[i];
        double d2 = point_tri_dist2(p, vert(tris[3 * t]), vert(tris[3 * t + 1]),
                                    vert(tris[3 * t + 2]));
        best = std::min(best, d2);
      }
      return;
    }
    double dl = box_dist2(nodes[n.left], p), dr = box_dist2(nodes[n.right], p);
    if (dl < dr) { query(n.left, p, best); query(n.right, p, best); }
    else { query(n.right, p, best); query(n.left, p, best); }
  }
};

}  // namespace

extern "C" {

void* bvh_build(const double* verts, int64_t n_verts, const int64_t* tris,
                int64_t n_tris) {
  BVH* b = new BVH;
  b->vert_store.assign(verts, verts + 3 * n_verts);
  b->tri_store.assign(tris, tris + 3 * n_tris);
  b->verts = b->vert_store.data();
  b->tris = b->tri_store.data();
  b->order.resize(n_tris);
  for (int64_t i = 0; i < n_tris; i++) b->order[i] = (int)i;
  b->nodes.reserve(2 * n_tris);
  b->build(0, (int)n_tris);
  return b;
}

void bvh_free(void* h) { delete (BVH*)h; }

void bvh_distances(void* h, const double* pts, int64_t n, double* out) {
  BVH* b = (BVH*)h;
  for (int64_t i = 0; i < n; i++) {
    V3d p = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    double best = std::numeric_limits<double>::infinity();
    b->query(0, p, best);
    out[i] = std::sqrt(best);
  }
}

}  // extern "C"
