// Native SBVH builder (host-side, one-time scene-build work).
//
// TPU-native re-design of the reference's default accelerator, the
// spatial-split BVH of Stich et al. 2009 (reference: libSLR/Accelerator/
// SBVH.h:57-348 — 32-bin binned object SAH, 16-bin spatial SAH with
// primitive chopping, spatial path triggered when the SA of the overlap of
// the object-split children exceeds alpha * SA(root), reference-duplication
// memory budget, leaf/split cost model). The output is NOT a pointer tree:
// it is the flat SoA node layout consumed by the device-side lock-step
// traversal in slr_tpu/accel/lbvh.py (node_min/node_max/node_left/node_right
// with negative child pointers encoding single-primitive leaf slots into
// prim_order). Scene build is sequential host work exactly as in the
// reference; the hot path (traversal) stays on the TPU.
//
// C ABI only; bound from Python via ctypes (slr_tpu/native/__init__.py).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kObjBins = 32;
constexpr int kSpatialBins = 16;
constexpr float kTravCost = 1.2f;   // node traversal cost
constexpr float kIsectCost = 1.0f;  // triangle intersection cost

struct V3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  V3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  V3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const V3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  bool valid() const { return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z; }
  float sa() const {
    if (!valid()) return 0.f;
    float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
  V3 centroid() const {
    return {0.5f * (lo.x + hi.x), 0.5f * (lo.y + hi.y), 0.5f * (lo.z + hi.z)};
  }
  AABB overlap(const AABB& b) const {
    AABB o;
    o.lo = vmax(lo, b.lo);
    o.hi = vmin(hi, b.hi);
    if (!o.valid()) o = AABB();
    return o;
  }
};

struct Ref {
  int tri;
  AABB box;
  // Per-primitive intersection cost (Surface::costForIntersect,
  // SBVH.h leaf/split cost model). Uniform kIsectCost when the caller
  // passes no table — all reference Surface types report a constant, so
  // the uniform model is exact for pure-triangle scenes; the hook exists
  // for mixed-cost primitive sets.
  float cost;
};

struct Node {
  V3 lo, hi;
  int left, right;
};

struct Builder {
  const float* p0;
  const float* p1;
  const float* p2;
  int enable_spatial;
  float alpha;
  int max_refs;
  float root_sa = 1.f;

  std::vector<Node> nodes;
  std::vector<int> prims;  // leaf slot -> triangle id (with duplicates)
  int max_depth = 0;
  float sah_cost = 0.f;  // sum of SA-weighted costs (normalized by root SA)
  int refs_total = 0;    // live refs across the whole tree (duplication budget)
  bool budget_hit = false;

  V3 tri_v(int tri, int k) const {
    const float* p = (k == 0 ? p0 : (k == 1 ? p1 : p2)) + 3 * tri;
    return {p[0], p[1], p[2]};
  }

  // Exact chopped bounds of triangle `tri` within slab [lo, hi] on `axis`
  // (reference: Triangle::choppedBounds, TriangleMesh.cpp:19-125). Clips the
  // triangle polygon against the two slab planes (Sutherland-Hodgman on one
  // axis) and returns the clipped polygon's AABB.
  AABB chop(int tri, int axis, float lo, float hi) const {
    V3 poly[9];
    int n = 3;
    poly[0] = tri_v(tri, 0);
    poly[1] = tri_v(tri, 1);
    poly[2] = tri_v(tri, 2);
    V3 tmp[9];
    // Clip against p[axis] >= lo, then p[axis] <= hi.
    for (int pass = 0; pass < 2; ++pass) {
      float plane = pass == 0 ? lo : hi;
      float sign = pass == 0 ? 1.f : -1.f;
      int m = 0;
      for (int i = 0; i < n; ++i) {
        const V3& a = poly[i];
        const V3& b = poly[(i + 1) % n];
        float da = sign * (a[axis] - plane);
        float db = sign * (b[axis] - plane);
        if (da >= 0.f) tmp[m++] = a;
        if ((da >= 0.f) != (db >= 0.f)) {
          float t = da / (da - db);
          tmp[m++] = {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
                      a.z + t * (b.z - a.z)};
        }
      }
      n = m;
      std::memcpy(poly, tmp, sizeof(V3) * n);
    }
    AABB out;
    for (int i = 0; i < n; ++i) out.grow(poly[i]);
    return out;
  }

  int make_leaf(const Ref& r) {
    int slot = (int)prims.size();
    prims.push_back(r.tri);
    return -(slot)-1;
  }

  // Returns child pointer (node id >= 0, or leaf encoding < 0).
  int build(std::vector<Ref>& refs, int depth) {
    max_depth = std::max(max_depth, depth);
    if (refs.size() == 1) return make_leaf(refs[0]);

    AABB bounds, cbounds;
    for (const Ref& r : refs) {
      bounds.grow(r.box);
      cbounds.grow(r.box.centroid());
    }
    float sa_parent = std::max(bounds.sa(), 1e-30f);
    int n = (int)refs.size();

    // ---- binned object SAH over all 3 axes (SBVH.h:131-160) ----
    float best_obj_cost = FLT_MAX;
    int best_obj_axis = -1, best_obj_bin = -1;
    AABB obj_left_box, obj_right_box;
    for (int axis = 0; axis < 3; ++axis) {
      float clo = cbounds.lo[axis], chi = cbounds.hi[axis];
      if (chi - clo < 1e-12f) continue;
      float inv = kObjBins / (chi - clo);
      AABB bin_box[kObjBins];
      int bin_cnt[kObjBins] = {0};
      float bin_cost[kObjBins] = {0.f};
      for (const Ref& r : refs) {
        int b = (int)((r.box.centroid()[axis] - clo) * inv);
        b = std::min(std::max(b, 0), kObjBins - 1);
        bin_box[b].grow(r.box);
        bin_cnt[b]++;
        bin_cost[b] += r.cost;
      }
      AABB right[kObjBins];
      AABB acc;
      for (int i = kObjBins - 1; i >= 1; --i) {
        acc.grow(bin_box[i]);
        right[i] = acc;
      }
      AABB lacc;
      int lcnt = 0;
      float lcost = 0.f, total_cost = 0.f;
      for (int i = 0; i < kObjBins; ++i) total_cost += bin_cost[i];
      for (int i = 0; i < kObjBins - 1; ++i) {
        lacc.grow(bin_box[i]);
        lcnt += bin_cnt[i];
        lcost += bin_cost[i];
        int rcnt = n - lcnt;
        float rcost = total_cost - lcost;
        if (lcnt == 0 || rcnt == 0) continue;
        float cost = kTravCost +
            (lacc.sa() * lcost + right[i + 1].sa() * rcost) / sa_parent;
        if (cost < best_obj_cost) {
          best_obj_cost = cost;
          best_obj_axis = axis;
          best_obj_bin = i;
          obj_left_box = lacc;
          obj_right_box = right[i + 1];
        }
      }
    }

    // ---- spatial split candidate (SBVH.h:193-241): tried when the object
    // children overlap significantly relative to the root (alpha test) ----
    float best_sp_cost = FLT_MAX;
    int best_sp_axis = -1;
    float best_sp_pos = 0.f;
    bool try_spatial = enable_spatial && best_obj_axis >= 0;
    if (try_spatial) {
      float lambda = obj_left_box.overlap(obj_right_box).sa();
      try_spatial = lambda / root_sa > alpha;
    }
    if (try_spatial) {
      for (int axis = 0; axis < 3; ++axis) {
        float lo = bounds.lo[axis], hi = bounds.hi[axis];
        if (hi - lo < 1e-12f) continue;
        float width = (hi - lo) / kSpatialBins;
        float inv = 1.f / width;
        AABB bin_box[kSpatialBins];
        int bin_enter[kSpatialBins] = {0}, bin_exit[kSpatialBins] = {0};
        float cost_enter[kSpatialBins] = {0.f}, cost_exit[kSpatialBins] = {0.f};
        for (const Ref& r : refs) {
          int b0 = (int)((r.box.lo[axis] - lo) * inv);
          int b1 = (int)((r.box.hi[axis] - lo) * inv);
          b0 = std::min(std::max(b0, 0), kSpatialBins - 1);
          b1 = std::min(std::max(b1, 0), kSpatialBins - 1);
          bin_enter[b0]++;
          bin_exit[b1]++;
          cost_enter[b0] += r.cost;
          cost_exit[b1] += r.cost;
          if (b0 == b1) {
            bin_box[b0].grow(r.box);
          } else {
            for (int b = b0; b <= b1; ++b) {
              AABB c = chop(r.tri, axis, lo + b * width, lo + (b + 1) * width);
              // Intersect with the ref's own box (refs may already be chopped).
              c.lo = vmax(c.lo, r.box.lo);
              c.hi = vmin(c.hi, r.box.hi);
              if (c.valid()) bin_box[b].grow(c);
            }
          }
        }
        AABB right[kSpatialBins];
        AABB acc;
        for (int i = kSpatialBins - 1; i >= 1; --i) {
          acc.grow(bin_box[i]);
          right[i] = acc;
        }
        AABB lacc;
        int lcnt = 0, rcnt = n;
        float lcost = 0.f, rcost = 0.f;
        for (int i = 0; i < kSpatialBins; ++i) rcost += cost_enter[i];
        for (int i = 0; i < kSpatialBins - 1; ++i) {
          lacc.grow(bin_box[i]);
          lcnt += bin_enter[i];
          rcnt -= bin_exit[i];
          lcost += cost_enter[i];
          rcost -= cost_exit[i];
          if (lcnt == 0 || rcnt == 0) continue;
          float cost = kTravCost +
              (lacc.sa() * lcost + right[i + 1].sa() * rcost) / sa_parent;
          if (cost < best_sp_cost) {
            best_sp_cost = cost;
            best_sp_axis = axis;
            best_sp_pos = lo + (i + 1) * width;
          }
        }
      }
    }

    std::vector<Ref> lrefs, rrefs;
    bool did_split = false;

    if (best_sp_axis >= 0 && best_sp_cost < best_obj_cost) {
      // Spatial partition with reference duplication (SBVH.h:276-345),
      // subject to the memory budget: abandon if it would overflow.
      lrefs.reserve(n);
      rrefs.reserve(n);
      for (const Ref& r : refs) {
        int axis = best_sp_axis;
        if (r.box.hi[axis] <= best_sp_pos) {
          lrefs.push_back(r);
        } else if (r.box.lo[axis] >= best_sp_pos) {
          rrefs.push_back(r);
        } else {
          Ref l = r, rr = r;
          l.box = chop(r.tri, axis, r.box.lo[axis], best_sp_pos);
          rr.box = chop(r.tri, axis, best_sp_pos, r.box.hi[axis]);
          l.box.lo = vmax(l.box.lo, r.box.lo);
          l.box.hi = vmin(l.box.hi, r.box.hi);
          rr.box.lo = vmax(rr.box.lo, r.box.lo);
          rr.box.hi = vmin(rr.box.hi, r.box.hi);
          if (l.box.valid()) lrefs.push_back(l);
          if (rr.box.valid()) rrefs.push_back(rr);
        }
      }
      // Duplication budget (SBVH.h ctor, memory budget): only accept the
      // spatial split if the extra references fit. Object splits never grow
      // the ref count, so respecting this bound here makes overflow
      // impossible anywhere.
      int added = (int)(lrefs.size() + rrefs.size()) - n;
      bool fits = refs_total + added <= max_refs;
      did_split = !lrefs.empty() && !rrefs.empty() && fits;
      if (did_split) {
        refs_total += added;
      } else if (!fits) {
        budget_hit = true;
      }
    }

    if (!did_split && best_obj_axis >= 0) {
      lrefs.clear();
      rrefs.clear();
      float clo = cbounds.lo[best_obj_axis], chi = cbounds.hi[best_obj_axis];
      float inv = kObjBins / (chi - clo);
      for (const Ref& r : refs) {
        int b = (int)((r.box.centroid()[best_obj_axis] - clo) * inv);
        b = std::min(std::max(b, 0), kObjBins - 1);
        (b <= best_obj_bin ? lrefs : rrefs).push_back(r);
      }
      did_split = !lrefs.empty() && !rrefs.empty();
    }

    if (!did_split) {
      // Degenerate (all centroids equal): median split by index.
      lrefs.assign(refs.begin(), refs.begin() + n / 2);
      rrefs.assign(refs.begin() + n / 2, refs.end());
    }

    refs.clear();
    refs.shrink_to_fit();

    int nid = (int)nodes.size();
    nodes.push_back(Node{});
    AABB lb, rb;
    for (const Ref& r : lrefs) lb.grow(r.box);
    for (const Ref& r : rrefs) rb.grow(r.box);
    nodes[nid].lo = bounds.lo;
    nodes[nid].hi = bounds.hi;
    sah_cost += kTravCost * sa_parent / root_sa;
    int l = build(lrefs, depth + 1);
    int r = build(rrefs, depth + 1);
    nodes[nid].left = l;
    nodes[nid].right = r;
    return nid;
  }
};

}  // namespace

extern "C" {

// Builds an SBVH over n triangles. Outputs are caller-allocated:
//   node_min/node_max: (max_refs, 3) float32
//   node_left/node_right: (max_refs,) int32
//   prim_order: (max_refs,) int32
//   stats: [n_nodes, n_refs, max_depth] int32; sah_cost: [1] float32
// Returns 0 on success, 1 if the duplication budget declined at least one
// spatial split (tree complete and correct, quality slightly degraded), 2 on
// bad input.
int slr_sbvh_build(const float* p0, const float* p1, const float* p2, int n,
                   int enable_spatial, float alpha, int max_refs,
                   float* node_min, float* node_max, int* node_left,
                   int* node_right, int* prim_order, int* stats,
                   float* sah_cost, const float* prim_cost) {
  if (n < 2 || max_refs < n) return 2;
  Builder b;
  b.p0 = p0;
  b.p1 = p1;
  b.p2 = p2;
  b.enable_spatial = enable_spatial;
  b.alpha = alpha;
  b.max_refs = max_refs;
  b.nodes.reserve((size_t)n * 2);
  b.prims.reserve((size_t)max_refs);

  std::vector<Ref> refs(n);
  AABB root;
  for (int i = 0; i < n; ++i) {
    refs[i].tri = i;
    AABB box;
    box.grow(b.tri_v(i, 0));
    box.grow(b.tri_v(i, 1));
    box.grow(b.tri_v(i, 2));
    refs[i].box = box;
    refs[i].cost = prim_cost ? prim_cost[i] : kIsectCost;
    root.grow(box);
  }
  b.root_sa = std::max(root.sa(), 1e-30f);
  b.refs_total = n;
  b.build(refs, 0);

  if ((int)b.nodes.size() > max_refs || (int)b.prims.size() > max_refs)
    return 2;  // should be impossible given the budget guard
  for (size_t i = 0; i < b.nodes.size(); ++i) {
    node_min[3 * i + 0] = b.nodes[i].lo.x;
    node_min[3 * i + 1] = b.nodes[i].lo.y;
    node_min[3 * i + 2] = b.nodes[i].lo.z;
    node_max[3 * i + 0] = b.nodes[i].hi.x;
    node_max[3 * i + 1] = b.nodes[i].hi.y;
    node_max[3 * i + 2] = b.nodes[i].hi.z;
    node_left[i] = b.nodes[i].left;
    node_right[i] = b.nodes[i].right;
  }
  std::memcpy(prim_order, b.prims.data(), sizeof(int) * b.prims.size());
  // Leaf intersection cost contribution for the stats report.
  stats[0] = (int)b.nodes.size();
  stats[1] = (int)b.prims.size();
  stats[2] = b.max_depth;
  float leaf_cost = 0.f;
  for (int id : b.prims) leaf_cost += prim_cost ? prim_cost[id] : kIsectCost;
  *sah_cost = b.sah_cost + leaf_cost / (float)n;
  return b.budget_hit ? 1 : 0;
}

}  // extern "C"
