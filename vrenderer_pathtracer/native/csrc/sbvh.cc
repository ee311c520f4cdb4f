// SBVH builder: spatial-splits BVH (Stich, Friedrich, Dammertz, HPG 2009).
//
// Host-native counterpart of the reference's builder (src/SBVH.cpp:15-537)
// with the same split policy and constants, re-implemented from the
// algorithm (not translated):
//   * full-sweep SAH object split over all 3 axes (src/SBVH.cpp:174-224)
//   * binned spatial split, 32 bins, widest axis, gated by child-overlap
//     surface area > 0.3 * SA(root)                (src/SBVH.cpp:230-334)
//   * greedy reference unsplitting (unsplit-left / unsplit-right /
//     duplicate cost model)                        (src/SBVH.cpp:339-418)
//   * C_tri = C_node = 1, min leaf 4               (include/Utilities.h:16-21)
//
// Deliberate divergences for the vectorized traversals (SURVEY §7):
//   * leaves are capped at MAX_LEAF=8 triangles (forced split above) so the
//     vectorized leaf loop has a static bound;
//   * output is NOT the Aila/Laine bit-cast float4 quad layout but plain
//     SoA arrays: per node 12 floats (two child AABBs) + 4 ints
//     (child ref/count pairs); leaves index a duplicated tri-order array.
//   * the root is always an inner node (traversal starts by pushing node 0).
//
// Node encoding, nodes_i[n] = {c0, n0, c1, n1}:
//   nK == 0  -> child K is inner node index cK
//   nK  > 0  -> child K is a leaf: tri_order[cK .. cK+nK)
//   nK  < 0  -> child K is empty (box is inverted so slab tests miss)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "math3.h"

namespace vtrace {
namespace {

constexpr float kTriCost = 1.f;
constexpr float kNodeCost = 1.f;
constexpr int kMinLeaf = 4;
constexpr int kMaxLeaf = 8;
constexpr int kSpatialBins = 32;
constexpr float kOverlapAlpha = 0.3f;
constexpr int kSahDepthLimit = 48;  // below: median splits (bounded depth)

struct TriRef {
  int tri;
  AABB box;
};

struct Child {
  int index;  // node index, tri_order start, or -1
  int count;  // 0 inner, >0 leaf, <0 empty
  AABB box;
};

class Builder {
 public:
  Builder(const float* verts, const int* tris, int n_tris)
      : verts_(verts), tris_(tris) {
    refs_.reserve(n_tris);
    for (int i = 0; i < n_tris; ++i) {
      TriRef r{i, {}};
      for (int k = 0; k < 3; ++k) r.box.extend(vert(tris_[3 * i + k]));
      root_box_.extend(r.box);
      refs_.push_back(r);
    }
    root_sa_ = root_box_.surface_area();
  }

  void build() {
    // Root is always inner: emit one node and split (forced if tiny).
    build_inner(std::move(refs_), root_box_, 0);
  }

  std::vector<float> nodes_f;  // [M,12]
  std::vector<int> nodes_i;    // [M,4]
  std::vector<int> tri_order;  // leaf slots -> original tri index
  int max_depth = 0;           // deepest inner node (root = 0)

 private:
  V3 vert(int i) const {
    return {verts_[3 * i], verts_[3 * i + 1], verts_[3 * i + 2]};
  }

  // ---- split search -----------------------------------------------------

  struct ObjectSplit {
    float cost = FLT_MAX;
    int axis = -1;
    int index = 0;  // left gets sorted[0..index)
    AABB left, right;
  };

  ObjectSplit find_object_split(std::vector<TriRef>& refs, float parent_sa) {
    ObjectSplit best;
    const int n = (int)refs.size();
    std::vector<float> right_sa(n);
    for (int axis = 0; axis < 3; ++axis) {
      std::sort(refs.begin(), refs.end(), [axis](const TriRef& a, const TriRef& b) {
        float ca = a.box.centroid()[axis], cb = b.box.centroid()[axis];
        if (ca != cb) return ca < cb;
        return a.tri < b.tri;  // deterministic tie-break
      });
      AABB acc;
      for (int i = n - 1; i > 0; --i) {
        acc.extend(refs[i].box);
        right_sa[i] = acc.surface_area();
      }
      acc = AABB();
      for (int i = 1; i < n; ++i) {
        acc.extend(refs[i - 1].box);
        float c = kNodeCost +
                  (acc.surface_area() * i + right_sa[i] * (n - i)) *
                      (kTriCost / parent_sa);
        if (c < best.cost) {
          best.cost = c;
          best.axis = axis;
          best.index = i;
        }
      }
    }
    if (best.axis >= 0) {
      // Re-sort on the winning axis and record child bounds.
      std::sort(refs.begin(), refs.end(),
                [a = best.axis](const TriRef& x, const TriRef& y) {
                  float cx = x.box.centroid()[a], cy = y.box.centroid()[a];
                  if (cx != cy) return cx < cy;
                  return x.tri < y.tri;
                });
      for (int i = 0; i < best.index; ++i) best.left.extend(refs[i].box);
      for (int i = best.index; i < (int)refs.size(); ++i)
        best.right.extend(refs[i].box);
    }
    return best;
  }

  // Clip a triangle to the slab [lo, hi] on `axis`; AABB of the clipped
  // polygon intersected with the reference's (possibly pre-clipped) box.
  AABB clip_tri(const TriRef& r, int axis, float lo, float hi) const {
    V3 poly[9], tmp[9];
    int n = 3;
    for (int k = 0; k < 3; ++k) poly[k] = vert(tris_[3 * r.tri + k]);
    // Sutherland-Hodgman against the two slab planes.
    for (int side = 0; side < 2; ++side) {
      const float plane = side == 0 ? lo : hi;
      const float sgn = side == 0 ? 1.f : -1.f;  // keep >=lo, then <=hi
      int m = 0;
      for (int i = 0; i < n; ++i) {
        V3 a = poly[i], b = poly[(i + 1) % n];
        float da = sgn * (a[axis] - plane), db = sgn * (b[axis] - plane);
        if (da >= 0.f) tmp[m++] = a;
        if ((da > 0.f) != (db > 0.f) && da != db) {
          float t = da / (da - db);
          tmp[m++] = a + (b - a) * t;
        }
      }
      n = m;
      std::memcpy(poly, tmp, sizeof(V3) * n);
      if (n == 0) break;
    }
    AABB out;
    for (int i = 0; i < n; ++i) out.extend(poly[i]);
    return out.intersect(r.box);
  }

  struct SpatialSplit {
    float cost = FLT_MAX;
    int axis = -1;
    float pos = 0.f;
    AABB left, right;
    int n_left = 0, n_right = 0;
  };

  SpatialSplit find_spatial_split(const std::vector<TriRef>& refs,
                                  const AABB& bounds, float parent_sa) {
    SpatialSplit best;
    V3 sz = bounds.size();
    int axis = 0;
    if (sz.y > sz.x) axis = 1;
    if (sz.z > sz[axis]) axis = 2;
    const float lo = bounds.lo[axis], hi = bounds.hi[axis];
    if (hi - lo < 1e-12f) return best;
    const float bin_w = (hi - lo) / kSpatialBins;

    AABB bin_box[kSpatialBins];
    int enter[kSpatialBins] = {0}, exit_[kSpatialBins] = {0};
    for (const TriRef& r : refs) {
      int b0 = std::clamp((int)((r.box.lo[axis] - lo) / bin_w), 0, kSpatialBins - 1);
      int b1 = std::clamp((int)((r.box.hi[axis] - lo) / bin_w), 0, kSpatialBins - 1);
      enter[b0]++;
      exit_[b1]++;
      if (b0 == b1) {
        bin_box[b0].extend(r.box);
      } else {
        for (int b = b0; b <= b1; ++b) {
          AABB clipped = clip_tri(r, axis, lo + b * bin_w, lo + (b + 1) * bin_w);
          if (clipped.valid()) bin_box[b].extend(clipped);
        }
      }
    }
    // Sweep the 31 interior plane positions.
    AABB left_acc[kSpatialBins];
    AABB acc;
    for (int b = 0; b < kSpatialBins; ++b) {
      acc.extend(bin_box[b]);
      left_acc[b] = acc;
    }
    acc = AABB();
    for (int b = kSpatialBins - 1; b >= 1; --b) {
      acc.extend(bin_box[b]);
      // nl = refs wholly left of plane b, nr = wholly right; straddlers land
      // in both children (before unsplitting adjusts this greedily).
      int nl = 0;
      for (int bb = 0; bb < b; ++bb) nl += exit_[bb];
      int nr = 0;
      for (int bb = b; bb < kSpatialBins; ++bb) nr += enter[bb];
      int straddle = (int)refs.size() - nl - nr;  // >= 0
      nl += straddle;
      nr += straddle;
      if (nl == 0 || nr == 0 || !left_acc[b - 1].valid() || !acc.valid())
        continue;
      float c = kNodeCost + (left_acc[b - 1].surface_area() * nl +
                             acc.surface_area() * nr) *
                                (kTriCost / parent_sa);
      if (c < best.cost) {
        best.cost = c;
        best.axis = axis;
        best.pos = lo + b * bin_w;
        best.left = left_acc[b - 1];
        best.right = acc;
        best.n_left = nl;
        best.n_right = nr;
      }
    }
    return best;
  }

  // ---- recursion --------------------------------------------------------

  Child build_node(std::vector<TriRef> refs, AABB bounds, int depth) {
    const int n = (int)refs.size();
    if (n == 0) return {-1, -1, {}};
    float parent_sa = std::max(bounds.surface_area(), 1e-20f);

    if (n <= kMinLeaf) return make_leaf(refs, bounds);

    if (depth >= kSahDepthLimit) {
      return build_inner_median(std::move(refs), bounds, depth);
    }

    ObjectSplit os = find_object_split(refs, parent_sa);
    float leaf_cost = n * kTriCost;

    SpatialSplit ss;
    if (os.axis >= 0) {
      float overlap = os.left.intersect(os.right).surface_area();
      if (overlap > kOverlapAlpha * root_sa_)
        ss = find_spatial_split(refs, bounds, parent_sa);
    }

    const float split_cost = std::min(os.cost, ss.cost);
    if (n <= kMaxLeaf && leaf_cost <= split_cost) return make_leaf(refs, bounds);

    if (ss.cost < os.cost) {
      return do_spatial_split(std::move(refs), bounds, ss, depth);
    }
    if (os.axis < 0) return build_inner_median(std::move(refs), bounds, depth);

    // refs are sorted on os.axis by find_object_split's final re-sort.
    std::vector<TriRef> left(refs.begin(), refs.begin() + os.index);
    std::vector<TriRef> right(refs.begin() + os.index, refs.end());
    refs.clear();
    refs.shrink_to_fit();
    return emit_inner(std::move(left), os.left, std::move(right), os.right,
                      bounds, depth);
  }

  Child do_spatial_split(std::vector<TriRef> refs, const AABB& bounds,
                         const SpatialSplit& ss, int depth) {
    std::vector<TriRef> left, right;
    AABB lbox, rbox;
    float sa_l = std::max(ss.left.surface_area(), 1e-20f);
    float sa_r = std::max(ss.right.surface_area(), 1e-20f);
    int nl = ss.n_left, nr = ss.n_right;
    for (const TriRef& r : refs) {
      if (r.box.hi[ss.axis] <= ss.pos) {
        left.push_back(r);
      } else if (r.box.lo[ss.axis] >= ss.pos) {
        right.push_back(r);
      } else {
        // Straddler: duplicate vs unsplit-left vs unsplit-right (greedy).
        AABB lb = clip_tri(r, ss.axis, bounds.lo[ss.axis], ss.pos);
        AABB rb = clip_tri(r, ss.axis, ss.pos, bounds.hi[ss.axis]);
        AABB grow_l = ss.left;
        grow_l.extend(r.box);
        AABB grow_r = ss.right;
        grow_r.extend(r.box);
        float c_dup = sa_l * nl + sa_r * nr;
        float c_ul = grow_l.surface_area() * nl + sa_r * (nr - 1);
        float c_ur = sa_l * (nl - 1) + grow_r.surface_area() * nr;
        if (c_ul < c_dup && c_ul <= c_ur && nr > 1) {
          TriRef w = r;  // whole ref goes left
          left.push_back(w);
          nr -= 1;
        } else if (c_ur < c_dup && nl > 1) {
          right.push_back(r);
          nl -= 1;
        } else {
          TriRef a = r, b = r;
          a.box = lb.valid() ? lb : r.box.intersect(slab(bounds, ss.axis, true, ss.pos));
          b.box = rb.valid() ? rb : r.box.intersect(slab(bounds, ss.axis, false, ss.pos));
          if (a.box.valid()) left.push_back(a);
          if (b.box.valid()) right.push_back(b);
        }
      }
    }
    refs.clear();
    refs.shrink_to_fit();
    if (left.empty() || right.empty()) {
      // Degenerate plane: fall back to a median split for progress.
      std::vector<TriRef> all;
      all.reserve(left.size() + right.size());
      for (auto& r : left) all.push_back(r);
      for (auto& r : right) all.push_back(r);
      return build_inner_median(std::move(all), bounds, depth);
    }
    for (auto& r : left) lbox.extend(r.box);
    for (auto& r : right) rbox.extend(r.box);
    return emit_inner(std::move(left), lbox, std::move(right), rbox, bounds,
                      depth);
  }

  static AABB slab(const AABB& b, int axis, bool keep_low, float pos) {
    AABB s = b;
    if (keep_low)
      s.hi[axis] = pos;
    else
      s.lo[axis] = pos;
    return s;
  }

  Child build_inner_median(std::vector<TriRef> refs, const AABB& bounds,
                           int depth) {
    // Arbitrary halving: always terminates, used for degenerate/deep cases
    // and for forcing the root to be inner.
    int axis = 0;
    V3 sz = bounds.size();
    if (sz.y > sz.x) axis = 1;
    if (sz.z > sz[axis]) axis = 2;
    std::nth_element(refs.begin(), refs.begin() + refs.size() / 2, refs.end(),
                     [axis](const TriRef& a, const TriRef& b) {
                       return a.box.centroid()[axis] < b.box.centroid()[axis];
                     });
    size_t mid = refs.size() / 2;
    if (mid == 0) mid = 1;
    std::vector<TriRef> left(refs.begin(), refs.begin() + mid);
    std::vector<TriRef> right(refs.begin() + mid, refs.end());
    AABB lbox, rbox;
    for (auto& r : left) lbox.extend(r.box);
    for (auto& r : right) rbox.extend(r.box);
    return emit_inner(std::move(left), lbox, std::move(right), rbox, bounds,
                      depth);
  }

  // Allocate a node slot, recurse both children, fill the slot.
  Child emit_inner(std::vector<TriRef> left, AABB lbox, std::vector<TriRef> right,
                   AABB rbox, const AABB& bounds, int depth) {
    // Depth is tracked so the host can PROVE the traversal kernels' fixed
    // stack suffices (the kernels' clamp must never fire).  The median-split
    // fallback below kSahDepthLimit is index-balanced, so depth is bounded
    // by kSahDepthLimit + ceil(log2(n)) — the Python packer asserts it
    // against STACK_DEPTH.
    if (depth > max_depth) max_depth = depth;
    int node = alloc_node();
    Child cl = build_node(std::move(left), lbox, depth + 1);
    Child cr = build_node(std::move(right), rbox, depth + 1);
    fill_node(node, cl, cr);
    return {node, 0, bounds};
  }

  Child build_inner(std::vector<TriRef> refs, AABB bounds, int depth) {
    // Root entry: force an inner node even if a leaf would be cheaper.
    if ((int)refs.size() <= kMaxLeaf) {
      return build_inner_median(std::move(refs), bounds, depth);
    }
    Child c = build_node(std::move(refs), bounds, depth);
    if (c.count != 0) {
      // build_node decided leaf at the root — wrap it in an inner node.
      int node = alloc_node();
      fill_node(node, c, {-1, -1, {}});
      return {node, 0, bounds};
    }
    return c;
  }

  Child make_leaf(const std::vector<TriRef>& refs, const AABB& bounds) {
    int start = (int)tri_order.size();
    for (const TriRef& r : refs) tri_order.push_back(r.tri);
    return {start, (int)refs.size(), bounds};
  }

  int alloc_node() {
    int idx = (int)(nodes_i.size() / 4);
    nodes_f.insert(nodes_f.end(), 12, 0.f);
    nodes_i.insert(nodes_i.end(), 4, 0);
    return idx;
  }

  void fill_node(int node, const Child& c0, const Child& c1) {
    float* f = &nodes_f[12 * node];
    int* q = &nodes_i[4 * node];
    const Child* cs[2] = {&c0, &c1};
    for (int k = 0; k < 2; ++k) {
      const Child& c = *cs[k];
      if (c.count < 0 || !c.box.valid()) {
        // Empty child: inverted box guarantees the slab test misses.
        f[6 * k + 0] = f[6 * k + 1] = f[6 * k + 2] = 1.f;
        f[6 * k + 3] = f[6 * k + 4] = f[6 * k + 5] = -1.f;
        q[2 * k] = -1;
        q[2 * k + 1] = -1;
      } else {
        f[6 * k + 0] = c.box.lo.x;
        f[6 * k + 1] = c.box.lo.y;
        f[6 * k + 2] = c.box.lo.z;
        f[6 * k + 3] = c.box.hi.x;
        f[6 * k + 4] = c.box.hi.y;
        f[6 * k + 5] = c.box.hi.z;
        q[2 * k] = c.index;
        q[2 * k + 1] = c.count;
      }
    }
  }

  const float* verts_;
  const int* tris_;
  std::vector<TriRef> refs_;
  AABB root_box_;
  float root_sa_ = 0.f;
};

}  // namespace

extern "C" {

// Build an SBVH. Returns 0 on success. Caller frees outputs with vt_free.
//   verts:   [n_verts*3] float
//   tris:    [n_tris*3] int vertex indices
// Outputs:
//   nodes_f: [n_nodes*12] two child AABBs (lo0,hi0,lo1,hi1)
//   nodes_i: [n_nodes*4]  child (ref,count) pairs; see header comment
//   order:   [n_refs] original triangle index per leaf slot (duplicates ok)
// max_depth receives the deepest inner node level (root = 0) so callers can
// verify traversal stack bounds.
int vt_build_sbvh(const float* verts, int n_verts, const int* tris, int n_tris,
                  float** nodes_f, int** nodes_i,
                  int* n_nodes, int** order, int* n_refs, int* max_depth) {
  (void)n_verts;
  if (n_tris <= 0) return 1;
  Builder b(verts, tris, n_tris);
  b.build();
  *n_nodes = (int)(b.nodes_i.size() / 4);
  *n_refs = (int)b.tri_order.size();
  *max_depth = b.max_depth;
  *nodes_f = (float*)std::malloc(b.nodes_f.size() * sizeof(float));
  *nodes_i = (int*)std::malloc(b.nodes_i.size() * sizeof(int));
  *order = (int*)std::malloc(b.tri_order.size() * sizeof(int));
  if (!*nodes_f || !*nodes_i || !*order) return 2;
  std::memcpy(*nodes_f, b.nodes_f.data(), b.nodes_f.size() * sizeof(float));
  std::memcpy(*nodes_i, b.nodes_i.data(), b.nodes_i.size() * sizeof(int));
  std::memcpy(*order, b.tri_order.data(), b.tri_order.size() * sizeof(int));
  return 0;
}

void vt_free(void* p) { std::free(p); }

}  // extern "C"
}  // namespace vtrace
