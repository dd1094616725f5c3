// Host-side mesh runtime of the scene compiler: Wavefront OBJ parsing and
// the binned-SAH BVH build whose leaf order clusters the triangles.
//
// The port's own copy of raytracer_tpu/native/mesh.cpp: the same code, so
// that the leaf order, and with it every cluster table, is the JAX
// package's bit for bit.  Built at first use with g++ into the checkout's
// build/raytracer_tpu_torch/ and loaded through ctypes
// (raytracer_tpu_torch/native.py); a failed build raises, there is no
// Python fallback.
//
// BVH: binned-SAH top-down build over triangle centroids, emitted as flat
// arrays (node AABBs + child/leaf ranges + triangle order); the compiler
// reads only the triangle order.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  V3 lo{1e30f, 1e30f, 1e30f};
  V3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const V3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  void grow(const AABB &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  float area() const {
    float dx = std::max(0.f, hi.x - lo.x);
    float dy = std::max(0.f, hi.y - lo.y);
    float dz = std::max(0.f, hi.z - lo.z);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct BuildTri {
  AABB box;
  V3 centroid;
  int32_t index;
};

struct Node {
  AABB box;
  int32_t left = -1;    // internal: index of left child (right = left + 1 is
                        // not guaranteed; stored explicitly)
  int32_t right = -1;
  int32_t first = -1;   // leaf: first triangle in the ordered list
  int32_t count = 0;    // leaf: triangle count (0 => internal)
};

constexpr int kBins = 16;
constexpr int kLeafSize = 4;

int32_t build_node(std::vector<BuildTri> &tris, int begin, int end,
                   std::vector<Node> &nodes) {
  int32_t idx = (int32_t)nodes.size();
  nodes.emplace_back();
  AABB box, cbox;
  for (int i = begin; i < end; ++i) {
    box.grow(tris[i].box);
    cbox.grow(tris[i].centroid);
  }
  nodes[idx].box = box;

  int n = end - begin;
  if (n <= kLeafSize) {
    nodes[idx].first = begin;
    nodes[idx].count = n;
    return idx;
  }

  // choose split axis = widest centroid extent
  float ex = cbox.hi.x - cbox.lo.x;
  float ey = cbox.hi.y - cbox.lo.y;
  float ez = cbox.hi.z - cbox.lo.z;
  int axis = (ex > ey && ex > ez) ? 0 : (ey > ez ? 1 : 2);
  float cmin = axis == 0 ? cbox.lo.x : axis == 1 ? cbox.lo.y : cbox.lo.z;
  float cext = axis == 0 ? ex : axis == 1 ? ey : ez;
  if (cext <= 1e-12f) {  // degenerate: split in the middle
    int mid = begin + n / 2;
    int32_t l = build_node(tris, begin, mid, nodes);
    int32_t r = build_node(tris, mid, end, nodes);
    nodes[idx].left = l;
    nodes[idx].right = r;
    return idx;
  }

  // binned SAH
  AABB bin_box[kBins];
  int bin_cnt[kBins] = {0};
  auto bin_of = [&](const BuildTri &t) {
    float c = axis == 0 ? t.centroid.x : axis == 1 ? t.centroid.y : t.centroid.z;
    int b = (int)((c - cmin) / cext * kBins);
    return std::min(std::max(b, 0), kBins - 1);
  };
  for (int i = begin; i < end; ++i) {
    int b = bin_of(tris[i]);
    bin_box[b].grow(tris[i].box);
    bin_cnt[b]++;
  }
  AABB right_box[kBins];
  AABB acc;
  for (int b = kBins - 1; b >= 0; --b) {
    acc.grow(bin_box[b]);
    right_box[b] = acc;
  }
  float best_cost = 1e30f;
  int best_split = -1;
  AABB lacc;
  int lcnt = 0;
  for (int b = 0; b < kBins - 1; ++b) {
    lacc.grow(bin_box[b]);
    lcnt += bin_cnt[b];
    int rcnt = n - lcnt;
    if (lcnt == 0 || rcnt == 0) continue;
    float cost = lacc.area() * lcnt + right_box[b + 1].area() * rcnt;
    if (cost < best_cost) {
      best_cost = cost;
      best_split = b;
    }
  }
  int mid;
  if (best_split < 0) {
    mid = begin + n / 2;
    std::nth_element(tris.begin() + begin, tris.begin() + mid,
                     tris.begin() + end, [&](const BuildTri &a, const BuildTri &b) {
                       float ca = axis == 0 ? a.centroid.x : axis == 1 ? a.centroid.y : a.centroid.z;
                       float cb = axis == 0 ? b.centroid.x : axis == 1 ? b.centroid.y : b.centroid.z;
                       return ca < cb;
                     });
  } else {
    auto it = std::partition(tris.begin() + begin, tris.begin() + end,
                             [&](const BuildTri &t) { return bin_of(t) <= best_split; });
    mid = (int)(it - tris.begin());
    if (mid == begin || mid == end) mid = begin + n / 2;
  }
  int32_t l = build_node(tris, begin, mid, nodes);
  int32_t r = build_node(tris, mid, end, nodes);
  nodes[idx].left = l;
  nodes[idx].right = r;
  return idx;
}

}  // namespace

extern "C" {

// Parse v/f records of an OBJ file.  Two-pass: count then fill.
// Returns 0 on success.  Caller owns nothing; results are written into
// buffers allocated by the caller after a sizing call.
int32_t obj_count(const char *path, int64_t *n_verts, int64_t *n_tris) {
  FILE *f = fopen(path, "r");
  if (!f) return -1;
  char *line = nullptr;
  size_t line_cap = 0;
  int64_t nv = 0, nt = 0;
  while (getline(&line, &line_cap, f) != -1) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      nv++;
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      // count polygon fan triangles
      int verts = 0;
      char *p = line + 1;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        verts++;
        while (*p && *p != ' ' && *p != '\t' && *p != '\n') p++;
      }
      if (verts >= 3) nt += verts - 2;
    }
  }
  free(line);
  fclose(f);
  *n_verts = nv;
  *n_tris = nt;
  return 0;
}

// Full OBJ parse: v/vt/vn records plus per-corner vt/vn indices for every
// fan-triangulated face (-1 where a corner carries no vt/vn).  Sizing pass:
int32_t obj_count_full(const char *path, int64_t *n_verts, int64_t *n_uvs,
                       int64_t *n_norms, int64_t *n_tris) {
  FILE *f = fopen(path, "r");
  if (!f) return -1;
  char *line = nullptr;
  size_t line_cap = 0;
  int64_t nv = 0, nvt = 0, nvn = 0, nt = 0;
  while (getline(&line, &line_cap, f) != -1) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      nv++;
    } else if (line[0] == 'v' && line[1] == 't' &&
               (line[2] == ' ' || line[2] == '\t')) {
      nvt++;
    } else if (line[0] == 'v' && line[1] == 'n' &&
               (line[2] == ' ' || line[2] == '\t')) {
      nvn++;
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      int verts = 0;
      char *p = line + 1;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        verts++;
        while (*p && *p != ' ' && *p != '\t' && *p != '\n') p++;
      }
      if (verts >= 3) nt += verts - 2;
    }
  }
  free(line);
  fclose(f);
  *n_verts = nv;
  *n_uvs = nvt;
  *n_norms = nvn;
  *n_tris = nt;
  return 0;
}

namespace {
struct Corner {
  int64_t v, t, n;
};

// Parse one `v[/vt][/vn]` face corner; negative OBJ indices are relative to
// the running counts.  Missing vt/vn become -1.
static inline Corner parse_corner(char **pp, int64_t nv, int64_t nvt,
                                  int64_t nvn) {
  char *p = *pp;
  Corner c{-1, -1, -1};
  long v = strtol(p, &p, 10);
  c.v = (v < 0) ? nv + v : v - 1;
  if (*p == '/') {
    p++;
    if (*p != '/') {
      long t = strtol(p, &p, 10);
      c.t = (t < 0) ? nvt + t : t - 1;
    }
    if (*p == '/') {
      p++;
      long n = strtol(p, &p, 10);
      c.n = (n < 0) ? nvn + n : n - 1;
    }
  }
  *pp = p;
  return c;
}
}  // namespace

// Fill pass matching obj_count_full.  uvs is (n_uvs,2); norms (n_norms,3);
// face_uv / face_n are (n_tris,3) i64 with -1 where a corner has no index.
int32_t obj_parse_full(const char *path, float *verts, float *uvs,
                       float *norms, int64_t *faces, int64_t *face_uv,
                       int64_t *face_n) {
  FILE *f = fopen(path, "r");
  if (!f) return -1;
  char *line = nullptr;
  size_t line_cap = 0;
  int64_t vi = 0, vti = 0, vni = 0, ti = 0;
  std::vector<Corner> poly;
  while (getline(&line, &line_cap, f) != -1) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      double x, y, z;
      if (sscanf(line + 1, "%lf %lf %lf", &x, &y, &z) == 3) {
        verts[vi * 3 + 0] = (float)x;
        verts[vi * 3 + 1] = (float)y;
        verts[vi * 3 + 2] = (float)z;
        vi++;
      }
    } else if (line[0] == 'v' && line[1] == 't' &&
               (line[2] == ' ' || line[2] == '\t')) {
      double u, v;
      if (sscanf(line + 2, "%lf %lf", &u, &v) == 2) {
        uvs[vti * 2 + 0] = (float)u;
        uvs[vti * 2 + 1] = (float)v;
        vti++;
      }
    } else if (line[0] == 'v' && line[1] == 'n' &&
               (line[2] == ' ' || line[2] == '\t')) {
      double x, y, z;
      if (sscanf(line + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        norms[vni * 3 + 0] = (float)x;
        norms[vni * 3 + 1] = (float)y;
        norms[vni * 3 + 2] = (float)z;
        vni++;
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      poly.clear();
      char *p = line + 1;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        poly.push_back(parse_corner(&p, vi, vti, vni));
        while (*p && *p != ' ' && *p != '\t' && *p != '\n') p++;
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k) {
        const Corner cs[3] = {poly[0], poly[k], poly[k + 1]};
        for (int j = 0; j < 3; ++j) {
          faces[ti * 3 + j] = cs[j].v;
          face_uv[ti * 3 + j] = cs[j].t;
          face_n[ti * 3 + j] = cs[j].n;
        }
        ti++;
      }
    }
  }
  free(line);
  fclose(f);
  return 0;
}

int32_t obj_parse(const char *path, float *verts /* (n_verts,3) */,
                  int64_t *faces /* (n_tris,3) */) {
  FILE *f = fopen(path, "r");
  if (!f) return -1;
  char *line = nullptr;
  size_t line_cap = 0;
  int64_t vi = 0, ti = 0;
  std::vector<int64_t> poly;
  while (getline(&line, &line_cap, f) != -1) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      double x, y, z;
      if (sscanf(line + 1, "%lf %lf %lf", &x, &y, &z) == 3) {
        verts[vi * 3 + 0] = (float)x;
        verts[vi * 3 + 1] = (float)y;
        verts[vi * 3 + 2] = (float)z;
        vi++;
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      poly.clear();
      char *p = line + 1;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        long v = strtol(p, &p, 10);
        if (v < 0) v = vi + v + 1;  // negative OBJ indices are relative
        poly.push_back(v - 1);
        while (*p && *p != ' ' && *p != '\t' && *p != '\n') p++;
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k) {
        faces[ti * 3 + 0] = poly[0];
        faces[ti * 3 + 1] = poly[k];
        faces[ti * 3 + 2] = poly[k + 1];
        ti++;
      }
    }
  }
  free(line);
  fclose(f);
  return 0;
}

// Build a binned-SAH BVH over triangles given as (n, 3, 3) float vertices.
// Sizing: the node count is at most 2n.  Outputs (caller-allocated):
//   bbox_lo, bbox_hi: (max_nodes, 3) f32
//   left, right, first, count: (max_nodes,) i32
//   order: (n,) i32 triangle permutation (leaf ranges index into this)
// Returns the number of nodes written, or -1 on error.
int32_t bvh_build(const float *tri_verts, int64_t n, float *bbox_lo,
                  float *bbox_hi, int32_t *left, int32_t *right,
                  int32_t *first, int32_t *count, int32_t *order) {
  if (n <= 0) return -1;
  std::vector<BuildTri> tris((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    const float *t = tri_verts + i * 9;
    AABB b;
    b.grow(V3{t[0], t[1], t[2]});
    b.grow(V3{t[3], t[4], t[5]});
    b.grow(V3{t[6], t[7], t[8]});
    tris[i].box = b;
    tris[i].centroid = {(t[0] + t[3] + t[6]) / 3.f, (t[1] + t[4] + t[7]) / 3.f,
                        (t[2] + t[5] + t[8]) / 3.f};
    tris[i].index = (int32_t)i;
  }
  std::vector<Node> nodes;
  nodes.reserve((size_t)(2 * n));
  build_node(tris, 0, (int)n, nodes);
  for (size_t i = 0; i < nodes.size(); ++i) {
    bbox_lo[i * 3 + 0] = nodes[i].box.lo.x;
    bbox_lo[i * 3 + 1] = nodes[i].box.lo.y;
    bbox_lo[i * 3 + 2] = nodes[i].box.lo.z;
    bbox_hi[i * 3 + 0] = nodes[i].box.hi.x;
    bbox_hi[i * 3 + 1] = nodes[i].box.hi.y;
    bbox_hi[i * 3 + 2] = nodes[i].box.hi.z;
    left[i] = nodes[i].left;
    right[i] = nodes[i].right;
    first[i] = nodes[i].first;
    count[i] = nodes[i].count;
  }
  for (int64_t i = 0; i < n; ++i) order[i] = tris[i].index;
  return (int32_t)nodes.size();
}

}  // extern "C"
