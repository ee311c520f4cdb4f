// Host-native asset loaders: Wavefront OBJ meshes and MERL-100 BRDF tables.
//
// Counterparts of the reference's Assimp-based mesh import
// (src/MeshLoader.cpp:15-97) and MERL binary reader
// (src/BRDFLoader.cpp:15-50), re-implemented without third-party deps.
// Behavioral parity notes:
//   * vertices are re-centered at the mesh centroid (MeshLoader.cpp:50-60);
//   * the v texture coordinate is flipped (v -> 1-v, MeshLoader.cpp:74);
//   * smooth per-vertex normals are generated when the OBJ lacks them
//     (Assimp aiProcess_GenSmoothNormals equivalent);
//   * per-vertex tangents are derived from UVs (aiProcess_CalcTangentSpace
//     equivalent: Lengyel's method, orthogonalized against the normal);
//   * MERL: 3 int32 dims (90*90*180 checked), then 3n float64 -> float32.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "math3.h"

namespace vtrace {
namespace {

struct ObjIndex {
  int v = -1, vt = -1, vn = -1;
  bool operator==(const ObjIndex& o) const {
    return v == o.v && vt == o.vt && vn == o.vn;
  }
};

struct ObjIndexHash {
  size_t operator()(const ObjIndex& k) const {
    return ((size_t)k.v * 73856093u) ^ ((size_t)k.vt * 19349663u) ^
           ((size_t)k.vn * 83492791u);
  }
};

// Parse "v/vt/vn", "v//vn", "v/vt", or "v" (1-based; negatives relative).
ObjIndex parse_corner(const char* s, int nv, int nvt, int nvn) {
  ObjIndex ix;
  int vals[3] = {0, 0, 0};
  int slot = 0;
  const char* p = s;
  while (*p && slot < 3) {
    if (*p == '/') {
      ++slot;
      ++p;
      continue;
    }
    char* end;
    vals[slot] = (int)strtol(p, &end, 10);
    p = end;
  }
  auto fix = [](int i, int n) { return i > 0 ? i - 1 : (i < 0 ? n + i : -1); };
  ix.v = fix(vals[0], nv);
  ix.vt = fix(vals[1], nvt);
  ix.vn = fix(vals[2], nvn);
  return ix;
}

}  // namespace

// Lengyel tangents: accumulate the UV-space u-direction per vertex, then
// Gram-Schmidt against the normal (shared by the OBJ/PLY/FBX loaders —
// fbx.cc links against these, hence external C++ linkage).
void compute_tangents_shared(const std::vector<V3>& V, const std::vector<V3>& N,
                             const std::vector<float>& UV,
                             const std::vector<int>& tri_idx,
                             std::vector<V3>* T) {
  const int nv = (int)V.size();
  const int nt = (int)(tri_idx.size() / 3);
  T->assign(nv, V3{0, 0, 0});
  for (int t = 0; t < nt; ++t) {
    int i0 = tri_idx[3 * t], i1 = tri_idx[3 * t + 1], i2 = tri_idx[3 * t + 2];
    V3 e1 = V[i1] - V[i0], e2 = V[i2] - V[i0];
    float du1 = UV[2 * i1] - UV[2 * i0], dv1 = UV[2 * i1 + 1] - UV[2 * i0 + 1];
    float du2 = UV[2 * i2] - UV[2 * i0], dv2 = UV[2 * i2 + 1] - UV[2 * i0 + 1];
    float det = du1 * dv2 - du2 * dv1;
    V3 tan;
    if (std::fabs(det) > 1e-20f) {
      float r = 1.f / det;
      tan = (e1 * dv2 - e2 * dv1) * r;
    } else {
      tan = e1;  // degenerate UVs: any edge direction
    }
    (*T)[i0] = (*T)[i0] + tan;
    (*T)[i1] = (*T)[i1] + tan;
    (*T)[i2] = (*T)[i2] + tan;
  }
  for (int i = 0; i < nv; ++i) {
    V3 n = N[i];
    V3 t = (*T)[i] - n * dot(n, (*T)[i]);
    float l = length(t);
    if (l > 1e-12f) {
      (*T)[i] = t * (1.f / l);
    } else {
      V3 h = std::fabs(n.x) < 0.9f ? V3{1, 0, 0} : V3{0, 1, 0};
      (*T)[i] = normalize(cross(h, n));
    }
  }
}

float* alloc_v3_shared(const std::vector<V3>& src) {
  float* p = (float*)std::malloc(sizeof(float) * 3 * src.size());
  if (!p) return nullptr;
  for (size_t i = 0; i < src.size(); ++i) {
    p[3 * i] = src[i].x;
    p[3 * i + 1] = src[i].y;
    p[3 * i + 2] = src[i].z;
  }
  return p;
}

namespace {
constexpr auto* compute_tangents = compute_tangents_shared;
constexpr auto* alloc_v3 = alloc_v3_shared;
}  // namespace

extern "C" {

// Load an OBJ file: triangulated, indexed, centered at the centroid, with
// normals/tangents/uvs per unique (v,vt,vn) corner. Returns 0 on success.
// All outputs are malloc'd; caller frees with vt_free.
int vt_load_obj(const char* path, float** out_verts, float** out_normals,
                float** out_tangents, float** out_uvs, int* out_n_verts,
                int** out_tris, int* out_n_tris) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  std::vector<V3> pos, nrm;
  std::vector<float> uv;  // pairs
  std::vector<ObjIndex> corners;  // 3 per triangle
  char line[4096];
  while (std::fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      V3 p;
      if (std::sscanf(line + 2, "%f %f %f", &p.x, &p.y, &p.z) == 3)
        pos.push_back(p);
    } else if (line[0] == 'v' && line[1] == 'n') {
      V3 p;
      if (std::sscanf(line + 3, "%f %f %f", &p.x, &p.y, &p.z) == 3)
        nrm.push_back(p);
    } else if (line[0] == 'v' && line[1] == 't') {
      float u = 0, v = 0;
      if (std::sscanf(line + 3, "%f %f", &u, &v) >= 1) {
        uv.push_back(u);
        uv.push_back(v);
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      // Triangulate the polygon as a fan.
      std::vector<ObjIndex> poly;
      char* save = nullptr;
      for (char* tok = strtok_r(line + 2, " \t\r\n", &save); tok;
           tok = strtok_r(nullptr, " \t\r\n", &save)) {
        poly.push_back(parse_corner(tok, (int)pos.size(), (int)(uv.size() / 2),
                                    (int)nrm.size()));
      }
      for (size_t i = 2; i < poly.size(); ++i) {
        corners.push_back(poly[0]);
        corners.push_back(poly[i - 1]);
        corners.push_back(poly[i]);
      }
    }
  }
  std::fclose(f);
  if (pos.empty() || corners.empty()) return 2;

  // Re-center at the centroid of referenced positions (reference behavior).
  V3 centroid{0, 0, 0};
  for (const V3& p : pos) centroid = centroid + p;
  centroid = centroid * (1.f / (float)pos.size());
  for (V3& p : pos) p = p - centroid;

  // Deduplicate (v,vt,vn) corners into unique output vertices.
  std::unordered_map<ObjIndex, int, ObjIndexHash> remap;
  std::vector<int> tri_idx;
  std::vector<ObjIndex> uniq;
  tri_idx.reserve(corners.size());
  for (const ObjIndex& c : corners) {
    auto it = remap.find(c);
    int idx;
    if (it == remap.end()) {
      idx = (int)uniq.size();
      remap.emplace(c, idx);
      uniq.push_back(c);
    } else {
      idx = it->second;
    }
    tri_idx.push_back(idx);
  }
  const int nv = (int)uniq.size();
  const int nt = (int)(tri_idx.size() / 3);

  std::vector<V3> V(nv), N(nv, V3{0, 0, 0}), T(nv, V3{0, 0, 0});
  std::vector<float> UV(2 * nv, 0.f);
  bool any_missing_normal = false;
  for (int i = 0; i < nv; ++i) {
    const ObjIndex& c = uniq[i];
    V[i] = (c.v >= 0 && c.v < (int)pos.size()) ? pos[c.v] : V3{0, 0, 0};
    if (c.vn >= 0 && c.vn < (int)nrm.size())
      N[i] = nrm[c.vn];
    else
      any_missing_normal = true;
    if (c.vt >= 0 && 2 * c.vt + 1 < (int)uv.size()) {
      UV[2 * i] = uv[2 * c.vt];
      UV[2 * i + 1] = 1.f - uv[2 * c.vt + 1];  // reference v-flip
    }
  }

  if (any_missing_normal) {
    // Area-weighted smooth normals over the shared-position graph.
    std::vector<V3> acc(pos.size(), V3{0, 0, 0});
    for (int t = 0; t < nt; ++t) {
      const ObjIndex &a = uniq[tri_idx[3 * t]], &b = uniq[tri_idx[3 * t + 1]],
                     &c = uniq[tri_idx[3 * t + 2]];
      V3 fn = cross(pos[b.v] - pos[a.v], pos[c.v] - pos[a.v]);
      acc[a.v] = acc[a.v] + fn;
      acc[b.v] = acc[b.v] + fn;
      acc[c.v] = acc[c.v] + fn;
    }
    for (int i = 0; i < nv; ++i)
      if (uniq[i].vn < 0) N[i] = normalize(acc[uniq[i].v]);
  }

  compute_tangents(V, N, UV, tri_idx, &T);

  *out_verts = alloc_v3(V);
  *out_normals = alloc_v3(N);
  *out_tangents = alloc_v3(T);
  *out_uvs = (float*)std::malloc(sizeof(float) * UV.size());
  std::memcpy(*out_uvs, UV.data(), sizeof(float) * UV.size());
  *out_tris = (int*)std::malloc(sizeof(int) * tri_idx.size());
  std::memcpy(*out_tris, tri_idx.data(), sizeof(int) * tri_idx.size());
  *out_n_verts = nv;
  *out_n_tris = nt;
  return 0;
}

// Load a PLY file (ascii or binary_little_endian, version 1.0): positions,
// optional per-vertex normals (nx/ny/nz) and UVs (u/v, s/t or
// texture_u/texture_v), faces fan-triangulated.  Same post-processing
// contract as vt_load_obj: centroid recentering, v-flip, smooth normals
// when absent, Lengyel tangents.  The reference reads PLY through Assimp
// into the identical pipeline (src/MeshLoader.cpp:19, NGLScene.cpp:348).
// Returns 0 ok, 1 open failure, 2 empty/invalid, 3 unsupported format.
int vt_load_ply(const char* path, float** out_verts, float** out_normals,
                float** out_tangents, float** out_uvs, int* out_n_verts,
                int** out_tris, int* out_n_tris) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  char line[4096];
  if (!std::fgets(line, sizeof(line), f) || std::strncmp(line, "ply", 3)) {
    std::fclose(f);
    return 3;
  }

  enum Type { T_I8, T_U8, T_I16, T_U16, T_I32, T_U32, T_F32, T_F64, T_BAD };
  auto parse_type = [](const std::string& s) -> Type {
    if (s == "char" || s == "int8") return T_I8;
    if (s == "uchar" || s == "uint8") return T_U8;
    if (s == "short" || s == "int16") return T_I16;
    if (s == "ushort" || s == "uint16") return T_U16;
    if (s == "int" || s == "int32") return T_I32;
    if (s == "uint" || s == "uint32") return T_U32;
    if (s == "float" || s == "float32") return T_F32;
    if (s == "double" || s == "float64") return T_F64;
    return T_BAD;
  };
  auto type_size = [](Type t) -> int {
    switch (t) {
      case T_I8: case T_U8: return 1;
      case T_I16: case T_U16: return 2;
      case T_I32: case T_U32: case T_F32: return 4;
      case T_F64: return 8;
      default: return 0;
    }
  };

  struct Prop { Type type; Type list_count_type; bool is_list; std::string name; };
  struct Elem { std::string name; long count; std::vector<Prop> props; };
  std::vector<Elem> elems;
  bool binary = false, ascii = false;
  bool header_done = false;
  while (std::fgets(line, sizeof(line), f)) {
    char w0[64] = {0}, w1[64] = {0}, w2[64] = {0}, w3[64] = {0}, w4[64] = {0};
    int nw = std::sscanf(line, "%63s %63s %63s %63s %63s", w0, w1, w2, w3, w4);
    if (nw < 1) continue;
    std::string k(w0);
    if (k == "comment" || k == "obj_info") continue;
    if (k == "format") {
      std::string fmt(w1);
      if (fmt == "ascii") ascii = true;
      else if (fmt == "binary_little_endian") binary = true;
      else { std::fclose(f); return 3; }  // big endian unsupported
    } else if (k == "element" && nw >= 3) {
      elems.push_back({std::string(w1), std::atol(w2), {}});
    } else if (k == "property" && !elems.empty()) {
      Prop p{};
      if (std::string(w1) == "list" && nw >= 5) {
        p.is_list = true;
        p.list_count_type = parse_type(w2);
        p.type = parse_type(w3);
        p.name = w4;
      } else if (nw >= 3) {
        p.is_list = false;
        p.type = parse_type(w1);
        p.name = w2;
      }
      if (p.type == T_BAD) { std::fclose(f); return 3; }
      elems.back().props.push_back(p);
    } else if (k == "end_header") {
      header_done = true;
      break;
    }
  }
  if (!header_done || (!ascii && !binary)) { std::fclose(f); return 3; }

  auto read_scalar = [&](Type t, double* out) -> bool {
    if (ascii) {
      // ascii values are whitespace separated across lines
      return std::fscanf(f, "%lf", out) == 1;
    }
    unsigned char buf[8];
    if (std::fread(buf, 1, type_size(t), f) != (size_t)type_size(t))
      return false;
    switch (t) {
      case T_I8:  *out = (double)(int8_t)buf[0]; break;
      case T_U8:  *out = (double)buf[0]; break;
      case T_I16: { int16_t v; std::memcpy(&v, buf, 2); *out = v; break; }
      case T_U16: { uint16_t v; std::memcpy(&v, buf, 2); *out = v; break; }
      case T_I32: { int32_t v; std::memcpy(&v, buf, 4); *out = v; break; }
      case T_U32: { uint32_t v; std::memcpy(&v, buf, 4); *out = v; break; }
      case T_F32: { float v; std::memcpy(&v, buf, 4); *out = v; break; }
      case T_F64: { double v; std::memcpy(&v, buf, 8); *out = v; break; }
      default: return false;
    }
    return true;
  };

  std::vector<V3> V, N;
  std::vector<float> UV;
  std::vector<int> tri_idx;
  bool has_normals = false, has_uvs = false;

  for (const Elem& e : elems) {
    if (e.name == "vertex") {
      V.reserve(e.count);
      int ix = -1, iy = -1, iz = -1, inx = -1, iny = -1, inz = -1,
          iu = -1, iv = -1;
      for (size_t i = 0; i < e.props.size(); ++i) {
        const std::string& n = e.props[i].name;
        if (n == "x") ix = (int)i;
        else if (n == "y") iy = (int)i;
        else if (n == "z") iz = (int)i;
        else if (n == "nx") inx = (int)i;
        else if (n == "ny") iny = (int)i;
        else if (n == "nz") inz = (int)i;
        else if (n == "u" || n == "s" || n == "texture_u") iu = (int)i;
        else if (n == "v" || n == "t" || n == "texture_v") iv = (int)i;
      }
      if (ix < 0 || iy < 0 || iz < 0) { std::fclose(f); return 3; }
      has_normals = inx >= 0 && iny >= 0 && inz >= 0;
      has_uvs = iu >= 0 && iv >= 0;
      std::vector<double> vals(e.props.size());
      for (long r = 0; r < e.count; ++r) {
        for (size_t i = 0; i < e.props.size(); ++i) {
          if (e.props[i].is_list) {  // unexpected on vertices: skip
            double cnt;
            if (!read_scalar(e.props[i].list_count_type, &cnt)) {
              std::fclose(f); return 2;
            }
            double dummy;
            for (int j = 0; j < (int)cnt; ++j)
              if (!read_scalar(e.props[i].type, &dummy)) {
                std::fclose(f); return 2;
              }
            vals[i] = 0;
          } else if (!read_scalar(e.props[i].type, &vals[i])) {
            std::fclose(f); return 2;
          }
        }
        V.push_back({(float)vals[ix], (float)vals[iy], (float)vals[iz]});
        if (has_normals)
          N.push_back({(float)vals[inx], (float)vals[iny], (float)vals[inz]});
        if (has_uvs) {
          UV.push_back((float)vals[iu]);
          UV.push_back(1.f - (float)vals[iv]);  // reference v-flip
        }
      }
    } else if (e.name == "face") {
      for (long r = 0; r < e.count; ++r) {
        for (size_t i = 0; i < e.props.size(); ++i) {
          const Prop& p = e.props[i];
          if (p.is_list && (p.name == "vertex_indices" ||
                            p.name == "vertex_index")) {
            double cnt;
            if (!read_scalar(p.list_count_type, &cnt)) {
              std::fclose(f); return 2;
            }
            std::vector<int> poly((int)cnt);
            for (int j = 0; j < (int)cnt; ++j) {
              double v;
              if (!read_scalar(p.type, &v)) { std::fclose(f); return 2; }
              poly[j] = (int)v;
            }
            for (size_t j = 2; j < poly.size(); ++j) {
              tri_idx.push_back(poly[0]);
              tri_idx.push_back(poly[j - 1]);
              tri_idx.push_back(poly[j]);
            }
          } else if (p.is_list) {
            double cnt;
            if (!read_scalar(p.list_count_type, &cnt)) {
              std::fclose(f); return 2;
            }
            double dummy;
            for (int j = 0; j < (int)cnt; ++j)
              if (!read_scalar(p.type, &dummy)) { std::fclose(f); return 2; }
          } else {
            double dummy;
            if (!read_scalar(p.type, &dummy)) { std::fclose(f); return 2; }
          }
        }
      }
    } else {
      // Unknown element: consume its rows (ascii: whole lines won't work
      // after fscanf tokenizing, so parse per property; binary likewise).
      for (long r = 0; r < e.count; ++r) {
        for (size_t i = 0; i < e.props.size(); ++i) {
          const Prop& p = e.props[i];
          double cnt = 1, dummy;
          if (p.is_list) {
            if (!read_scalar(p.list_count_type, &cnt)) {
              std::fclose(f); return 2;
            }
          }
          for (int j = 0; j < (int)cnt; ++j)
            if (!read_scalar(p.type, &dummy)) { std::fclose(f); return 2; }
        }
      }
    }
  }
  std::fclose(f);

  const int nv = (int)V.size();
  const int nt = (int)(tri_idx.size() / 3);
  if (nv == 0 || nt == 0) return 2;
  for (int i = 0; i < nt * 3; ++i)
    if (tri_idx[i] < 0 || tri_idx[i] >= nv) return 2;

  // Centroid recentering (reference MeshLoader.cpp:50-60).
  V3 centroid{0, 0, 0};
  for (const V3& p : V) centroid = centroid + p;
  centroid = centroid * (1.f / (float)nv);
  for (V3& p : V) p = p - centroid;

  if (!has_normals) {
    // Area-weighted smooth normals (vertices are already shared).
    N.assign(nv, V3{0, 0, 0});
    for (int t = 0; t < nt; ++t) {
      int a = tri_idx[3 * t], b = tri_idx[3 * t + 1], c = tri_idx[3 * t + 2];
      V3 fn = cross(V[b] - V[a], V[c] - V[a]);
      N[a] = N[a] + fn;
      N[b] = N[b] + fn;
      N[c] = N[c] + fn;
    }
    for (int i = 0; i < nv; ++i) N[i] = normalize(N[i]);
  }
  if (!has_uvs) UV.assign(2 * nv, 0.f);

  std::vector<V3> T;
  compute_tangents(V, N, UV, tri_idx, &T);

  *out_verts = alloc_v3(V);
  *out_normals = alloc_v3(N);
  *out_tangents = alloc_v3(T);
  *out_uvs = (float*)std::malloc(sizeof(float) * UV.size());
  std::memcpy(*out_uvs, UV.data(), sizeof(float) * UV.size());
  *out_tris = (int*)std::malloc(sizeof(int) * tri_idx.size());
  std::memcpy(*out_tris, tri_idx.data(), sizeof(int) * tri_idx.size());
  *out_n_verts = nv;
  *out_n_tris = nt;
  return 0;
}

// MERL-100 binary: dims (3 x int32, product must be 90*90*180), then
// 3*n float64 values -> float32 buffer of length 3*n (layout unchanged:
// the three color planes are consecutive, each n long).
int vt_load_merl(const char* path, float** out_data, int* out_n) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  int32_t dims[3];
  if (std::fread(dims, sizeof(int32_t), 3, f) != 3) {
    std::fclose(f);
    return 2;
  }
  int64_t n = (int64_t)dims[0] * dims[1] * dims[2];
  if (n != 90 * 90 * 180) {
    std::fclose(f);
    return 3;
  }
  std::vector<double> raw(3 * n);
  if (std::fread(raw.data(), sizeof(double), raw.size(), f) != raw.size()) {
    std::fclose(f);
    return 4;
  }
  std::fclose(f);
  *out_data = (float*)std::malloc(sizeof(float) * 3 * n);
  for (int64_t i = 0; i < 3 * n; ++i) (*out_data)[i] = (float)raw[i];
  *out_n = (int)n;
  return 0;
}

}  // extern "C"
}  // namespace vtrace
