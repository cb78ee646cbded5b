// Fast OBJ parser — the native data-loading path (the JAX package's
// native/objparse.cpp, copied unchanged below this comment).
//
// For large meshes (ShapeNet models run to 50k+ faces) Python-side line
// parsing dominates scene setup.  This parser reads the whole file once and
// scans it with branchy-but-tight C++: vertices/uvs/normals into flat float
// arrays, faces (fan-triangulated) into int32 index triples for v/vt/vn.
//
// Exposed through a tiny C ABI consumed via ctypes
// (pertrenderer_tpu_torch/native/__init__.py), which builds it with g++ at
// first use into pertrenderer_tpu_torch/_build/.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Buffer {
  std::vector<float> verts;     // 3 per vertex
  std::vector<float> uvs;      // 2 per uv
  std::vector<float> normals;  // 3 per normal
  std::vector<int> faces_v;    // 3 per face
  std::vector<int> faces_t;    // 3 per face (-1 if absent)
  std::vector<int> faces_n;    // 3 per face (-1 if absent)
  std::string mtl;
};

// Parse up to `n` whitespace-separated floats starting at p.
inline const char* parse_floats(const char* p, float* out, int n, int* got) {
  *got = 0;
  for (int i = 0; i < n; ++i) {
    char* end = nullptr;
    float v = strtof(p, &end);
    if (end == p) break;
    out[i] = v;
    *got += 1;
    p = end;
  }
  return p;
}

// Parse one face corner "v", "v/t", "v//n", "v/t/n" (1-based, may be
// negative = relative).  Returns pointer past the token.
inline const char* parse_corner(const char* p, int counts[3], int idx[3]) {
  idx[0] = idx[1] = idx[2] = -1;
  for (int slot = 0; slot < 3; ++slot) {
    char* end = nullptr;
    long v = strtol(p, &end, 10);
    if (end != p) {
      // OBJ indices are 1-based; negative indices count from the end.
      idx[slot] = v > 0 ? static_cast<int>(v - 1)
                        : static_cast<int>(counts[slot] + v);
      p = end;
    }
    if (*p == '/') {
      ++p;
      continue;
    }
    break;
  }
  return p;
}

}  // namespace

extern "C" {

struct ObjData {
  float* verts;
  long n_verts;
  float* uvs;
  long n_uvs;
  float* normals;
  long n_normals;
  int* faces_v;
  int* faces_t;
  int* faces_n;
  long n_faces;
  char mtl[1024];
};

ObjData* obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> data(size + 1);
  if (fread(data.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  data[size] = '\0';

  Buffer buf;
  buf.verts.reserve(1 << 16);
  buf.faces_v.reserve(1 << 17);

  const char* p = data.data();
  const char* end = p + size;
  while (p < end) {
    // skip leading spaces
    while (*p == ' ' || *p == '\t') ++p;
    if (*p == 'v' && p[1] == ' ') {
      float v[3] = {0, 0, 0};
      int got;
      p = parse_floats(p + 2, v, 3, &got);
      buf.verts.insert(buf.verts.end(), v, v + 3);
    } else if (*p == 'v' && p[1] == 't' && p[2] == ' ') {
      float v[2] = {0, 0};
      int got;
      p = parse_floats(p + 3, v, 2, &got);
      buf.uvs.insert(buf.uvs.end(), v, v + 2);
    } else if (*p == 'v' && p[1] == 'n' && p[2] == ' ') {
      float v[3] = {0, 0, 0};
      int got;
      p = parse_floats(p + 3, v, 3, &got);
      buf.normals.insert(buf.normals.end(), v, v + 3);
    } else if (*p == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      int counts[3] = {static_cast<int>(buf.verts.size() / 3),
                       static_cast<int>(buf.uvs.size() / 2),
                       static_cast<int>(buf.normals.size() / 3)};
      int first[3], prev[3], cur[3];
      int n_corners = 0;
      while (p < end && *p != '\n' && *p != '\r' && *p != '#') {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\n' || *p == '\r' || *p == '#' || p >= end) break;
        const char* before = p;
        p = parse_corner(p, counts, cur);
        if (p == before) break;  // no progress: malformed token
        if (n_corners == 0) {
          memcpy(first, cur, sizeof(cur));
        } else if (n_corners >= 2) {
          // fan triangulation: (first, prev, cur)
          buf.faces_v.push_back(first[0]);
          buf.faces_v.push_back(prev[0]);
          buf.faces_v.push_back(cur[0]);
          buf.faces_t.push_back(first[1]);
          buf.faces_t.push_back(prev[1]);
          buf.faces_t.push_back(cur[1]);
          buf.faces_n.push_back(first[2]);
          buf.faces_n.push_back(prev[2]);
          buf.faces_n.push_back(cur[2]);
        }
        memcpy(prev, cur, sizeof(cur));
        ++n_corners;
      }
    } else if (strncmp(p, "mtllib", 6) == 0) {
      p += 6;
      while (*p == ' ' || *p == '\t') ++p;
      const char* start = p;
      while (p < end && *p != '\n' && *p != '\r' && *p != ' ') ++p;
      buf.mtl.assign(start, p - start);
    }
    // advance to next line
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }

  ObjData* out = new ObjData();
  out->n_verts = static_cast<long>(buf.verts.size() / 3);
  out->n_uvs = static_cast<long>(buf.uvs.size() / 2);
  out->n_normals = static_cast<long>(buf.normals.size() / 3);
  out->n_faces = static_cast<long>(buf.faces_v.size() / 3);

  auto copy_f = [](const std::vector<float>& v) {
    float* a = static_cast<float*>(malloc(v.size() * sizeof(float)));
    memcpy(a, v.data(), v.size() * sizeof(float));
    return a;
  };
  auto copy_i = [](const std::vector<int>& v) {
    int* a = static_cast<int*>(malloc(v.size() * sizeof(int)));
    memcpy(a, v.data(), v.size() * sizeof(int));
    return a;
  };
  out->verts = copy_f(buf.verts);
  out->uvs = copy_f(buf.uvs);
  out->normals = copy_f(buf.normals);
  out->faces_v = copy_i(buf.faces_v);
  out->faces_t = copy_i(buf.faces_t);
  out->faces_n = copy_i(buf.faces_n);
  snprintf(out->mtl, sizeof(out->mtl), "%s", buf.mtl.c_str());
  return out;
}

void obj_free(ObjData* d) {
  if (!d) return;
  free(d->verts);
  free(d->uvs);
  free(d->normals);
  free(d->faces_v);
  free(d->faces_t);
  free(d->faces_n);
  delete d;
}

}  // extern "C"
