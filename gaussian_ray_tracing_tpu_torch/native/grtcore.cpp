// grtcore: native host-runtime core of the gaussian ray tracer (the
// PyTorch port's copy of gaussian_ray_tracing_tpu/native/grtcore.cpp).
//
// The counterpart of the reference's C++ host runtime pieces that are
// genuinely hot on the host side: trained-PLY parsing (the reference's
// happly-based loader, src/GaussianData.cpp:20-131, is a per-particle CPU
// loop), OBJ parsing (tinyobjloader, src/geometry/Primitives.cpp:142-202),
// and Morton-code + radix argsort used for spatial partitioning of scenes
// before they are handed to the device. Exposed through a plain C ABI and
// loaded from Python via ctypes (see bindings.py); every entry point has a
// pure-NumPy fallback so the framework runs without the shared library.
//
// Build: bindings.py compiles it with g++ at first use into build/native/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PLY (binary_little_endian, all-float32 vertex element — the 3DGS layout)
// ---------------------------------------------------------------------------

// Parses the header. Returns 0 on success, negative error codes otherwise.
//   out_count:    number of vertices
//   out_n_props:  number of float properties
//   names_buf:    '\n'-separated property names (truncated to names_cap)
//   out_data_off: byte offset where binary data starts
// Fails (-2) if any vertex property is not float32 or the format is not
// binary_little_endian (caller falls back to the Python reader).
int grt_ply_header(const char* path, int64_t* out_count, int32_t* out_n_props,
                   char* names_buf, int64_t names_cap, int64_t* out_data_off) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[4096];
  if (!std::fgets(line, sizeof line, f) || std::strncmp(line, "ply", 3) != 0) {
    std::fclose(f);
    return -2;
  }
  bool in_vertex = false, binary_le = false;
  int64_t count = 0;
  std::string names;
  int32_t n_props = 0;
  while (std::fgets(line, sizeof line, f)) {
    char a[256] = {0}, b[256] = {0}, c[256] = {0};
    long long v = 0;
    if (std::sscanf(line, "%255s", a) != 1) continue;
    if (std::strcmp(a, "format") == 0) {
      std::sscanf(line, "%*s %255s", b);
      binary_le = std::strcmp(b, "binary_little_endian") == 0;
    } else if (std::strcmp(a, "element") == 0) {
      std::sscanf(line, "%*s %255s %lld", b, &v);
      in_vertex = std::strcmp(b, "vertex") == 0;
      if (in_vertex) count = (int64_t)v;
    } else if (std::strcmp(a, "property") == 0 && in_vertex) {
      std::sscanf(line, "%*s %255s %255s", b, c);
      if (std::strcmp(b, "float") != 0 && std::strcmp(b, "float32") != 0) {
        std::fclose(f);
        return -2;
      }
      if (!names.empty()) names += '\n';
      names += c;
      n_props++;
    } else if (std::strcmp(a, "end_header") == 0) {
      break;
    }
  }
  if (!binary_le || count <= 0 || n_props <= 0) {
    std::fclose(f);
    return -2;
  }
  *out_data_off = std::ftell(f);
  *out_count = count;
  *out_n_props = n_props;
  if ((int64_t)names.size() + 1 > names_cap) {
    std::fclose(f);
    return -3;
  }
  std::memcpy(names_buf, names.c_str(), names.size() + 1);
  std::fclose(f);
  return 0;
}

// Reads the binary block into out (count * n_props float32, row-major).
int grt_ply_read(const char* path, int64_t data_off, float* out, int64_t count,
                 int32_t n_props) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, (long)data_off, SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  size_t want = (size_t)count * (size_t)n_props;
  size_t got = std::fread(out, sizeof(float), want, f);
  std::fclose(f);
  return got == want ? 0 : -4;
}

// Writes a binary_little_endian PLY with the given '\n'-separated float
// property names and row-major float32 data.
int grt_ply_write(const char* path, const char* names, const float* data,
                  int64_t count, int32_t n_props) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "ply\nformat binary_little_endian 1.0\nelement vertex %lld\n",
               (long long)count);
  std::string s(names);
  size_t start = 0;
  while (start <= s.size()) {
    size_t end = s.find('\n', start);
    if (end == std::string::npos) end = s.size();
    if (end > start)
      std::fprintf(f, "property float %s\n", s.substr(start, end - start).c_str());
    start = end + 1;
  }
  std::fprintf(f, "end_header\n");
  size_t want = (size_t)count * (size_t)n_props;
  size_t put = std::fwrite(data, sizeof(float), want, f);
  std::fclose(f);
  return put == want ? 0 : -4;
}

// ---------------------------------------------------------------------------
// OBJ (v / vn / f, fan triangulation, reference Y-flip)
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<float> verts;   // 9 per tri
  std::vector<float> norms;   // 9 per tri
};

static int obj_parse(const char* path, ObjData& out, int y_flip) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  std::vector<float> vs, ns;
  char line[8192];
  const float yf = y_flip ? -1.f : 1.f;
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      float x, y, z;
      if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        vs.push_back(x);
        vs.push_back(yf * y);
        vs.push_back(z);
      }
    } else if (line[0] == 'v' && line[1] == 'n') {
      float x, y, z;
      if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        ns.push_back(x);
        ns.push_back(yf * y);
        ns.push_back(z);
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      // collect corner refs
      std::vector<long> vi, ni;
      char* p = line + 2;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        long a = std::strtol(p, &p, 10);
        long b = 0;
        if (*p == '/') {
          p++;
          if (*p != '/') std::strtol(p, &p, 10);  // texcoord, ignored
          if (*p == '/') {
            p++;
            b = std::strtol(p, &p, 10);
          }
        }
        long nvs = (long)vs.size() / 3, nns = (long)ns.size() / 3;
        vi.push_back(a > 0 ? a - 1 : nvs + a);
        ni.push_back(b != 0 ? (b > 0 ? b - 1 : nns + b) : (a > 0 ? a - 1 : nvs + a));
        while (*p && *p != ' ' && *p != '\t' && *p != '\n') p++;
      }
      for (size_t k = 1; k + 1 < vi.size(); k++) {
        const long tri_v[3] = {vi[0], vi[k], vi[k + 1]};
        const long tri_n[3] = {ni[0], ni[k], ni[k + 1]};
        for (int c = 0; c < 3; c++) {
          for (int d = 0; d < 3; d++)
            out.verts.push_back(vs[(size_t)tri_v[c] * 3 + d]);
          if (!ns.empty() && (size_t)tri_n[c] * 3 + 2 < ns.size())
            for (int d = 0; d < 3; d++)
              out.norms.push_back(ns[(size_t)tri_n[c] * 3 + d]);
          else
            for (int d = 0; d < 3; d++) out.norms.push_back(0.f);
        }
      }
    }
  }
  std::fclose(f);
  return 0;
}

int grt_obj_count(const char* path, int64_t* out_n_tris) {
  ObjData d;
  int rc = obj_parse(path, d, 1);
  if (rc) return rc;
  *out_n_tris = (int64_t)(d.verts.size() / 9);
  return 0;
}

// verts/norms: 9 * n_tris floats each (unindexed soup, one vertex per corner,
// like the reference OBJ path, Primitives.cpp:168-192)
int grt_obj_load(const char* path, float* verts, float* norms, int64_t n_tris,
                 int32_t y_flip) {
  ObjData d;
  int rc = obj_parse(path, d, y_flip);
  if (rc) return rc;
  if ((int64_t)(d.verts.size() / 9) != n_tris) return -5;
  std::memcpy(verts, d.verts.data(), d.verts.size() * sizeof(float));
  std::memcpy(norms, d.norms.data(), d.norms.size() * sizeof(float));
  return 0;
}

// ---------------------------------------------------------------------------
// Morton codes + radix argsort (spatial partitioning preprocessing)
// ---------------------------------------------------------------------------

static inline uint64_t expand_bits_21(uint64_t v) {
  v &= (1ull << 21) - 1;
  v = (v | (v << 32)) & 0x1f00000000ffffull;
  v = (v | (v << 16)) & 0x1f0000ff0000ffull;
  v = (v | (v << 8)) & 0x100f00f00f00f00full;
  v = (v | (v << 4)) & 0x10c30c30c30c30c3ull;
  v = (v | (v << 2)) & 0x1249249249249249ull;
  return v;
}

// 63-bit morton codes of positions normalized into [lo, hi]^3
void grt_morton3d(const float* pos, int64_t n, const float* lo, const float* hi,
                  uint64_t* out) {
  // plain division (not reciprocal-multiply) so codes are bit-identical to
  // the NumPy fallback path
  const float dx = hi[0] > lo[0] ? hi[0] - lo[0] : 1.f;
  const float dy = hi[1] > lo[1] ? hi[1] - lo[1] : 1.f;
  const float dz = hi[2] > lo[2] ? hi[2] - lo[2] : 1.f;
  const float scale = (float)((1 << 21) - 1);
  for (int64_t i = 0; i < n; i++) {
    float fx = (pos[i * 3 + 0] - lo[0]) / dx;
    float fy = (pos[i * 3 + 1] - lo[1]) / dy;
    float fz = (pos[i * 3 + 2] - lo[2]) / dz;
    fx = fx < 0.f ? 0.f : (fx > 1.f ? 1.f : fx);
    fy = fy < 0.f ? 0.f : (fy > 1.f ? 1.f : fy);
    fz = fz < 0.f ? 0.f : (fz > 1.f ? 1.f : fz);
    uint64_t x = (uint64_t)(fx * scale);
    uint64_t y = (uint64_t)(fy * scale);
    uint64_t z = (uint64_t)(fz * scale);
    out[i] = (expand_bits_21(x) << 2) | (expand_bits_21(y) << 1) | expand_bits_21(z);
  }
}

// LSD radix argsort of uint64 keys (8 passes x 8 bits), stable.
void grt_argsort_u64(const uint64_t* keys, int64_t n, int64_t* out_idx) {
  std::vector<int64_t> idx(n), tmp(n);
  for (int64_t i = 0; i < n; i++) idx[i] = i;
  int64_t counts[256];
  for (int pass = 0; pass < 8; pass++) {
    const int shift = pass * 8;
    std::memset(counts, 0, sizeof counts);
    for (int64_t i = 0; i < n; i++) counts[(keys[idx[i]] >> shift) & 0xff]++;
    int64_t sum = 0;
    for (int b = 0; b < 256; b++) {
      int64_t c = counts[b];
      counts[b] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; i++)
      tmp[counts[(keys[idx[i]] >> shift) & 0xff]++] = idx[i];
    idx.swap(tmp);
  }
  std::memcpy(out_idx, idx.data(), (size_t)n * sizeof(int64_t));
}

}  // extern "C"
