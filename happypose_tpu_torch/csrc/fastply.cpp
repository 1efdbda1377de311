// Fast binary-PLY mesh decoder (C++17, no dependencies).
//
// The mesh database layer loads thousands of meshes (the reference trains on
// >20k GSO/ShapeNet objects, megapose/README.md:50-53); pure-Python parsing
// of binary PLY list properties is the bottleneck. This library parses the
// dominant on-disk format — binary_little_endian, float32 x/y/z vertices
// (+ optional u8 RGB), faces as (u8 count, i32 indices) — in a single pass.
// Anything else falls back to the Python parser (meshes/io.py).
//
// C ABI (ctypes):
//   fastply_parse(path) -> handle (0 on failure)
//   fastply_counts(handle, &n_vertices, &n_faces, &has_colors)
//   fastply_copy(handle, vertices_f32[3V], faces_i32[3F], colors_u8[3V])
//   fastply_free(handle)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 fastply.cpp -o libfastply.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Property {
  std::string name;
  int size = 0;          // bytes (scalar)
  bool is_list = false;
  int count_size = 0;    // list count bytes
  int item_size = 0;     // list item bytes
  bool item_signed_int = false;
  bool is_float = false;
};

struct Element {
  std::string name;
  long count = 0;
  std::vector<Property> props;
};

struct Parsed {
  std::vector<float> vertices;   // 3V
  std::vector<uint8_t> colors;   // 3V (empty if none)
  std::vector<int32_t> faces;    // 3F (fans triangulated)
  bool has_colors = false;
};

int type_size(const std::string& t, bool* is_float, bool* is_signed) {
  *is_float = false;
  *is_signed = false;
  if (t == "char" || t == "int8") { *is_signed = true; return 1; }
  if (t == "uchar" || t == "uint8") return 1;
  if (t == "short" || t == "int16") { *is_signed = true; return 2; }
  if (t == "ushort" || t == "uint16") return 2;
  if (t == "int" || t == "int32") { *is_signed = true; return 4; }
  if (t == "uint" || t == "uint32") return 4;
  if (t == "float" || t == "float32") { *is_float = true; return 4; }
  if (t == "double" || t == "float64") { *is_float = true; return 8; }
  return 0;
}

long read_uint(const uint8_t* p, int size) {
  switch (size) {
    case 1: return *p;
    case 2: { uint16_t v; std::memcpy(&v, p, 2); return v; }
    case 4: { uint32_t v; std::memcpy(&v, p, 4); return v; }
    default: return -1;
  }
}

double read_scalar(const uint8_t* p, const Property& pr) {
  if (pr.is_float) {
    if (pr.size == 4) { float v; std::memcpy(&v, p, 4); return v; }
    double v; std::memcpy(&v, p, 8); return v;
  }
  return static_cast<double>(read_uint(p, pr.size));
}

}  // namespace

extern "C" {

void* fastply_parse(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(size);
  if (std::fread(data.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  // header
  std::string header;
  long body = -1;
  for (long i = 0; i + 10 < size; i++) {
    if (std::memcmp(&data[i], "end_header", 10) == 0) {
      long j = i + 10;
      while (j < size && data[j] != '\n') j++;
      body = j + 1;
      header.assign(reinterpret_cast<char*>(data.data()), i);
      break;
    }
  }
  if (body < 0) return nullptr;
  if (header.find("format binary_little_endian") == std::string::npos)
    return nullptr;  // ascii / big endian -> python fallback

  std::vector<Element> elements;
  {
    size_t pos = 0;
    while (pos < header.size()) {
      size_t eol = header.find('\n', pos);
      if (eol == std::string::npos) eol = header.size();
      std::string line = header.substr(pos, eol - pos);
      pos = eol + 1;
      if (!line.empty() && line.back() == '\r') line.pop_back();
      char a[64], b[64], c[64], d[64];
      long n;
      if (std::sscanf(line.c_str(), "element %63s %ld", a, &n) == 2) {
        elements.push_back({a, n, {}});
      } else if (elements.empty()) {
        continue;
      } else if (std::sscanf(line.c_str(), "property list %63s %63s %63s",
                             a, b, c) == 3) {
        Property p;
        p.name = c;
        p.is_list = true;
        bool f1, s1;
        p.count_size = type_size(a, &f1, &s1);
        p.item_size = type_size(b, &f1, &p.item_signed_int);
        if (!p.count_size || !p.item_size || f1) return nullptr;
        elements.back().props.push_back(p);
      } else if (std::sscanf(line.c_str(), "property %63s %63s", a, b) == 2) {
        Property p;
        p.name = b;
        bool sgn;
        p.size = type_size(a, &p.is_float, &sgn);
        if (!p.size) return nullptr;
        elements.back().props.push_back(p);
      }
    }
  }

  auto out = new Parsed();
  const uint8_t* ptr = data.data() + body;
  const uint8_t* end = data.data() + size;
  for (const auto& el : elements) {
    bool fixed = true;
    long stride = 0;
    for (const auto& p : el.props) {
      if (p.is_list) fixed = false;
      stride += p.size;
    }
    if (el.name == "vertex" && fixed) {
      int off_x = -1, off_y = -1, off_z = -1, off_r = -1;
      long off = 0;
      Property px, pr_;
      for (const auto& p : el.props) {
        if (p.name == "x") { off_x = off; px = p; }
        if (p.name == "y") off_y = off;
        if (p.name == "z") off_z = off;
        if (p.name == "red") { off_r = off; pr_ = p; }
        off += p.size;
      }
      // require consecutive same-typed x, y, z (standard exporters)
      if (off_x < 0 || off_y != off_x + px.size ||
          off_z != off_y + px.size) {
        delete out;
        return nullptr;
      }
      if (ptr + stride * el.count > end) { delete out; return nullptr; }
      out->vertices.resize(3 * el.count);
      if (off_r >= 0 && pr_.size == 1) {
        out->has_colors = true;
        out->colors.resize(3 * el.count);
      }
      for (long i = 0; i < el.count; i++) {
        const uint8_t* row = ptr + i * stride;
        // x, y, z assumed consecutive same-typed (standard exporters)
        for (int k = 0; k < 3; k++)
          out->vertices[3 * i + k] =
              static_cast<float>(read_scalar(row + off_x + k * px.size, px));
        if (out->has_colors)
          for (int k = 0; k < 3; k++)
            out->colors[3 * i + k] = row[off_r + k];
      }
      ptr += stride * el.count;
    } else if (el.name == "face" && !fixed && el.props.size() == 1) {
      const Property& p = el.props[0];
      out->faces.reserve(3 * el.count);
      for (long i = 0; i < el.count; i++) {
        if (ptr + p.count_size > end) { delete out; return nullptr; }
        long n = read_uint(ptr, p.count_size);
        ptr += p.count_size;
        if (n < 0 || ptr + n * p.item_size > end) { delete out; return nullptr; }
        std::vector<long> idx(n);
        for (long k = 0; k < n; k++) {
          Property item;
          item.size = p.item_size;
          item.is_float = false;
          idx[k] = read_uint(ptr + k * p.item_size, p.item_size);
        }
        ptr += n * p.item_size;
        for (long k = 1; k + 1 < n; k++) {
          out->faces.push_back(static_cast<int32_t>(idx[0]));
          out->faces.push_back(static_cast<int32_t>(idx[k]));
          out->faces.push_back(static_cast<int32_t>(idx[k + 1]));
        }
      }
    } else {
      // skip unknown fixed-stride elements; bail on unknown ragged ones
      if (fixed) {
        ptr += stride * el.count;
      } else {
        delete out;
        return nullptr;
      }
    }
  }
  return out;
}

void fastply_counts(void* handle, long* n_vertices, long* n_faces,
                    int* has_colors) {
  auto* p = static_cast<Parsed*>(handle);
  *n_vertices = p->vertices.size() / 3;
  *n_faces = p->faces.size() / 3;
  *has_colors = p->has_colors ? 1 : 0;
}

void fastply_copy(void* handle, float* vertices, int32_t* faces,
                  uint8_t* colors) {
  auto* p = static_cast<Parsed*>(handle);
  std::memcpy(vertices, p->vertices.data(),
              p->vertices.size() * sizeof(float));
  std::memcpy(faces, p->faces.data(), p->faces.size() * sizeof(int32_t));
  if (p->has_colors && colors)
    std::memcpy(colors, p->colors.data(), p->colors.size());
}

void fastply_free(void* handle) { delete static_cast<Parsed*>(handle); }

}  // extern "C"
