// Native IO runtime for pointcloud_render.
//
// The reference's only native component is the external Mitsuba renderer
// (traj_ball_renderer.py:342-363), which this framework replaces with its
// own device kernels; the native surface that remains on the host is IO.  At the
// target frame rates the Python loaders/encoders become the bottleneck, so
// the hot paths live here:
//   * pcr_read_ply / pcr_ply_vertex_count — binary/ascii PLY parsing with
//     the reference's property semantics (x/y/z + vx/vy/vz, else nx/ny/nz
//     as velocity — traj_ball_renderer.py:236-277);
//   * pcr_write_png — 8-bit RGB PNG encoding (zlib).
//
// Exposed as a plain C ABI consumed via ctypes (io/native.py); everything
// degrades to the pure-Python implementations when this library is absent.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Property {
  std::string name;
  int size = 0;       // bytes for scalar; 0 for list
  bool is_float = false;
  bool is_double = false;
  bool is_signed = false;  // signed integer type (sign-extend on read)
  bool is_list = false;
  int list_index_size = 0;
  int list_value_size = 0;
};

struct Element {
  std::string name;
  long long count = 0;
  std::vector<Property> props;
};

struct Header {
  bool ascii = false;
  bool big_endian = false;
  std::vector<Element> elements;
  size_t header_bytes = 0;
};

int type_size(const std::string& t) {
  if (t == "char" || t == "int8" || t == "uchar" || t == "uint8") return 1;
  if (t == "short" || t == "int16" || t == "ushort" || t == "uint16") return 2;
  if (t == "int" || t == "int32" || t == "uint" || t == "uint32" ||
      t == "float" || t == "float32") return 4;
  if (t == "double" || t == "float64") return 8;
  return -1;
}

bool type_signed(const std::string& t) {
  return t == "char" || t == "int8" || t == "short" || t == "int16" ||
         t == "int" || t == "int32";
}

bool parse_header(const std::string& text, Header* h) {
  size_t end = text.find("end_header");
  if (text.compare(0, 3, "ply") != 0 || end == std::string::npos) return false;
  size_t nl = text.find('\n', end);
  if (nl == std::string::npos) return false;
  h->header_bytes = nl + 1;

  size_t pos = 0;
  Element* cur = nullptr;
  while (pos < h->header_bytes) {
    size_t eol = text.find('\n', pos);
    if (eol == std::string::npos || eol > h->header_bytes) break;
    std::string line = text.substr(pos, eol - pos);
    pos = eol + 1;
    if (!line.empty() && line.back() == '\r') line.pop_back();

    std::vector<std::string> tok;
    size_t i = 0;
    while (i < line.size()) {
      while (i < line.size() && isspace((unsigned char)line[i])) i++;
      size_t j = i;
      while (j < line.size() && !isspace((unsigned char)line[j])) j++;
      if (j > i) tok.push_back(line.substr(i, j - i));
      i = j;
    }
    if (tok.empty()) continue;
    if (tok[0] == "format" && tok.size() >= 2) {
      h->ascii = tok[1] == "ascii";
      h->big_endian = tok[1] == "binary_big_endian";
    } else if (tok[0] == "element" && tok.size() >= 3) {
      h->elements.push_back(Element{tok[1], atoll(tok[2].c_str()), {}});
      cur = &h->elements.back();
    } else if (tok[0] == "property" && cur) {
      Property p;
      if (tok.size() >= 5 && tok[1] == "list") {
        p.is_list = true;
        p.list_index_size = type_size(tok[2]);
        p.list_value_size = type_size(tok[3]);
        p.name = tok[4];
        if (p.list_index_size < 0 || p.list_value_size < 0) return false;
      } else if (tok.size() >= 3) {
        p.size = type_size(tok[1]);
        if (p.size < 0) return false;
        p.is_float = (tok[1] == "float" || tok[1] == "float32");
        p.is_double = (tok[1] == "double" || tok[1] == "float64");
        p.is_signed = type_signed(tok[1]);
        p.name = tok[2];
      } else {
        return false;
      }
      cur->props.push_back(p);
    }
  }
  return true;
}

bool read_file(const char* path, std::string* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(size);
  size_t got = fread(&(*out)[0], 1, size, f);
  fclose(f);
  return got == (size_t)size;
}

// Reads only as much of the file as the header needs (vertex_count is
// called once per frame load just to size the output buffer — reading a
// 24 MB binary body to answer it halves the native loader's win).
bool read_header_text(const char* path, std::string* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  const size_t kChunk = 16384;
  out->clear();
  for (;;) {
    // parse_header needs the newline AFTER end_header too.
    size_t eh = out->find("end_header");
    if (eh != std::string::npos &&
        out->find('\n', eh) != std::string::npos) break;
    size_t at = out->size();
    out->resize(at + kChunk);
    size_t got = fread(&(*out)[at], 1, kChunk, f);
    out->resize(at + got);
    if (got == 0) break;  // EOF: let parse_header report the malformed file
  }
  fclose(f);
  return !out->empty();
}

// Reads a scalar at `ptr` with the given size/float flags (little-endian
// host assumed; big-endian PLY is byte-swapped).
double read_scalar(const unsigned char* ptr, const Property& p, bool be) {
  unsigned char buf[8];
  memcpy(buf, ptr, p.size);
  if (be) {
    for (int i = 0; i < p.size / 2; i++) {
      unsigned char t = buf[i];
      buf[i] = buf[p.size - 1 - i];
      buf[p.size - 1 - i] = t;
    }
  }
  if (p.is_float) { float v; memcpy(&v, buf, 4); return v; }
  if (p.is_double) { double v; memcpy(&v, buf, 8); return v; }
  // Integers: reference treats coordinates as numbers regardless of type.
  // memcpy into a zero-initialized word zero-extends (correct for the
  // unsigned types); signed types must SIGN-extend or negative values
  // decode as huge positives.
  long long v = 0;
  memcpy(&v, buf, p.size);
  if (p.is_signed && p.size < 8) {
    long long sign_bit = 1LL << (p.size * 8 - 1);
    v = (v ^ sign_bit) - sign_bit;
  }
  return (double)v;
}

struct Parsed {
  std::vector<float> data;  // row-major (n, ncols)
  long long n = 0;
  int ncols = 0;
};

int parse_ply(const char* path, bool positions_only, Parsed* out) {
  std::string blob;
  if (!read_file(path, &blob)) return -1;
  Header h;
  if (!parse_header(blob, &h)) return -2;

  const Element* vtx = nullptr;
  size_t offset = h.header_bytes;
  // Walk elements in order to find the byte offset of 'vertex' (binary).
  for (const auto& el : h.elements) {
    if (el.name == "vertex") { vtx = &el; break; }
    if (h.ascii) continue;  // ascii handled tokenwise below
    long long row = 0;
    for (const auto& p : el.props) {
      if (p.is_list) { row = -1; break; }
      row += p.size;
    }
    if (row < 0) return -3;  // list element before vertex: unsupported
    offset += (size_t)row * el.count;
  }
  if (!vtx) return -4;

  int ix = -1, iy = -1, iz = -1, ivx = -1, ivy = -1, ivz = -1;
  int inx = -1, iny = -1, inz = -1;
  for (size_t i = 0; i < vtx->props.size(); i++) {
    const std::string& nm = vtx->props[i].name;
    if (nm == "x") ix = i; else if (nm == "y") iy = i;
    else if (nm == "z") iz = i;
    else if (nm == "vx") ivx = i; else if (nm == "vy") ivy = i;
    else if (nm == "vz") ivz = i;
    else if (nm == "nx") inx = i; else if (nm == "ny") iny = i;
    else if (nm == "nz") inz = i;
  }
  if (ix < 0 || iy < 0 || iz < 0) return -5;

  bool has_vel = ivx >= 0 && ivy >= 0 && ivz >= 0;
  bool has_nrm = inx >= 0 && iny >= 0 && inz >= 0;
  int cols[6] = {ix, iy, iz, -1, -1, -1};
  int ncols = 3;
  if (!positions_only) {
    // Reference priority: velocity first, then normals-as-velocity
    // (traj_ball_renderer.py:253-273).
    if (has_vel) { cols[3] = ivx; cols[4] = ivy; cols[5] = ivz; ncols = 6; }
    else if (has_nrm) { cols[3] = inx; cols[4] = iny; cols[5] = inz; ncols = 6; }
  }

  out->n = vtx->count;
  out->ncols = ncols;
  out->data.resize((size_t)vtx->count * ncols);

  if (h.ascii) {
    // Tokenwise body walk.  Vertex rows must be scalar-only (a list
    // property would misalign the fixed cols[] indices -> fall back to
    // the NumPy parser, like the binary path's -3).
    for (const auto& p : vtx->props)
      if (p.is_list) return -3;
    const char* s = blob.data() + h.header_bytes;
    const char* end = blob.data() + blob.size();
    auto next_tok = [&](double* val) -> bool {
      while (s < end && isspace((unsigned char)*s)) s++;
      if (s >= end) return false;
      char* next = nullptr;
      double v = strtod(s, &next);
      if (next == s) return false;
      s = next;
      if (val) *val = v;
      return true;
    };
    // Skip any elements that precede 'vertex' (spec-legal ordering);
    // list properties skip their count + that many values.
    for (const auto& el : h.elements) {
      if (&el == vtx) break;
      for (long long r = 0; r < el.count; r++) {
        for (const auto& p : el.props) {
          if (p.is_list) {
            double k = 0;
            if (!next_tok(&k) || k < 0) return -6;
            for (long long t = 0; t < (long long)k; t++)
              if (!next_tok(nullptr)) return -6;
          } else if (!next_tok(nullptr)) {
            return -6;
          }
        }
      }
    }
    std::vector<double> row(vtx->props.size());
    for (long long r = 0; r < vtx->count; r++) {
      for (size_t c = 0; c < vtx->props.size(); c++)
        if (!next_tok(&row[c])) return -6;
      for (int c = 0; c < ncols; c++)
        out->data[(size_t)r * ncols + c] = (float)row[cols[c]];
    }
    return 0;
  }

  long long row_bytes = 0;
  std::vector<long long> prop_off(vtx->props.size());
  for (size_t i = 0; i < vtx->props.size(); i++) {
    if (vtx->props[i].is_list) return -3;
    prop_off[i] = row_bytes;
    row_bytes += vtx->props[i].size;
  }
  if (offset + (size_t)row_bytes * vtx->count > blob.size()) return -7;

  const unsigned char* base = (const unsigned char*)blob.data() + offset;
  for (long long r = 0; r < vtx->count; r++) {
    const unsigned char* rp = base + r * row_bytes;
    for (int c = 0; c < ncols; c++) {
      const Property& p = vtx->props[cols[c]];
      out->data[(size_t)r * ncols + c] =
          (float)read_scalar(rp + prop_off[cols[c]], p, h.big_endian);
    }
  }
  return 0;
}

void put32(std::string* s, uint32_t v) {
  s->push_back((char)(v >> 24));
  s->push_back((char)(v >> 16));
  s->push_back((char)(v >> 8));
  s->push_back((char)v);
}

void chunk(std::string* out, const char* tag, const std::string& payload) {
  put32(out, (uint32_t)payload.size());
  size_t crc_start = out->size();
  out->append(tag, 4);
  out->append(payload);
  uLong crc = crc32(0L, (const Bytef*)out->data() + crc_start,
                    (uInt)(4 + payload.size()));
  put32(out, (uint32_t)crc);
}

}  // namespace

extern "C" {

// Returns vertex count, or <0 on error.  Header-only read.
long long pcr_ply_vertex_count(const char* path) {
  std::string blob;
  if (!read_header_text(path, &blob)) return -1;
  Header h;
  if (!parse_header(blob, &h)) return -2;
  for (const auto& el : h.elements)
    if (el.name == "vertex") return el.count;
  return -4;
}

// Fills out[n, ncols] (caller allocates n*6 floats); sets *ncols_out.
// Returns 0 on success, <0 on error.
long long pcr_read_ply(const char* path, float* out, long long capacity,
                       int* ncols_out, int positions_only) {
  Parsed parsed;
  int rc = parse_ply(path, positions_only != 0, &parsed);
  if (rc != 0) return rc;
  if (parsed.n > capacity) return -8;
  *ncols_out = parsed.ncols;
  memcpy(out, parsed.data.data(), parsed.data.size() * sizeof(float));
  return 0;
}

// image: 8-bit RGB row-major (h, w, 3).  Returns 0 on success.
int pcr_write_png(const char* path, const unsigned char* image, int w,
                  int h) {
  // Filter bytes (0 = none) prepended per scanline.
  std::vector<unsigned char> raw((size_t)h * (w * 3 + 1));
  for (int y = 0; y < h; y++) {
    raw[(size_t)y * (w * 3 + 1)] = 0;
    memcpy(&raw[(size_t)y * (w * 3 + 1) + 1], image + (size_t)y * w * 3,
           (size_t)w * 3);
  }
  uLongf bound = compressBound((uLong)raw.size());
  std::vector<unsigned char> comp(bound);
  if (compress2(comp.data(), &bound, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return -1;

  std::string png("\x89PNG\r\n\x1a\n", 8);
  std::string ihdr;
  put32(&ihdr, (uint32_t)w);
  put32(&ihdr, (uint32_t)h);
  ihdr.push_back(8);   // bit depth
  ihdr.push_back(2);   // color type RGB
  ihdr.push_back(0);
  ihdr.push_back(0);
  ihdr.push_back(0);
  chunk(&png, "IHDR", ihdr);
  chunk(&png, "IDAT", std::string((char*)comp.data(), bound));
  chunk(&png, "IEND", "");

  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  size_t wrote = fwrite(png.data(), 1, png.size(), f);
  fclose(f);
  return wrote == png.size() ? 0 : -3;
}

}  // extern "C"
