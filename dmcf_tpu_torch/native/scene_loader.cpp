// Native scene loader: zstd decompression and msgpack decoding of a
// ``*.msgpack.zst`` scene file (a list of frame dicts), off the Python GIL.
// The port's copy of dmcf_tpu/native/scene_loader.cpp, behind a C ABI
// read with ctypes (dmcf_tpu_torch/data/native_loader.py), which builds
// it with g++ at first use.
//
// zstd: the three functions used are declared here and the library is
// linked as ``-l:libzstd.so.1``, so only the runtime library is needed,
// not zstd.h.
//
// Scope: the msgpack that the writers of both packages and the reference's
// datasets produce.  numpy arrays are maps in the msgpack-numpy wire
// format (b"nd", b"type", b"kind", b"shape", b"data"); nd false is a numpy
// scalar.  Every entry of a frame is kept with its kind (nil, int, float,
// str, bin, bool, array, numpy scalar); a list or a plain map is kept as
// OTHER, which the reader reports as unsupported.  Array payloads point
// into the decompressed blob, which lives as long as the handle.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

extern "C" {
unsigned long long ZSTD_getFrameContentSize(const void* src, size_t size);
size_t ZSTD_decompress(void* dst, size_t capacity, const void* src,
                       size_t size);
unsigned ZSTD_isError(size_t code);
}

namespace {

constexpr unsigned long long kContentSizeUnknown = 0ULL - 1;
constexpr unsigned long long kContentSizeError = 0ULL - 2;

enum Kind { NIL = 0, INT, FLOAT, STR, BIN, BOOL, ARRAY, SCALAR, OTHER };

struct Value {
  Kind kind = NIL;
  int64_t i = 0;
  double f = 0.0;
  std::string s;               // STR / BIN payload
  std::string dtype;           // ARRAY / SCALAR: numpy descr, e.g. "<f4"
  std::vector<int64_t> shape;  // ARRAY
  const uint8_t* data = nullptr;
  size_t nbytes = 0;
};

using Frame = std::vector<std::pair<std::string, Value>>;

struct Scene {
  std::vector<uint8_t> blob;   // decompressed msgpack payload
  std::vector<Frame> frames;
};

class Reader {
 public:
  Reader(const uint8_t* p, size_t n) : p_(p), n_(n) {}

  bool ok() const { return ok_; }

  uint8_t peek() { return pos_ < n_ ? p_[pos_] : (fail(), 0); }
  uint8_t u8() { return need(1) ? p_[pos_++] : 0; }

  uint64_t be(int bytes) {
    if (!need(bytes)) return 0;
    uint64_t v = 0;
    for (int i = 0; i < bytes; ++i) v = (v << 8) | p_[pos_++];
    return v;
  }

  const uint8_t* bytes(size_t len) {
    if (!need(len)) return nullptr;
    const uint8_t* out = p_ + pos_;
    pos_ += len;
    return out;
  }

 private:
  bool need(size_t k) {
    if (k > n_ - pos_) { fail(); return false; }
    return true;
  }
  void fail() { ok_ = false; pos_ = n_; }

  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0;
  bool ok_ = true;
};

bool parse_value(Reader& r, Value& out);

// str or bin family; ``is_bin`` says which
bool parse_raw_string(Reader& r, std::string& out, bool* is_bin = nullptr) {
  uint8_t t = r.u8();
  size_t len;
  bool bin = false;
  if ((t & 0xE0) == 0xA0) len = t & 0x1F;          // fixstr
  else if (t == 0xD9) len = r.be(1);               // str8
  else if (t == 0xDA) len = r.be(2);               // str16
  else if (t == 0xDB) len = r.be(4);               // str32
  else if (t == 0xC4) { len = r.be(1); bin = true; }
  else if (t == 0xC5) { len = r.be(2); bin = true; }
  else if (t == 0xC6) { len = r.be(4); bin = true; }
  else return false;
  const uint8_t* p = r.bytes(len);
  if (!p && len) return false;
  out.assign(reinterpret_cast<const char*>(p), len);
  if (is_bin) *is_bin = bin;
  return true;
}

bool parse_int(Reader& r, int64_t& out) {
  uint8_t t = r.u8();
  if (t < 0x80) { out = t; return true; }                        // fixint
  if (t >= 0xE0) { out = static_cast<int8_t>(t); return true; }  // neg
  switch (t) {
    case 0xCC: out = (int64_t)r.be(1); return true;
    case 0xCD: out = (int64_t)r.be(2); return true;
    case 0xCE: out = (int64_t)r.be(4); return true;
    case 0xCF: out = (int64_t)r.be(8); return true;
    case 0xD0: out = (int8_t)r.be(1); return true;
    case 0xD1: out = (int16_t)r.be(2); return true;
    case 0xD2: out = (int32_t)r.be(4); return true;
    case 0xD3: out = (int64_t)r.be(8); return true;
    default: return false;
  }
}

// A map: a msgpack-numpy array or scalar when its first key is "nd",
// else OTHER (parsed through and dropped).
bool parse_map(Reader& r, size_t n_entries, Value& out) {
  out.kind = OTHER;
  if (n_entries == 0) return true;
  std::string first_key;
  if (!parse_raw_string(r, first_key)) return false;
  if (first_key != "nd") {
    Value ignore;
    if (!parse_value(r, ignore)) return false;
    for (size_t i = 1; i < n_entries; ++i) {
      std::string key;
      if (!parse_raw_string(r, key) || !parse_value(r, ignore)) return false;
    }
    return true;
  }
  uint8_t t = r.u8();
  if (t != 0xC3 && t != 0xC2) return false;
  out.kind = t == 0xC3 ? ARRAY : SCALAR;
  for (size_t i = 1; i < n_entries; ++i) {
    std::string key;
    if (!parse_raw_string(r, key)) return false;
    if (key == "type") {
      if (!parse_raw_string(r, out.dtype)) return false;
    } else if (key == "shape") {
      uint8_t t2 = r.u8();
      size_t len;
      if ((t2 & 0xF0) == 0x90) len = t2 & 0x0F;
      else if (t2 == 0xDC) len = r.be(2);
      else if (t2 == 0xDD) len = r.be(4);
      else return false;
      for (size_t j = 0; j < len; ++j) {
        int64_t v;
        if (!parse_int(r, v)) return false;
        out.shape.push_back(v);
      }
    } else if (key == "data") {
      uint8_t t2 = r.u8();
      if (t2 != 0xC4 && t2 != 0xC5 && t2 != 0xC6) return false;
      size_t len = r.be(t2 == 0xC4 ? 1 : (t2 == 0xC5 ? 2 : 4));
      out.data = r.bytes(len);
      out.nbytes = len;
      if (!out.data && len) return false;
    } else {                   // "kind" and anything else
      Value ignore;
      if (!parse_value(r, ignore)) return false;
    }
  }
  return true;
}

bool parse_value(Reader& r, Value& out) {
  uint8_t t = r.peek();
  if (t < 0x80 || t >= 0xE0 || (t >= 0xCC && t <= 0xD3)) {
    out.kind = INT;
    return parse_int(r, out.i);
  }
  if ((t & 0xE0) == 0xA0 || t == 0xD9 || t == 0xDA || t == 0xDB ||
      t == 0xC4 || t == 0xC5 || t == 0xC6) {
    bool bin = false;
    if (!parse_raw_string(r, out.s, &bin)) return false;
    out.kind = bin ? BIN : STR;
    return true;
  }
  if (t == 0xC0) { r.u8(); out.kind = NIL; return true; }
  if (t == 0xC2 || t == 0xC3) {
    r.u8();
    out.kind = BOOL;
    out.i = (t == 0xC3);
    return true;
  }
  if (t == 0xCA) {
    r.u8();
    uint32_t bits = (uint32_t)r.be(4);
    float f;
    std::memcpy(&f, &bits, 4);
    out.kind = FLOAT;
    out.f = f;
    return true;
  }
  if (t == 0xCB) {
    r.u8();
    uint64_t bits = r.be(8);
    std::memcpy(&out.f, &bits, 8);
    out.kind = FLOAT;
    return true;
  }
  if ((t & 0xF0) == 0x90 || t == 0xDC || t == 0xDD) {  // list: dropped
    r.u8();
    size_t len = ((t & 0xF0) == 0x90) ? (t & 0x0F)
                 : (t == 0xDC ? r.be(2) : r.be(4));
    for (size_t i = 0; i < len; ++i) {
      Value ignore;
      if (!parse_value(r, ignore)) return false;
    }
    out.kind = OTHER;
    return true;
  }
  if ((t & 0xF0) == 0x80 || t == 0xDE || t == 0xDF) {  // map
    r.u8();
    size_t len = ((t & 0xF0) == 0x80) ? (t & 0x0F)
                 : (t == 0xDE ? r.be(2) : r.be(4));
    return parse_map(r, len, out);
  }
  return false;
}

bool parse_frame(Reader& r, Frame& frame) {
  uint8_t t = r.u8();
  size_t len;
  if ((t & 0xF0) == 0x80) len = t & 0x0F;
  else if (t == 0xDE) len = r.be(2);
  else if (t == 0xDF) len = r.be(4);
  else return false;
  for (size_t i = 0; i < len; ++i) {
    std::string key;
    if (!parse_raw_string(r, key)) return false;
    Value v;
    if (!parse_value(r, v)) return false;
    frame.emplace_back(std::move(key), std::move(v));
  }
  return true;
}

std::mutex g_mutex;
std::map<int64_t, std::unique_ptr<Scene>> g_scenes;
int64_t g_next = 1;

const Frame* find_frame(int64_t h, int64_t frame) {
  auto it = g_scenes.find(h);
  if (it == g_scenes.end()) return nullptr;
  auto& frames = it->second->frames;
  if (frame < 0 || (size_t)frame >= frames.size()) return nullptr;
  return &frames[frame];
}

}  // namespace

extern "C" {

// Open and decode a scene file.  Returns a handle > 0, or an error code:
// -1 the file cannot be opened, -2 it cannot be read, -3 zstd rejects it,
// -4 the payload is not a list, -5 a frame is not a map of what the
// decoder reads.
int64_t scene_open(const char* path) {
  auto scene = std::make_unique<Scene>();

  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 0) { std::fclose(f); return -2; }
  std::vector<uint8_t> comp(fsize);
  if (std::fread(comp.data(), 1, fsize, f) != (size_t)fsize) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  unsigned long long raw = ZSTD_getFrameContentSize(comp.data(), fsize);
  if (raw == kContentSizeError) return -3;
  if (raw == kContentSizeUnknown) raw = (unsigned long long)fsize * 40;
  scene->blob.resize(raw);
  size_t got = ZSTD_decompress(scene->blob.data(), raw, comp.data(), fsize);
  if (ZSTD_isError(got)) return -3;
  scene->blob.resize(got);

  Reader r(scene->blob.data(), scene->blob.size());
  uint8_t t = r.u8();
  size_t n_frames;
  if ((t & 0xF0) == 0x90) n_frames = t & 0x0F;
  else if (t == 0xDC) n_frames = r.be(2);
  else if (t == 0xDD) n_frames = r.be(4);
  else return -4;

  scene->frames.resize(n_frames);
  for (size_t i = 0; i < n_frames; ++i) {
    if (!parse_frame(r, scene->frames[i]) || !r.ok()) return -5;
  }

  std::lock_guard<std::mutex> lock(g_mutex);
  int64_t h = g_next++;
  g_scenes[h] = std::move(scene);
  return h;
}

int64_t scene_num_frames(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_scenes.find(h);
  return it == g_scenes.end() ? -1 : (int64_t)it->second->frames.size();
}

int64_t scene_num_entries(int64_t h, int64_t frame) {
  std::lock_guard<std::mutex> lock(g_mutex);
  const Frame* fr = find_frame(h, frame);
  return fr ? (int64_t)fr->size() : -1;
}

// Entry ``idx`` of frames[frame]: its key and value.  ``key_out`` and
// ``data_out`` point into the handle (key bytes; array, scalar, str or
// bin payload); ``shape_out`` holds 8 entries, ``dtype_out`` 16 bytes.
// Returns the kind (see enum Kind), or -1 for a bad handle or index.
int scene_entry(int64_t h, int64_t frame, int64_t idx, const char** key_out,
                int64_t* key_len, int64_t* i_out, double* f_out,
                const uint8_t** data_out, int64_t* nbytes_out,
                int64_t* shape_out, int* ndim_out, char* dtype_out) {
  std::lock_guard<std::mutex> lock(g_mutex);
  const Frame* fr = find_frame(h, frame);
  if (!fr || idx < 0 || (size_t)idx >= fr->size()) return -1;
  const auto& entry = (*fr)[idx];
  const Value& v = entry.second;
  *key_out = entry.first.data();
  *key_len = (int64_t)entry.first.size();
  *i_out = v.i;
  *f_out = v.f;
  if (v.kind == STR || v.kind == BIN) {
    *data_out = reinterpret_cast<const uint8_t*>(v.s.data());
    *nbytes_out = (int64_t)v.s.size();
  } else {
    *data_out = v.data;
    *nbytes_out = (int64_t)v.nbytes;
  }
  if (v.shape.size() > 8) return -1;
  *ndim_out = (int)v.shape.size();
  for (size_t i = 0; i < v.shape.size(); ++i) shape_out[i] = v.shape[i];
  std::snprintf(dtype_out, 16, "%s", v.dtype.c_str());
  return (int)v.kind;
}

void scene_close(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mutex);
  g_scenes.erase(h);
}

}  // extern "C"
