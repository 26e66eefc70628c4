// Native .hic block decoder of the PyTorch/CUDA port.
//
// A copy of mustache_tpu/io/native/hic_decode.cpp: decodes batches of
// zlib-compressed Juicer .hic contact blocks (format v6-v9) into COO
// triplet arrays, the ingest hot path of mustache_tpu_torch/io/hic.py
// (whose Python decoder is kept as the plain twin the tests hold this one
// against). Built at first use by mustache_tpu_torch/kernels/build.py
// (g++ -O3 -shared, linked against libz.so.1); plain C ABI, bound with
// ctypes in mustache_tpu_torch/io/native/__init__.py.
//
// Where zlib's header is not installed (MTPU_DECLARE_ZLIB forces this
// path), the four inflate entry points and z_stream are declared here by
// hand with zlib's public ABI (zlib.h, 1.2.x); mtpu_hic_zlib_declared()
// reports which of the two was compiled.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#if !defined(MTPU_DECLARE_ZLIB) && __has_include(<zlib.h>)
#include <zlib.h>
#define MTPU_ZLIB_DECLARED 0
#else
#define MTPU_ZLIB_DECLARED 1
extern "C" {
typedef unsigned char Bytef;
typedef unsigned int uInt;
typedef unsigned long uLong;
typedef void* voidpf;
typedef voidpf (*alloc_func)(voidpf, uInt, uInt);
typedef void (*free_func)(voidpf, voidpf);
struct internal_state;
typedef struct z_stream_s {
  const Bytef* next_in;
  uInt avail_in;
  uLong total_in;
  Bytef* next_out;
  uInt avail_out;
  uLong total_out;
  const char* msg;
  struct internal_state* state;
  alloc_func zalloc;
  free_func zfree;
  voidpf opaque;
  int data_type;
  uLong adler;
  uLong reserved;
} z_stream;
int inflateInit_(z_stream* strm, const char* version, int stream_size);
int inflate(z_stream* strm, int flush);
int inflateEnd(z_stream* strm);
}
#define Z_OK 0
#define Z_STREAM_END 1
#define Z_NO_FLUSH 0
// zlib checks only the major version digit and the struct size
#define inflateInit(strm) inflateInit_((strm), "1.2.11", (int)sizeof(z_stream))
#endif

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T take() {
    if (p + sizeof(T) > end) {
      ok = false;
      return T{};
    }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }
};

bool inflate_block(const uint8_t* src, int64_t src_len,
                   std::vector<uint8_t>* out) {
  out->clear();
  out->resize(std::max<int64_t>(src_len * 4, 1 << 16));
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  size_t written = 0;
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    if (written == out->size()) out->resize(out->size() * 2);
    zs.next_out = out->data() + written;
    zs.avail_out = static_cast<uInt>(out->size() - written);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    written = out->size() - zs.avail_out;
  }
  inflateEnd(&zs);
  out->resize(written);
  return true;
}

struct Sink {
  int64_t* x;
  int64_t* y;
  double* v;
  int64_t capacity;
  int64_t count = 0;
  bool overflow = false;

  inline void emit(int64_t bx, int64_t by, double val) {
    if (count >= capacity) {
      overflow = true;
      count++;  // keep counting so the caller can size the retry
      return;
    }
    x[count] = bx;
    y[count] = by;
    v[count] = val;
    count++;
  }
};

// Decode one decompressed block payload; returns false on parse error.
bool decode_payload(const uint8_t* data, int64_t len, int version,
                    Sink* sink) {
  Cursor c{data, data + len};
  int32_t n_records = c.take<int32_t>();
  if (!c.ok) return false;
  if (n_records == 0) return true;

  if (version < 7) {
    for (int32_t i = 0; i < n_records; ++i) {
      int32_t bx = c.take<int32_t>();
      int32_t by = c.take<int32_t>();
      float val = c.take<float>();
      if (!c.ok) return false;
      sink->emit(bx, by, val);
    }
    return true;
  }

  int32_t bin_x_off = c.take<int32_t>();
  int32_t bin_y_off = c.take<int32_t>();
  bool use_float, use_int_x = false, use_int_y = false;
  if (version >= 9) {
    use_float = c.take<int8_t>() != 0;
    use_int_x = c.take<int8_t>() != 0;
    use_int_y = c.take<int8_t>() != 0;
  } else {
    // v7/v8: same polarity as v9's useFloatContact byte — 0 means int16
    // counts, nonzero means float32 (straw readBlock: useShort = byte == 0)
    use_float = c.take<int8_t>() != 0;
  }
  int8_t mtype = c.take<int8_t>();
  if (!c.ok) return false;

  auto take_x = [&]() -> int32_t {
    return use_int_x ? c.take<int32_t>() : c.take<int16_t>();
  };
  auto take_y = [&]() -> int32_t {
    return use_int_y ? c.take<int32_t>() : c.take<int16_t>();
  };
  auto take_count = [&]() -> double {
    return use_float ? static_cast<double>(c.take<float>())
                     : static_cast<double>(c.take<int16_t>());
  };

  if (mtype == 1) {  // list of rows
    int32_t row_count = take_y();
    for (int32_t r = 0; c.ok && r < row_count; ++r) {
      int32_t bin_y = take_y() + bin_y_off;
      int32_t col_count = take_x();
      for (int32_t k = 0; c.ok && k < col_count; ++k) {
        int32_t bin_x = take_x() + bin_x_off;
        double val = take_count();
        sink->emit(bin_x, bin_y, val);
      }
    }
    return c.ok;
  }
  if (mtype == 2) {  // dense
    int32_t n_pts = c.take<int32_t>();
    // straw reads the dense width as int16 UNCONDITIONALLY (useIntXPos
    // widens only the bin offsets, not w)
    int32_t w = c.take<int16_t>();
    if (!c.ok || w <= 0) return false;
    for (int32_t i = 0; c.ok && i < n_pts; ++i) {
      double val;
      if (use_float) {
        float f = c.take<float>();
        if (f != f) continue;  // NaN = missing
        val = f;
      } else {
        int16_t s = c.take<int16_t>();
        if (s == -32768) continue;
        val = s;
      }
      int32_t row = i / w;
      int32_t col = i - row * w;
      sink->emit(bin_x_off + col, bin_y_off + row, val);
    }
    return c.ok;
  }
  return false;
}

}  // namespace

extern "C" {

// 1 when the inflate entry points were declared by hand (no zlib.h).
int mtpu_hic_zlib_declared() { return MTPU_ZLIB_DECLARED; }

// Decode blocks read from `path` at (positions[i], sizes[i]).
// Returns:  0 ok; count written to *out_count
//          -1 I/O error; -2 inflate error; -3 parse error
//          -4 capacity exceeded (*out_count = total needed)
int mtpu_decode_hic_blocks(const char* path, const int64_t* positions,
                           const int32_t* sizes, int32_t n_blocks,
                           int32_t version, int64_t* out_x, int64_t* out_y,
                           double* out_v, int64_t capacity,
                           int64_t* out_count) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  Sink sink{out_x, out_y, out_v, capacity};
  std::vector<uint8_t> comp, raw;
  int rc = 0;
  for (int32_t b = 0; b < n_blocks; ++b) {
    comp.resize(sizes[b]);
    if (std::fseek(f, static_cast<long>(positions[b]), SEEK_SET) != 0 ||
        std::fread(comp.data(), 1, comp.size(), f) != comp.size()) {
      rc = -1;
      break;
    }
    if (!inflate_block(comp.data(), comp.size(), &raw)) {
      rc = -2;
      break;
    }
    if (!decode_payload(raw.data(), raw.size(), version, &sink)) {
      rc = -3;
      break;
    }
  }
  std::fclose(f);
  *out_count = sink.count;
  if (rc != 0) return rc;
  return sink.overflow ? -4 : 0;
}

}  // extern "C"
