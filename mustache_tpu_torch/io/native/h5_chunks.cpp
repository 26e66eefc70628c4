// Native chunk decoder of the port's HDF5 reader (mustache_tpu_torch/io/h5.py).
//
// One call decodes every chunk of a 1-D chunked dataset that meets the rows
// [lo, hi) and writes their rows straight into the caller's output array:
// per chunk, a thread preads the stored bytes, undoes the filter pipeline
// (deflate and shuffle, as the chunk's filter mask leaves them) and, in the
// pass that undoes the last shuffle, gathers each element's bytes, swaps
// the byte order and widens the value to the output's type. Chunks write
// disjoint slices of the output, so threads share only a work counter; a
// call spawns no more threads than it has chunks. The Python loop this
// replaces is kept as H5File._read_chunked_plain, the twin the tests hold
// this one to. Built at first use by mustache_tpu_torch/kernels/build.py
// (g++ -O3 -shared, linked against libz.so.1); plain C ABI, bound with
// ctypes in mustache_tpu_torch/io/native/__init__.py.
//
// Where zlib's header is not installed (MTPU_DECLARE_ZLIB forces this
// path), the inflate entry points and z_stream are declared here by hand
// with zlib's public ABI (zlib.h, 1.2.x), as in hic_decode.cpp;
// mtpu_h5_zlib_declared() reports which of the two was compiled.

#include <unistd.h>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <type_traits>
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
int inflateReset(z_stream* strm);
int inflateEnd(z_stream* strm);
}
#define Z_OK 0
#define Z_STREAM_END 1
#define Z_NO_FLUSH 0
#define Z_BUF_ERROR (-5)
// zlib checks only the major version digit and the struct size
#define inflateInit(strm) inflateInit_((strm), "1.2.11", (int)sizeof(z_stream))
#endif

namespace {

// return codes; the failing chunk's index goes to stats[4], a detail
// (zlib's code, or the decoded length) to stats[5]
constexpr int RC_READ = 1;      // pread failed or came back short
constexpr int RC_INFLATE = 2;   // zlib refused the stored bytes
constexpr int RC_SIZE = 3;      // the decoded chunk has the wrong length
constexpr int RC_ARGS = 4;      // a type code or pipeline the call cannot do
constexpr int RC_MEMORY = 5;    // an allocation or zlib's set-up failed

constexpr int FILTER_DEFLATE = 1;
constexpr int FILTER_SHUFFLE = 2;

// element type codes, as io/native/__init__.py numbers them
enum Code { RAW = 0, I8, I16, I32, I64, U8, U16, U32, U64, F32, F64 };

using Clock = std::chrono::steady_clock;

inline int64_t ns_since(Clock::time_point t0) {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(Clock::now() -
                                                              t0)
      .count();
}

template <int N>
struct UInt;
template <>
struct UInt<1> { using T = uint8_t; };
template <>
struct UInt<2> { using T = uint16_t; };
template <>
struct UInt<4> { using T = uint32_t; };
template <>
struct UInt<8> { using T = uint64_t; };

#if defined(__SSE2__)
// 16 elements of ES bytes from their ES byte streams s[0..ES) (16 bytes
// each): byte k of element i at s[k][i] goes to out[i * ES + k]; a byte
// transpose by SSE2 unpacks.
template <int ES>
inline void transpose16(const uint8_t* const* s, uint8_t* out) {
  auto load = [](const uint8_t* p) {
    return _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
  };
  auto store = [out](int at, __m128i v) {
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 16 * at), v);
  };
  if constexpr (ES == 2) {
    const __m128i r0 = load(s[0]), r1 = load(s[1]);
    store(0, _mm_unpacklo_epi8(r0, r1));
    store(1, _mm_unpackhi_epi8(r0, r1));
  } else {
    // t[2p], t[2p + 1]: bytes 2p and 2p + 1 of elements 0-7 and 8-15
    __m128i t[ES];
    for (int p = 0; p < ES / 2; ++p) {
      const __m128i a = load(s[2 * p]), b = load(s[2 * p + 1]);
      t[2 * p] = _mm_unpacklo_epi8(a, b);
      t[2 * p + 1] = _mm_unpackhi_epi8(a, b);
    }
    // u[q]: bytes 0-3 (4-7 from q = 4) of elements 4q-4q+3 (mod 16)
    __m128i u[ES];
    for (int h = 0; h < ES / 4; ++h)
      for (int half = 0; half < 2; ++half) {
        const __m128i a = t[4 * h + half], b = t[4 * h + half + 2];
        u[4 * h + 2 * half] = _mm_unpacklo_epi16(a, b);
        u[4 * h + 2 * half + 1] = _mm_unpackhi_epi16(a, b);
      }
    if constexpr (ES == 4) {
      for (int q = 0; q < 4; ++q) store(q, u[q]);
    } else {
      for (int q = 0; q < 4; ++q) {
        store(2 * q, _mm_unpacklo_epi32(u[q], u[q + 4]));
        store(2 * q + 1, _mm_unpackhi_epi32(u[q], u[q + 4]));
      }
    }
  }
}
#endif

// Rows [j0, j0 + n) of a decoded chunk of cn elements, each gathered from
// its bytes (SHUF: byte k of element j at src[k * cn + j], HDF5's shuffle;
// else the element's bytes in a row), reversed when SWAP, read as S and
// stored as D. A shuffled chunk is gathered 16 elements at a time by a
// byte transpose where the host has SSE2; the rest by shifts.
template <typename S, typename D, bool SWAP, bool SHUF>
void emit_loop(const uint8_t* __restrict src, int64_t cn, int64_t j0,
               int64_t n, D* __restrict dst) {
  constexpr int es = sizeof(S);
  using U = typename UInt<es>::T;
  int64_t j = 0;
#if defined(__SSE2__)
  if constexpr (SHUF && es > 1) {
    const uint8_t* streams[es];
    for (int k = 0; k < es; ++k)
      streams[k] = src + (SWAP ? es - 1 - k : k) * cn + j0;
    alignas(16) uint8_t block[16 * es];
    for (; j + 16 <= n; j += 16) {
      const uint8_t* at[es];
      for (int k = 0; k < es; ++k) at[k] = streams[k] + j;
      transpose16<es>(at, block);
      for (int i = 0; i < 16; ++i) {
        S s;
        std::memcpy(&s, block + i * es, es);
        dst[j + i] = static_cast<D>(s);
      }
    }
  }
#endif
  for (; j < n; ++j) {
    U v = 0;
    for (int k = 0; k < es; ++k) {
      const U byte = SHUF ? src[k * cn + j0 + j] : src[(j0 + j) * es + k];
      v |= static_cast<U>(byte << (8 * (SWAP ? es - 1 - k : k)));
    }
    S s;
    std::memcpy(&s, &v, es);
    dst[j] = static_cast<D>(s);
  }
}

typedef void (*EmitFn)(const uint8_t*, int64_t, int64_t, int64_t, void*,
                       bool, bool);

template <typename S, typename D>
void emit(const uint8_t* src, int64_t cn, int64_t j0, int64_t n, void* out,
          bool shuf, bool swap) {
  D* d = static_cast<D*>(out);
  if (shuf) {
    if (swap)
      emit_loop<S, D, true, true>(src, cn, j0, n, d);
    else
      emit_loop<S, D, false, true>(src, cn, j0, n, d);
  } else if (swap) {
    emit_loop<S, D, true, false>(src, cn, j0, n, d);
  } else if (std::is_same<S, D>::value) {
    std::memcpy(d, src + j0 * sizeof(S), n * sizeof(S));
  } else {
    emit_loop<S, D, false, false>(src, cn, j0, n, d);
  }
}

template <typename D>
EmitFn widen_to(int src) {
  switch (src) {
    case I8: return emit<int8_t, D>;
    case I16: return emit<int16_t, D>;
    case I32: return emit<int32_t, D>;
    case I64: return emit<int64_t, D>;
    case U8: return emit<uint8_t, D>;
    case U16: return emit<uint16_t, D>;
    case U32: return emit<uint32_t, D>;
    case U64: return emit<uint64_t, D>;
    case F32: return std::is_integral<D>::value ? nullptr : emit<float, D>;
    case F64: return std::is_integral<D>::value ? nullptr : emit<double, D>;
  }
  return nullptr;
}

// The element writer of a call: RAW copies elem_size bytes as stored (byte
// order swapped where asked: any fixed-size number or string); I64 and F64
// widen a number of type code src.
EmitFn pick_emit(int src, int dst, int elem_size) {
  if (dst == I64) return widen_to<int64_t>(src);
  if (dst == F64) return widen_to<double>(src);
  if (dst != RAW) return nullptr;
  switch (elem_size) {
    case 1: return emit<uint8_t, uint8_t>;
    case 2: return emit<uint16_t, uint16_t>;
    case 4: return emit<uint32_t, uint32_t>;
    case 8: return emit<uint64_t, uint64_t>;
  }
  return nullptr;  // other sizes: strings, by emit_bytes
}

// Strings of any width, never swapped.
void emit_bytes(const uint8_t* src, int64_t cn, int64_t j0, int64_t n,
                int es, uint8_t* dst, bool shuf) {
  if (!shuf) {
    std::memcpy(dst, src + j0 * es, n * es);
    return;
  }
  for (int64_t j = 0; j < n; ++j)
    for (int k = 0; k < es; ++k) dst[j * es + k] = src[k * cn + j0 + j];
}

// HDF5's unshuffle of a whole buffer by element size es, trailing bytes
// (len % es) copied as they are.
void unshuffle(const uint8_t* src, int64_t len, int es, uint8_t* dst) {
  const int64_t n = es > 0 ? len / es : 0;
  for (int k = 0; k < es; ++k)
    for (int64_t j = 0; j < n; ++j) dst[j * es + k] = src[k * n + j];
  std::memcpy(dst + n * es, src + n * es, len - n * es);
}

// Inflates src into out (grown as needed) and sets *len; zlib's return
// code on failure, Z_OK on success. Bytes after the stream's end are
// ignored, as Python's zlib.decompress ignores them.
int inflate_into(z_stream* zs, const uint8_t* src, int64_t src_len,
                 std::vector<uint8_t>* out, int64_t* len) {
  if (inflateReset(zs) != Z_OK) return Z_BUF_ERROR;
  zs->next_in = const_cast<Bytef*>(src);
  zs->avail_in = static_cast<uInt>(src_len);
  int64_t written = 0;
  for (;;) {
    if (written == static_cast<int64_t>(out->size()))
      out->resize(std::max<size_t>(out->size() * 2, 1 << 16));
    zs->next_out = out->data() + written;
    zs->avail_out = static_cast<uInt>(out->size() - written);
    const int ret = inflate(zs, Z_NO_FLUSH);
    written = out->size() - zs->avail_out;
    if (ret == Z_STREAM_END) break;
    // out of input before the stream's end: truncated
    if (ret == Z_BUF_ERROR && zs->avail_in == 0) return Z_BUF_ERROR;
    if (ret != Z_OK && ret != Z_BUF_ERROR) return ret;
  }
  *len = written;
  return Z_OK;
}

struct Call {
  int fd;
  const int64_t* addr;
  const int64_t* size;
  const int64_t* mask;
  const int64_t* first;
  int64_t n_chunks, cn;
  const int32_t* filters;
  const int32_t* filter_es;
  int32_t n_filters, elem_size;
  bool swap;
  EmitFn fn;           // null: strings by emit_bytes
  uint8_t* out;
  int32_t out_size;
  int64_t lo, hi;

  std::atomic<int64_t> next{0};
  std::atomic<int64_t> err_chunk{INT64_MAX};
  std::mutex err_lock;
  int err_rc = 0;
  int64_t err_detail = 0;

  void fail(int64_t k, int rc, int64_t detail) {
    std::lock_guard<std::mutex> hold(err_lock);
    if (k < err_chunk.load()) {
      err_chunk.store(k);
      err_rc = rc;
      err_detail = detail;
    }
  }

  // One thread's share: chunks taken in order from the counter until none
  // is left or one before them has failed (so the failure reported is the
  // first in row order, as the Python loop's). local: chunks and bytes
  // inflated, nanoseconds in zlib and in the unshuffle.
  void work(int64_t* local) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) {
      fail(0, RC_MEMORY, 0);
      return;
    }
    const int64_t chunk_bytes = cn * elem_size;
    std::vector<uint8_t> buf[2];
    int64_t k = 0;
    try {
      // room for a whole chunk and a byte, so one inflate call ends it
      buf[0].resize(chunk_bytes + 1);
      buf[1].resize(chunk_bytes + 1);
      for (;;) {
        k = next.fetch_add(1);
        if (k >= n_chunks || k > err_chunk.load()) break;
        // a bad chunk ends the chunk's work, not the thread's
        int rc = 0;
        int64_t detail = 0;
        std::vector<uint8_t>* cur = &buf[0];
        std::vector<uint8_t>* spare = &buf[1];
        if (static_cast<int64_t>(cur->size()) < size[k]) cur->resize(size[k]);
        int64_t len = 0;
        while (len < size[k]) {
          const ssize_t got = pread(fd, cur->data() + len, size[k] - len,
                                    addr[k] + len);
          if (got <= 0) break;
          len += got;
        }
        if (len != size[k]) {
          fail(k, RC_READ, len);
          continue;
        }
        // the pipeline undone in reverse, filters the mask skips left out;
        // a shuffle by the element size at the end is left to the emit
        int last = -1;
        for (int i = 0; i < n_filters; ++i)
          if (!(mask[k] >> i & 1)) {
            last = i;
            break;
          }
        const bool fused = last >= 0 && filters[last] == FILTER_SHUFFLE &&
                           filter_es[last] == elem_size;
        for (int i = n_filters - 1; i >= 0 && rc == 0; --i) {
          if (mask[k] >> i & 1 || (fused && i == last)) continue;
          const auto t0 = Clock::now();
          if (filters[i] == FILTER_DEFLATE) {
            int64_t n_out = 0;
            const int z = inflate_into(&zs, cur->data(), len, spare, &n_out);
            if (z != Z_OK) {
              rc = RC_INFLATE;
              detail = z;
              break;
            }
            len = n_out;
            local[0] += 1;
            local[1] += n_out;
            local[2] += ns_since(t0);
          } else if (filters[i] == FILTER_SHUFFLE) {
            if (static_cast<int64_t>(spare->size()) < len) spare->resize(len);
            unshuffle(cur->data(), len, filter_es[i], spare->data());
            local[3] += ns_since(t0);
          } else {
            rc = RC_ARGS;
            break;
          }
          std::swap(cur, spare);
        }
        if (rc == 0 && len != chunk_bytes) {
          rc = RC_SIZE;
          detail = len;
        }
        if (rc != 0) {
          fail(k, rc, detail);
          continue;
        }
        const int64_t a = std::max(lo, first[k]);
        const int64_t b = std::min(hi, first[k] + cn);
        if (b <= a) continue;
        const auto t0 = Clock::now();
        uint8_t* dst = out + (a - lo) * out_size;
        if (fn)
          fn(cur->data(), cn, a - first[k], b - a, dst, fused, swap);
        else
          emit_bytes(cur->data(), cn, a - first[k], b - a, elem_size, dst,
                     fused);
        if (fused) local[3] += ns_since(t0);
      }
    } catch (const std::bad_alloc&) {
      fail(k, RC_MEMORY, 0);
    }
    inflateEnd(&zs);
  }
};

}  // namespace

extern "C" {

int mtpu_h5_zlib_declared() { return MTPU_ZLIB_DECLARED; }

// Decodes the n_chunks chunks (file offsets addr, stored sizes, filter
// masks, first rows; cn rows a chunk) of a dataset whose filter pipeline
// is filters[0..n_filters) (1 deflate, 2 shuffle by filter_es bytes), in
// file order, into out: rows [lo, hi), out_size bytes an element. Elements
// are elem_size bytes of type code src_code (0 for a string), swapped
// when swap; dst_code 0 keeps them as stored, I64 or F64 widens them.
// stats (8 int64): chunks and bytes inflated, nanoseconds in zlib and in
// the unshuffle (each summed over threads), the failing chunk's index and
// a detail. Returns 0, or one of the RC_* codes above.
int mtpu_h5_decode_chunks(int fd, const int64_t* addr, const int64_t* size,
                          const int64_t* mask, const int64_t* first,
                          int64_t n_chunks, int64_t cn,
                          const int32_t* filters, const int32_t* filter_es,
                          int32_t n_filters, int32_t elem_size,
                          int32_t src_code, int32_t swap, void* out,
                          int32_t dst_code, int32_t out_size, int64_t lo,
                          int64_t hi, int32_t n_threads, int64_t* stats) {
  std::memset(stats, 0, 8 * sizeof(int64_t));
  stats[4] = -1;
  if (n_chunks <= 0) return 0;
  EmitFn fn = pick_emit(src_code, dst_code, elem_size);
  const bool bytes = dst_code == RAW && src_code == RAW && !swap;
  if ((!fn && !bytes) || cn <= 0 || elem_size <= 0 ||
      (dst_code == RAW && out_size != elem_size))
    return RC_ARGS;
  Call call;
  call.fd = fd;
  call.addr = addr;
  call.size = size;
  call.mask = mask;
  call.first = first;
  call.n_chunks = n_chunks;
  call.cn = cn;
  call.filters = filters;
  call.filter_es = filter_es;
  call.n_filters = n_filters;
  call.elem_size = elem_size;
  call.swap = swap != 0;
  call.fn = fn;
  call.out = static_cast<uint8_t*>(out);
  call.out_size = out_size;
  call.lo = lo;
  call.hi = hi;
  const int64_t n = std::max<int64_t>(
      1, std::min<int64_t>(n_threads > 0 ? n_threads : 1, n_chunks));
  std::vector<int64_t> local(4 * n, 0);
  std::vector<std::thread> pool;
  try {
    for (int64_t t = 1; t < n; ++t)
      pool.emplace_back([&call, &local, t] { call.work(&local[4 * t]); });
  } catch (const std::exception&) {
    call.fail(0, RC_MEMORY, 0);
  }
  call.work(&local[0]);
  for (auto& th : pool) th.join();
  for (int64_t t = 0; t < n; ++t)
    for (int i = 0; i < 4; ++i) stats[i] += local[4 * t + i];
  if (call.err_rc != 0) {
    stats[4] = call.err_chunk.load();
    stats[5] = call.err_detail;
    return call.err_rc;
  }
  return 0;
}

}  // extern "C"
