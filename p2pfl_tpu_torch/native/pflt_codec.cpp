// Native assembly of a PFLT weights frame (the port's copy of the JAX
// package's p2pfl_tpu/native/pflt_codec.cpp; same layout, same bytes).
//
// Every weights gossip frame is a PFLT buffer (ops/serialization.py). The
// pure-Python path builds it as one bytes object per tensor (tobytes) joined
// into the frame; here the frame is written in a single pass of memcpy into
// one caller-allocated buffer. The payload CRC is computed by zlib.crc32 on
// the Python side; the codec only embeds the value it is given.
//
// Layout v2 (must match ops/serialization.py exactly):
//   "PFLT" | u16 version | u32 header_len | u32 crc32 | header | pad to 64
//   | tensor0 bytes | pad to 64 | tensor1 bytes | pad to 64 | ...
// crc32 covers header bytes + raw tensor bytes (no padding); 0 = unchecked.
// Integers are little-endian: the hosts this runs on (x86-64, aarch64) are.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr size_t kAlign = 64;
constexpr size_t kPrefix = 4 + 2 + 4 + 4;  // magic + version + hlen + crc
constexpr char kMagic[4] = {'P', 'F', 'L', 'T'};

inline size_t pad_to_align(size_t n) { return (kAlign - (n % kAlign)) % kAlign; }

}  // namespace

extern "C" {

// Total encoded size for a header of `header_len` bytes plus n tensors.
size_t pflt_packed_size(const size_t* sizes, size_t n, size_t header_len) {
  size_t off = kPrefix + header_len;
  off += pad_to_align(off);
  for (size_t i = 0; i < n; i++) {
    off += sizes[i];
    off += pad_to_align(off);
  }
  return off;
}

// Single-pass frame assembly into a caller-allocated buffer of at least
// pflt_packed_size() bytes. Returns bytes written, or -1 on overflow.
int64_t pflt_pack(uint8_t* dst, size_t dst_cap, uint16_t version, uint32_t crc,
                  const uint8_t* header, size_t header_len,
                  const uint8_t* const* srcs, const size_t* sizes, size_t n) {
  if (pflt_packed_size(sizes, n, header_len) > dst_cap) return -1;
  size_t off = 0;
  std::memcpy(dst, kMagic, 4);
  off += 4;
  std::memcpy(dst + off, &version, 2);
  off += 2;
  uint32_t hlen32 = static_cast<uint32_t>(header_len);
  std::memcpy(dst + off, &hlen32, 4);
  off += 4;
  std::memcpy(dst + off, &crc, 4);
  off += 4;
  std::memcpy(dst + off, header, header_len);
  off += header_len;
  size_t p = pad_to_align(off);
  std::memset(dst + off, 0, p);
  off += p;
  for (size_t i = 0; i < n; i++) {
    if (sizes[i] != 0) std::memcpy(dst + off, srcs[i], sizes[i]);
    off += sizes[i];
    p = pad_to_align(off);
    std::memset(dst + off, 0, p);
    off += p;
  }
  return static_cast<int64_t>(off);
}

}  // extern "C"
