// gp_journal — native journal appender for the durability hot path.
//
// The reference's journal is its own hot path (SQLPaxosLogger.Journaler,
// SQLPaxosLogger.java:685-711: append-only files, group-commit, fsync).
// Here the framed append (header build + CRC32 + write [+ fsync]) runs in
// C++ behind ctypes: one buffer assembly and one write(2) per block, with
// a zlib-compatible CRC so journals stay readable by the Python scanner.
//
// Exposed C ABI (ctypes):
//   uint32_t gpj_crc32(const uint8_t* data, uint32_t n);
//   int64_t  gpj_append(int fd, uint8_t btype, uint32_t n_rows,
//                       const uint8_t* payload, uint32_t len, int do_sync);
//     -> new file offset after the write, or -1 on error.

#include <cstdint>
#include <cstring>
#include <sys/uio.h>
#include <unistd.h>

namespace {

// zlib-compatible CRC-32 (polynomial 0xEDB88320), table generated once.
uint32_t kCrcTable[256];
bool kTableReady = false;

void init_table() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) {
      c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
    }
    kCrcTable[i] = c;
  }
  kTableReady = true;
}

inline uint32_t crc32_update(uint32_t crc, const uint8_t* buf, uint32_t len) {
  if (!kTableReady) init_table();
  crc ^= 0xFFFFFFFFu;
  for (uint32_t i = 0; i < len; ++i) {
    crc = kCrcTable[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  }
  return crc ^ 0xFFFFFFFFu;
}

// Wire header (journal.py): magic:u32 type:u8 n_rows:u32 len:u32 crc:u32,
// little-endian, packed (17 bytes).
constexpr uint32_t kMagic = 0x47504A4C;  // "GPJL"
constexpr int kHdrSize = 17;

inline void put_u32le(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
  p[2] = static_cast<uint8_t>(v >> 16);
  p[3] = static_cast<uint8_t>(v >> 24);
}

bool write_all(int fd, const uint8_t* buf, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t w = ::write(fd, buf + off, n - off);
    if (w < 0) return false;
    off += static_cast<size_t>(w);
  }
  return true;
}

}  // namespace

extern "C" {

uint32_t gpj_crc32(const uint8_t* data, uint32_t n) {
  return crc32_update(0, data, n);
}

int64_t gpj_append(int fd, uint8_t btype, uint32_t n_rows,
                   const uint8_t* payload, uint32_t len, int do_sync) {
  // One writev(2) for header+payload (no copy, no extra syscall); the
  // caller tracks the file offset (O_APPEND keeps writes at EOF).
  uint8_t hdr[kHdrSize];
  put_u32le(hdr, kMagic);
  hdr[4] = btype;
  put_u32le(hdr + 5, n_rows);
  put_u32le(hdr + 9, len);
  put_u32le(hdr + 13, crc32_update(0, payload, len));
  struct iovec iov[2];
  iov[0].iov_base = hdr;
  iov[0].iov_len = kHdrSize;
  iov[1].iov_base = const_cast<uint8_t*>(payload);
  iov[1].iov_len = len;
  size_t total = kHdrSize + static_cast<size_t>(len);
  ssize_t w = ::writev(fd, iov, len ? 2 : 1);
  if (w < 0) return -1;
  if (static_cast<size_t>(w) != total) {
    // partial writev (rare): finish byte-wise from where it stopped
    size_t off = static_cast<size_t>(w);
    if (off < kHdrSize) {
      if (!write_all(fd, hdr + off, kHdrSize - off)) return -1;
      off = kHdrSize;
    }
    if (!write_all(fd, payload + (off - kHdrSize), total - off)) return -1;
  }
  if (do_sync && ::fsync(fd) != 0) return -1;
  return static_cast<int64_t>(total);
}

int64_t gpj_append_batch(int fd, const uint8_t* btypes,
                         const uint32_t* n_rows, const uint8_t** payloads,
                         const uint32_t* lens, uint32_t n_blocks,
                         int do_sync) {
  // Group commit (BatchedLogger analog, AbstractPaxosLogger.java:656):
  // all of a tick's blocks leave in ONE writev + at most one fsync.
  if (n_blocks == 0) return 0;
  constexpr uint32_t kMax = 64;
  if (n_blocks > kMax) return -2;  // caller splits
  uint8_t hdrs[kMax * kHdrSize];
  struct iovec iov[kMax * 2];
  int niov = 0;
  size_t total = 0;
  for (uint32_t i = 0; i < n_blocks; ++i) {
    uint8_t* h = hdrs + i * kHdrSize;
    put_u32le(h, kMagic);
    h[4] = btypes[i];
    put_u32le(h + 5, n_rows[i]);
    put_u32le(h + 9, lens[i]);
    put_u32le(h + 13, crc32_update(0, payloads[i], lens[i]));
    iov[niov].iov_base = h;
    iov[niov].iov_len = kHdrSize;
    ++niov;
    if (lens[i]) {
      iov[niov].iov_base = const_cast<uint8_t*>(payloads[i]);
      iov[niov].iov_len = lens[i];
      ++niov;
    }
    total += kHdrSize + lens[i];
  }
  size_t written = 0;
  int first = 0;
  while (written < total) {
    ssize_t w = ::writev(fd, iov + first, niov - first);
    if (w < 0) return -1;
    written += static_cast<size_t>(w);
    // advance the iovec cursor past fully-written entries
    size_t acc = static_cast<size_t>(w);
    while (first < niov && acc >= iov[first].iov_len) {
      acc -= iov[first].iov_len;
      ++first;
    }
    if (first < niov && acc) {
      iov[first].iov_base = static_cast<uint8_t*>(iov[first].iov_base) + acc;
      iov[first].iov_len -= acc;
    }
  }
  if (do_sync && ::fsync(fd) != 0) return -1;
  return static_cast<int64_t>(total);
}

}  // extern "C"
