// gp_codec — native hot-path wire codec for the client serving plane.
//
// The serving hot path used to spend its per-request budget in JSON
// (json.dumps/loads per frame under the GIL, serialized with the engine
// tick).  The binary 'R' (request batch) / 'S' (response batch) frames
// move that cost into fixed-layout scans that run here with the GIL
// released (ctypes drops it for the call), so transport threads make
// progress while the tick thread holds the state lock.  The pure-Python
// fallback in net/hot_codec.py produces byte-identical frames
// (GP_NO_NATIVE=1 or no toolchain); parity is pinned by golden-bytes
// tests.
//
// Wire layouts (little-endian, after the 1-byte kind):
//   'R': sender:i32 count:u32 then per item
//        rid:u64 flags:u8 name_len:u16 value_len:u32 name value [trace]
//        (flags bit0 = stop, bit1 = trace context present)
//   'S': sender:i32 count:u32 then per item
//        rid:u64 err:u8 has:u8 name_len:u16 resp_len:u32 name resp [trace]
//        (has bit0 = response present, bit1 = trace context present)
//   [trace] (only when the bit is set): tid:u64 origin:i32 hop:u8 —
//        the cross-node trace context (obs/reqtrace.py).  Untraced items
//        carry NO extra bytes: frames without trace contexts are
//        byte-identical to the pre-trace wire format.
//
// Exposed C ABI (ctypes):
//   int64_t gpc_req_index(buf, len, out_i64, max_items)
//     -> item count; out[i*9..] = rid, flags, name_off, name_len,
//        value_off, value_len, tid, origin, hop.  -1 on malformed frame.
//   int64_t gpc_resp_index(buf, len, out_i64, max_items)
//     -> item count; out[i*10..] = rid, err, has, name_off, name_len,
//        resp_off, resp_len, tid, origin, hop.  -1 on malformed frame.
//   int64_t gpc_pack_req(out, cap, sender, n, rids, flags,
//                        name_ptrs, name_lens, val_ptrs, val_lens,
//                        tids, origins, hops)
//   int64_t gpc_pack_resp(out, cap, sender, n, rids, errs, has,
//                         name_ptrs, name_lens, resp_ptrs, resp_lens,
//                         tids, origins, hops)
//     -> bytes written, or -1 when cap is too small.  The trace arrays
//        are read only at indexes whose flag/has trace bit is set.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kHdr = 9;    // kind + sender i32 + count u32
constexpr int kTrace = 13; // tid u64 + origin i32 + hop u8
constexpr uint8_t kTraceBit = 0x02;

inline void put_u32le(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
  p[2] = static_cast<uint8_t>(v >> 16);
  p[3] = static_cast<uint8_t>(v >> 24);
}

inline void put_u64le(uint8_t* p, uint64_t v) {
  put_u32le(p, static_cast<uint32_t>(v));
  put_u32le(p + 4, static_cast<uint32_t>(v >> 32));
}

inline void put_u16le(uint8_t* p, uint16_t v) {
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
}

inline uint32_t get_u32le(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

inline uint64_t get_u64le(const uint8_t* p) {
  return static_cast<uint64_t>(get_u32le(p)) |
         (static_cast<uint64_t>(get_u32le(p + 4)) << 32);
}

inline uint16_t get_u16le(const uint8_t* p) {
  return static_cast<uint16_t>(p[0] | (p[1] << 8));
}

// parse the optional trace tail shared by both item layouts; returns
// false on truncation.  o[0..2] receive tid, origin, hop (zeros when
// the bit is unset).
inline bool get_trace(const uint8_t* buf, uint64_t len, uint64_t* off,
                      bool present, int64_t* o) {
  if (!present) {
    o[0] = 0;
    o[1] = 0;
    o[2] = 0;
    return true;
  }
  if (*off + kTrace > len) return false;
  o[0] = static_cast<int64_t>(get_u64le(buf + *off));
  o[1] = static_cast<int32_t>(get_u32le(buf + *off + 8));
  o[2] = buf[*off + 12];
  *off += kTrace;
  return true;
}

inline void put_trace(uint8_t* out, uint64_t* off, uint64_t tid,
                      int32_t origin, uint8_t hop) {
  put_u64le(out + *off, tid);
  put_u32le(out + *off + 8, static_cast<uint32_t>(origin));
  out[*off + 12] = hop;
  *off += kTrace;
}

}  // namespace

extern "C" {

int64_t gpc_req_index(const uint8_t* buf, uint64_t len, int64_t* out,
                      uint32_t max_items) {
  if (len < kHdr || buf[0] != 'R') return -1;
  uint32_t count = get_u32le(buf + 5);
  if (count > max_items) return -1;
  uint64_t off = kHdr;
  for (uint32_t i = 0; i < count; ++i) {
    if (off + 15 > len) return -1;
    uint64_t rid = get_u64le(buf + off);
    uint8_t flags = buf[off + 8];
    uint16_t name_len = get_u16le(buf + off + 9);
    uint32_t val_len = get_u32le(buf + off + 11);
    off += 15;
    if (off + name_len + static_cast<uint64_t>(val_len) > len) return -1;
    int64_t* o = out + static_cast<uint64_t>(i) * 9;
    o[0] = static_cast<int64_t>(rid);
    o[1] = flags;
    o[2] = static_cast<int64_t>(off);
    o[3] = name_len;
    o[4] = static_cast<int64_t>(off + name_len);
    o[5] = val_len;
    off += name_len + static_cast<uint64_t>(val_len);
    if (!get_trace(buf, len, &off, (flags & kTraceBit) != 0, o + 6)) {
      return -1;
    }
  }
  if (off != len) return -1;  // trailing garbage = framing bug upstream
  return count;
}

int64_t gpc_resp_index(const uint8_t* buf, uint64_t len, int64_t* out,
                       uint32_t max_items) {
  if (len < kHdr || buf[0] != 'S') return -1;
  uint32_t count = get_u32le(buf + 5);
  if (count > max_items) return -1;
  uint64_t off = kHdr;
  for (uint32_t i = 0; i < count; ++i) {
    if (off + 16 > len) return -1;
    uint64_t rid = get_u64le(buf + off);
    uint8_t err = buf[off + 8];
    uint8_t has = buf[off + 9];
    uint16_t name_len = get_u16le(buf + off + 10);
    uint32_t resp_len = get_u32le(buf + off + 12);
    off += 16;
    if (off + name_len + static_cast<uint64_t>(resp_len) > len) return -1;
    int64_t* o = out + static_cast<uint64_t>(i) * 10;
    o[0] = static_cast<int64_t>(rid);
    o[1] = err;
    o[2] = has;
    o[3] = static_cast<int64_t>(off);
    o[4] = name_len;
    o[5] = static_cast<int64_t>(off + name_len);
    o[6] = resp_len;
    off += name_len + static_cast<uint64_t>(resp_len);
    if (!get_trace(buf, len, &off, (has & kTraceBit) != 0, o + 7)) {
      return -1;
    }
  }
  if (off != len) return -1;
  return count;
}

int64_t gpc_pack_req(uint8_t* out, uint64_t cap, int32_t sender, uint32_t n,
                     const uint64_t* rids, const uint8_t* flags,
                     const uint8_t** name_ptrs, const uint16_t* name_lens,
                     const uint8_t** val_ptrs, const uint32_t* val_lens,
                     const uint64_t* tids, const int32_t* origins,
                     const uint8_t* hops) {
  uint64_t total = kHdr;
  for (uint32_t i = 0; i < n; ++i) {
    total += 15 + name_lens[i] + static_cast<uint64_t>(val_lens[i]) +
             ((flags[i] & kTraceBit) ? kTrace : 0);
  }
  if (total > cap) return -1;
  out[0] = 'R';
  put_u32le(out + 1, static_cast<uint32_t>(sender));
  put_u32le(out + 5, n);
  uint64_t off = kHdr;
  for (uint32_t i = 0; i < n; ++i) {
    put_u64le(out + off, rids[i]);
    out[off + 8] = flags[i];
    put_u16le(out + off + 9, name_lens[i]);
    put_u32le(out + off + 11, val_lens[i]);
    off += 15;
    std::memcpy(out + off, name_ptrs[i], name_lens[i]);
    off += name_lens[i];
    std::memcpy(out + off, val_ptrs[i], val_lens[i]);
    off += val_lens[i];
    if (flags[i] & kTraceBit) {
      put_trace(out, &off, tids[i], origins[i], hops[i]);
    }
  }
  return static_cast<int64_t>(off);
}

int64_t gpc_pack_resp(uint8_t* out, uint64_t cap, int32_t sender, uint32_t n,
                      const uint64_t* rids, const uint8_t* errs,
                      const uint8_t* has,
                      const uint8_t** name_ptrs, const uint16_t* name_lens,
                      const uint8_t** resp_ptrs, const uint32_t* resp_lens,
                      const uint64_t* tids, const int32_t* origins,
                      const uint8_t* hops) {
  uint64_t total = kHdr;
  for (uint32_t i = 0; i < n; ++i) {
    total += 16 + name_lens[i] + static_cast<uint64_t>(resp_lens[i]) +
             ((has[i] & kTraceBit) ? kTrace : 0);
  }
  if (total > cap) return -1;
  out[0] = 'S';
  put_u32le(out + 1, static_cast<uint32_t>(sender));
  put_u32le(out + 5, n);
  uint64_t off = kHdr;
  for (uint32_t i = 0; i < n; ++i) {
    put_u64le(out + off, rids[i]);
    out[off + 8] = errs[i];
    out[off + 9] = has[i];
    put_u16le(out + off + 10, name_lens[i]);
    put_u32le(out + off + 12, resp_lens[i]);
    off += 16;
    std::memcpy(out + off, name_ptrs[i], name_lens[i]);
    off += name_lens[i];
    std::memcpy(out + off, resp_ptrs[i], resp_lens[i]);
    off += resp_lens[i];
    if (has[i] & kTraceBit) {
      put_trace(out, &off, tids[i], origins[i], hops[i]);
    }
  }
  return static_cast<int64_t>(off);
}

}  // extern "C"
