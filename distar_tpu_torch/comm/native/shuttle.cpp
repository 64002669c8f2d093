// Framed socket shuttle, LZ4-block codec and CRC-32 for the data plane.
//
// Counterpart of distar_tpu/comm/native/shuttle.cpp, copied so that the two
// packages write the same bytes: the LZ4 stream of a payload and its CRC are
// equal bit for bit. Host C++, built with g++ at first use by
// distar_tpu_torch/comm/shuttle.py and loaded with ctypes; every call runs
// with the GIL released.
//
// Wire format of the shuttle: 8-byte big-endian length + payload (matches
// distar_tpu_torch/comm/serializer.py frame()).
//
// Exposed C ABI (ctypes):
//   int  shuttle_serve(const uint8_t* data, uint64_t len, int accept_count,
//                      int timeout_ms)      -> listening port (<0 on error);
//                      detaches a thread that serves the payload to up to
//                      accept_count connections, then closes.
//   int  shuttle_fetch(const char* host, int port, int timeout_ms,
//                      uint8_t** out, uint64_t* out_len) -> 0 on success;
//                      caller frees with shuttle_free.
//   void shuttle_free(uint8_t* p)
#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

bool send_all(int fd, const uint8_t* buf, uint64_t len) {
  uint64_t sent = 0;
  while (sent < len) {
    ssize_t n = ::send(fd, buf + sent, len - sent, MSG_NOSIGNAL);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR)) continue;
      return false;
    }
    sent += static_cast<uint64_t>(n);
  }
  return true;
}

bool recv_all(int fd, uint8_t* buf, uint64_t len, int timeout_ms) {
  uint64_t got = 0;
  while (got < len) {
    pollfd p{fd, POLLIN, 0};
    int pr = ::poll(&p, 1, timeout_ms);
    if (pr <= 0) return false;
    ssize_t n = ::recv(fd, buf + got, len - got, 0);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return false;
    }
    got += static_cast<uint64_t>(n);
  }
  return true;
}

void write_be64(uint8_t* out, uint64_t v) {
  for (int i = 7; i >= 0; --i) {
    out[7 - i] = static_cast<uint8_t>((v >> (8 * i)) & 0xff);
  }
}

uint64_t read_be64(const uint8_t* in) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | in[i];
  return v;
}

}  // namespace

extern "C" {

int shuttle_serve(const uint8_t* data, uint64_t len, int accept_count, int timeout_ms) {
  int listener = ::socket(AF_INET, SOCK_STREAM, 0);
  if (listener < 0) return -1;
  int one = 1;
  ::setsockopt(listener, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = 0;  // ephemeral
  if (::bind(listener, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(listener, 16) < 0) {
    ::close(listener);
    return -2;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(listener, reinterpret_cast<sockaddr*>(&addr), &alen);
  int port = ntohs(addr.sin_port);

  // own the payload: the Python buffer is only valid during this call
  std::vector<uint8_t>* payload = new std::vector<uint8_t>(len + 8);
  write_be64(payload->data(), len);
  std::memcpy(payload->data() + 8, data, len);

  std::thread([listener, payload, accept_count, timeout_ms]() {
    for (int i = 0; i < accept_count; ++i) {
      pollfd p{listener, POLLIN, 0};
      if (::poll(&p, 1, timeout_ms) <= 0) break;  // nobody came: expire
      int conn = ::accept(listener, nullptr, nullptr);
      if (conn < 0) break;
      int one = 1;
      ::setsockopt(conn, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      send_all(conn, payload->data(), payload->size());
      ::shutdown(conn, SHUT_WR);
      ::close(conn);
    }
    ::close(listener);
    delete payload;
  }).detach();

  return port;
}

int shuttle_fetch(const char* host, int port, int timeout_ms, uint8_t** out, uint64_t* out_len) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return -2;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -3;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  uint8_t hdr[8];
  if (!recv_all(fd, hdr, 8, timeout_ms)) {
    ::close(fd);
    return -4;
  }
  uint64_t len = read_be64(hdr);
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(len));
  if (buf == nullptr) {
    ::close(fd);
    return -5;
  }
  if (!recv_all(fd, buf, len, timeout_ms)) {
    std::free(buf);
    ::close(fd);
    return -6;
  }
  ::close(fd);
  *out = buf;
  *out_len = len;
  return 0;
}

void shuttle_free(uint8_t* p) { std::free(p); }

// --------------------------------------------------------------------------
// LZ4-block-format codec (public format: lz4 block spec) for the data plane.
//
// A hash-chain LZ77 encoder emitting the standard LZ4 block stream (token
// nibbles, 255-run length extensions, little-endian 16-bit offsets, >=4-byte
// matches, tail literals) with no dependency; the serializer's DTL0 frames
// carry it.
//
//   int64_t shuttlez_compress(src, len, dst, cap)   -> compressed size
//   int64_t shuttlez_decompress(src, len, dst, cap) -> decompressed size
//   uint64_t shuttlez_bound(len)                    -> worst-case dst size
// Both return <0 on error (cap too small / malformed stream).

namespace {

inline uint32_t read_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

constexpr int kHashBits = 16;
constexpr int kHashSize = 1 << kHashBits;

inline uint32_t hash4(uint32_t v) {
  // Fibonacci hashing of the 4-byte window
  return (v * 2654435761u) >> (32 - kHashBits);
}

constexpr int kMinMatch = 4;
constexpr int kLastLiterals = 5;       // spec: last 5 bytes are literals
constexpr int kMFLimit = 12;           // spec: last match starts >=12 bytes from end
constexpr int kMaxOffset = 65535;

inline uint8_t* put_length(uint8_t* op, uint64_t len) {
  while (len >= 255) {
    *op++ = 255;
    len -= 255;
  }
  *op++ = static_cast<uint8_t>(len);
  return op;
}

}  // namespace

uint64_t shuttlez_bound(uint64_t len) { return len + len / 255 + 16; }

int64_t shuttlez_compress(const uint8_t* src, uint64_t len, uint8_t* dst, uint64_t cap) {
  if (cap < shuttlez_bound(len)) return -1;
  uint8_t* op = dst;
  if (len < kMFLimit + 1) {
    // too small to match: one literal-only sequence
    uint8_t token = len < 15 ? static_cast<uint8_t>(len) << 4 : 0xF0;
    *op++ = token;
    if (len >= 15) op = put_length(op, len - 15);
    std::memcpy(op, src, len);
    return (op + len) - dst;
  }
  std::vector<uint32_t> table(kHashSize, 0);  // position + 1 (0 = empty)
  const uint64_t matchlimit = len - kLastLiterals;  // matches may extend to here
  const uint64_t mflimit = len - kMFLimit;          // matches must START before here
  uint64_t anchor = 0;
  uint64_t ip = 0;
  uint64_t search_nb = 1 << 6;  // lz4-style skip acceleration: the longer a
                                // stretch stays matchless (incompressible
                                // float noise), the bigger the stride
  while (ip < mflimit) {
    uint32_t h = hash4(read_u32(src + ip));
    uint64_t cand = table[h] ? table[h] - 1 : UINT64_MAX;
    table[h] = static_cast<uint32_t>(ip + 1);
    if (cand == UINT64_MAX || ip - cand > kMaxOffset ||
        read_u32(src + cand) != read_u32(src + ip)) {
      ip += (search_nb++ >> 6);
      continue;
    }
    search_nb = 1 << 6;
    // extend the match forward
    uint64_t mlen = kMinMatch;
    while (ip + mlen < matchlimit && src[cand + mlen] == src[ip + mlen]) ++mlen;
    // emit sequence: literals [anchor, ip) + match (offset, mlen)
    uint64_t lit = ip - anchor;
    uint8_t* token = op++;
    if (lit >= 15) {
      *token = 0xF0;
      op = put_length(op, lit - 15);
    } else {
      *token = static_cast<uint8_t>(lit) << 4;
    }
    std::memcpy(op, src + anchor, lit);
    op += lit;
    uint16_t offset = static_cast<uint16_t>(ip - cand);
    *op++ = static_cast<uint8_t>(offset & 0xff);
    *op++ = static_cast<uint8_t>(offset >> 8);
    uint64_t mextra = mlen - kMinMatch;
    if (mextra >= 15) {
      *token |= 0x0F;
      op = put_length(op, mextra - 15);
    } else {
      *token |= static_cast<uint8_t>(mextra);
    }
    // index a couple of positions inside the match to help the next search
    uint64_t step_end = ip + mlen;
    for (uint64_t p = ip + 1; p + kMinMatch <= step_end && p + kMinMatch <= mflimit;
         p += (mlen > 64 ? 16 : 4)) {
      table[hash4(read_u32(src + p))] = static_cast<uint32_t>(p + 1);
    }
    ip += mlen;
    anchor = ip;
  }
  // tail literals
  uint64_t lit = len - anchor;
  uint8_t* token = op++;
  if (lit >= 15) {
    *token = 0xF0;
    op = put_length(op, lit - 15);
  } else {
    *token = static_cast<uint8_t>(lit) << 4;
  }
  std::memcpy(op, src + anchor, lit);
  op += lit;
  return op - dst;
}

int64_t shuttlez_decompress(const uint8_t* src, uint64_t len, uint8_t* dst, uint64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + len;
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  while (ip < iend) {
    uint8_t token = *ip++;
    // literals
    uint64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -2;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last sequence has no match
    // match
    if (ip + 2 > iend) return -3;
    uint16_t offset = static_cast<uint16_t>(ip[0] | (ip[1] << 8));
    ip += 2;
    if (offset == 0 || static_cast<uint64_t>(op - dst) < offset) return -4;
    uint64_t mlen = (token & 0x0F);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -5;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += kMinMatch;
    if (op + mlen > oend) return -6;
    const uint8_t* match = op - offset;
    // overlapping copy must be byte-wise
    for (uint64_t i = 0; i < mlen; ++i) op[i] = match[i];
    op += mlen;
  }
  return op - dst;
}

// ------------------------------------------------------------------- crc32
// Slice-by-8 IEEE CRC-32 (the zlib/PNG polynomial, reflected 0xEDB88320):
// bit-identical to Python's zlib.crc32. The shm ring transport checksums
// every payload byte twice (write + verify).

static uint32_t g_crc_tab[8][256];
static bool g_crc_init = false;

static void crc32_init_tables() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    g_crc_tab[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = g_crc_tab[0][i];
    for (int t = 1; t < 8; ++t) {
      c = g_crc_tab[0][c & 0xFF] ^ (c >> 8);
      g_crc_tab[t][i] = c;
    }
  }
  g_crc_init = true;
}

uint32_t shuttlez_crc32(const uint8_t* data, uint64_t len, uint32_t crc) {
  if (!g_crc_init) crc32_init_tables();
  crc = ~crc;
  // align-free 8-byte slices
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    crc ^= static_cast<uint32_t>(word);
    uint32_t hi = static_cast<uint32_t>(word >> 32);
    crc = g_crc_tab[7][crc & 0xFF] ^ g_crc_tab[6][(crc >> 8) & 0xFF] ^
          g_crc_tab[5][(crc >> 16) & 0xFF] ^ g_crc_tab[4][crc >> 24] ^
          g_crc_tab[3][hi & 0xFF] ^ g_crc_tab[2][(hi >> 8) & 0xFF] ^
          g_crc_tab[1][(hi >> 16) & 0xFF] ^ g_crc_tab[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = g_crc_tab[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

}  // extern "C"
