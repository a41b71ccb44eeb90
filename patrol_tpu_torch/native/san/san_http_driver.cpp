// Sanitizer exercise driver for patrol_http.cpp (the C++ epoll HTTP front).
//
// tsan_driver.cpp (beside it) covers the UDP/codec/directory plane; this
// driver covers the OTHER native half — the HTTP front's concurrency
// shape and its hostile-input surface — under TSan, ASan, and UBSan
// (patrol_tpu_torch/scripts/check.sh builds it three times):
//
//   * the epoll thread serving h1 + native-h2 requests, with in-front
//     host-store takes (hls_take_locked) contending the HostStore mutex
//     against a drain thread (≙ the engine pump's drain_locked) and a
//     probe thread (pt_hls_take_probe);
//   * a pump thread on the ring path: pt_http_poll → complete_takes /
//     complete_other, racing the epoll thread on the Server mutex (and,
//     at shutdown, the registry teardown path);
//   * the load clients pt_http_blast / pt_http_blast_h2 from multiple
//     threads (closed-loop h1 pipelining and h2 multiplexing);
//   * hostile inputs while the load runs: oversized/overflowing
//     Content-Length (the ADVICE r5 smuggling surface), truncated h2
//     frames, CONTINUATION floods, RST_STREAM races against ring
//     completions, oversized DATA bodies, absurd frame lengths, and
//     mid-request aborts.
//
// Any sanitizer report fails the run (halt_on_error / no-recover); the
// driver itself also exits non-zero when the server stops answering.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int pt_http_start(const char* ip, uint16_t port);
int pt_http_port(int h);
int pt_http_poll(int h, int timeout_ms, uint64_t* tags, int32_t* streams,
                 uint8_t* names, int* name_lens, int64_t* freqs,
                 int64_t* pers, int64_t* counts, int cap_t, uint64_t* otags,
                 int32_t* ostreams, uint8_t* otargets, int* otarget_lens,
                 uint8_t* omethods, int cap_o, int* n_other);
int pt_http_complete_takes(int h, const uint64_t* tags,
                           const int32_t* streams, const int* statuses,
                           const int64_t* remaining, int n);
int pt_http_complete_other(int h, uint64_t tag, int32_t stream, int status,
                           const char* ctype, const uint8_t* body,
                           int body_len);
int pt_http_stats(int h, uint64_t* out8);
int pt_http_stop(int h);
int pt_http_attach_host(int http_h, int hls_h, int dir_h);
int pt_http_blast(const char* ip, uint16_t port, const char* target,
                  int conns, int pipeline, int duration_ms, uint64_t* out5);
int pt_http_blast_h2(const char* ip, uint16_t port, const char* target,
                     int conns, int pipeline, int duration_ms,
                     uint64_t* out5);
int pt_hls_create(int nodes, int64_t node_slot, int64_t promote_takes,
                  int64_t window_ns, int64_t clock_offset_ns,
                  const int64_t* cap_base, const int64_t* created,
                  int64_t* last_used);
int pt_hls_destroy(int h);
int pt_hls_lock(int h);
int pt_hls_unlock(int h);
int64_t pt_hls_host_locked(int h, int32_t row);
int pt_hls_drain_locked(int h, int32_t* dirty_out, int64_t* snap, int cap_d,
                        int32_t* promote_out, int cap_p, int* n_promote);
int pt_hls_stats(int h, uint64_t* out4);
int64_t pt_hls_events(int h);
int pt_hls_take_probe(int hls_h, int dir_h, const uint8_t* name, int len,
                      int64_t freq, int64_t per_ns, int64_t count,
                      int64_t now, int64_t* remaining);
int pt_dir_create(int64_t capacity, const uint8_t* name_bytes,
                  const int32_t* name_lens);
int pt_dir_insert(int h, uint64_t hash, int32_t row);
int pt_dir_destroy(int h);
}

namespace {

constexpr int kPacket = 256;
constexpr int kPathMax = 2048;
constexpr int kCap = 64;     // directory rows
constexpr int kNodes = 4;
constexpr int kHosted = 8;   // rows served in-front
constexpr int kBlastMs = 500;

uint64_t fnv1a(const char* b, int len) {
  uint64_t h = 0xcbf29ce484222325ULL;
  for (int i = 0; i < len; i++) {
    h ^= (uint8_t)b[i];
    h *= 0x100000001b3ULL;
  }
  return h;
}

// ---- raw hostile clients ---------------------------------------------------

int dial(uint16_t port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
  if (connect(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
    ::close(fd);
    return -1;
  }
  timeval tv{0, 200000};  // 200 ms read cap: hostile conns just probe
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

void send_all(int fd, const char* buf, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t wr = ::send(fd, buf + off, n - off, MSG_NOSIGNAL);
    if (wr <= 0) return;  // server killed the conn: expected for floods
    off += (size_t)wr;
  }
}

void drain(int fd) {
  char buf[4096];
  while (recv(fd, buf, sizeof(buf), 0) > 0) {
  }
}

void frame_hdr(std::string& out, size_t len, int type, uint8_t flags,
               int32_t stream) {
  out.push_back((char)((len >> 16) & 0xFF));
  out.push_back((char)((len >> 8) & 0xFF));
  out.push_back((char)(len & 0xFF));
  out.push_back((char)type);
  out.push_back((char)flags);
  out.push_back((char)((stream >> 24) & 0x7F));
  out.push_back((char)((stream >> 16) & 0xFF));
  out.push_back((char)((stream >> 8) & 0xFF));
  out.push_back((char)(stream & 0xFF));
}

const char kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";

void hostile_h1(uint16_t port) {
  // Overflowing 23-digit Content-Length with a smuggled "request" body.
  int fd = dial(port);
  if (fd >= 0) {
    const char req[] =
        "POST /take/ovcl?rate=5:1s HTTP/1.1\r\nHost: x\r\n"
        "Content-Length: 99999999999999999999999\r\n\r\n"
        "GET /smuggled HTTP/1.1\r\nHost: x\r\n\r\n";
    send_all(fd, req, sizeof(req) - 1);
    drain(fd);
    ::close(fd);
  }
  // Oversized-but-parseable Content-Length (over the sane bound).
  fd = dial(port);
  if (fd >= 0) {
    const char req[] =
        "POST /take/big?rate=5:1s HTTP/1.1\r\nHost: x\r\n"
        "Content-Length: 2147483648\r\n\r\n";
    send_all(fd, req, sizeof(req) - 1);
    drain(fd);
    ::close(fd);
  }
  // Garbage request line, then abort mid-header on a fresh conn.
  fd = dial(port);
  if (fd >= 0) {
    send_all(fd, "NOT-HTTP\r\n\r\n", 12);
    drain(fd);
    ::close(fd);
  }
  fd = dial(port);
  if (fd >= 0) {
    send_all(fd, "POST /take/abort?rate=", 22);
    ::close(fd);  // mid-request abort: slot reap path
  }
  // Header flood past the rbuf cap (431 + close).
  fd = dial(port);
  if (fd >= 0) {
    std::string req = "GET / HTTP/1.1\r\n";
    while (req.size() < 20000) req += "X-Pad: aaaaaaaaaaaaaaaaaaaaaaaa\r\n";
    send_all(fd, req.data(), req.size());
    drain(fd);
    ::close(fd);
  }
  // Legit body drain (valid Content-Length + pipelined next request).
  fd = dial(port);
  if (fd >= 0) {
    std::string body(70000, 'z');
    std::string req = "POST /take/bd?rate=5:1s HTTP/1.1\r\nHost: x\r\n"
                      "Content-Length: " + std::to_string(body.size()) +
                      "\r\n\r\n" + body;
    req += "POST /take/bd?rate=5:1s HTTP/1.1\r\nHost: x\r\n\r\n";
    send_all(fd, req.data(), req.size());
    drain(fd);
    ::close(fd);
  }
}

void hostile_h2(uint16_t port) {
  // Truncated frame: header claims 1000 bytes, 4 arrive, then close.
  int fd = dial(port);
  if (fd >= 0) {
    std::string req(kPreface, sizeof(kPreface) - 1);
    frame_hdr(req, 0, 0x4, 0, 0);  // SETTINGS
    frame_hdr(req, 1000, 0x0, 0, 1);
    req += "xxxx";
    send_all(fd, req.data(), req.size());
    drain(fd);
    ::close(fd);
  }
  // CONTINUATION flood: header block grows past the 64 KiB bound.
  fd = dial(port);
  if (fd >= 0) {
    std::string req(kPreface, sizeof(kPreface) - 1);
    frame_hdr(req, 0, 0x4, 0, 0);
    std::string junk(16000, 'h');
    frame_hdr(req, junk.size(), 0x1, 0, 1);  // HEADERS, no END_HEADERS
    req += junk;
    for (int i = 0; i < 8; i++) {  // 128 KB of CONTINUATION
      frame_hdr(req, junk.size(), 0x9, 0, 1);
      req += junk;
    }
    send_all(fd, req.data(), req.size());
    drain(fd);
    ::close(fd);
  }
  // RST_STREAM races: reset a never-opened stream, reset after END_STREAM
  // HEADERS (ring completion must be dropped), zero-len PING, absurd frame.
  fd = dial(port);
  if (fd >= 0) {
    std::string req(kPreface, sizeof(kPreface) - 1);
    frame_hdr(req, 0, 0x4, 0, 0);
    frame_hdr(req, 4, 0x3, 0, 7);  // RST of an idle stream
    req.append("\0\0\0\x8", 4);
    frame_hdr(req, 3, 0x6, 0, 0);  // PING with wrong length (ignored)
    req += "abc";
    send_all(fd, req.data(), req.size());
    drain(fd);
    ::close(fd);
  }
  fd = dial(port);
  if (fd >= 0) {
    std::string req(kPreface, sizeof(kPreface) - 1);
    frame_hdr(req, (size_t)2 << 20, 0x0, 0, 1);  // absurd len: conn killed
    req += "zz";
    send_all(fd, req.data(), req.size());
    drain(fd);
    ::close(fd);
  }
  // Oversized DATA body on one stream (per-stream window credit path):
  // HEADERS without END_STREAM needs a real HPACK block, which the
  // driver cannot build without a deflater — send DATA on an unopened
  // stream instead (server tolerates and credits windows).
  fd = dial(port);
  if (fd >= 0) {
    std::string req(kPreface, sizeof(kPreface) - 1);
    frame_hdr(req, 0, 0x4, 0, 0);
    std::string body(16000, 'b');
    for (int i = 0; i < 6; i++) {  // ~96 KiB > both windows' hysteresis
      frame_hdr(req, body.size(), 0x0, 0, 1);
      req += body;
    }
    send_all(fd, req.data(), req.size());
    drain(fd);
    ::close(fd);
  }
}

}  // namespace

int main() {
  int hs = pt_http_start("127.0.0.1", 0);
  if (hs < 0) {
    fprintf(stderr, "pt_http_start failed: %d\n", hs);
    return 1;
  }
  uint16_t port = (uint16_t)pt_http_port(hs);

  // Directory + host store: rows 0..kHosted-1 are in-front residents.
  std::vector<uint8_t> name_bytes((size_t)kCap * kPacket, 0);
  std::vector<int32_t> name_lens(kCap, 0);
  int dir = pt_dir_create(kCap, name_bytes.data(), name_lens.data());
  std::string targets_h1, targets_h2;
  for (int r = 0; r < kHosted; r++) {
    char nm[32];
    int n = snprintf(nm, sizeof nm, "hot-%d", r);
    memcpy(&name_bytes[(size_t)r * kPacket], nm, n);
    name_lens[r] = n;
    pt_dir_insert(dir, fnv1a(nm, n), r);
    ((r % 2) ? targets_h2 : targets_h1) +=
        "/take/" + std::string(nm) + "?rate=1000:1s\n";
  }
  // Ring-path names (unknown to the directory).
  targets_h1 += "/take/ring-a?rate=100:1s\n/metrics\n";
  targets_h2 += "/take/ring-b?rate=100:1s\n";

  std::vector<int64_t> cap_base(kCap, 0), created(kCap, 0), last_used(kCap, 0);
  int hls = pt_hls_create(kNodes, 0, /*promote_takes=*/64,
                          100 * 1000 * 1000LL, 0, cap_base.data(),
                          created.data(), last_used.data());
  pt_hls_lock(hls);
  for (int r = 0; r < kHosted; r++) pt_hls_host_locked(hls, r);
  pt_hls_unlock(hls);
  pt_http_attach_host(hs, hls, dir);

  std::atomic<bool> stop{false};

  // Ring pump (≙ net/native_http.py _pump + _completer, minus Python).
  std::thread pump([&] {
    constexpr int CT = 256, CO = 64;
    std::vector<uint64_t> tags(CT), otags(CO);
    std::vector<int32_t> streams(CT), ostreams(CO);
    std::vector<uint8_t> names((size_t)CT * kPacket),
        otargets((size_t)CO * kPathMax), omethods((size_t)CO * 8);
    std::vector<int> nlens(CT), otlens(CO), statuses(CT);
    std::vector<int64_t> freqs(CT), pers(CT), counts(CT), remaining(CT);
    while (!stop.load()) {
      int n_other = 0;
      int nt = pt_http_poll(hs, 10, tags.data(), streams.data(),
                            names.data(), nlens.data(), freqs.data(),
                            pers.data(), counts.data(), CT, otags.data(),
                            ostreams.data(), otargets.data(), otlens.data(),
                            omethods.data(), CO, &n_other);
      if (nt < 0) return;
      for (int i = 0; i < nt; i++) {
        statuses[i] = (freqs[i] > 0) ? 200 : 429;
        remaining[i] = freqs[i] > 0 ? freqs[i] - 1 : 0;
      }
      if (nt > 0)
        pt_http_complete_takes(hs, tags.data(), streams.data(),
                               statuses.data(), remaining.data(), nt);
      for (int j = 0; j < n_other; j++) {
        const char body[] = "ok\n";
        pt_http_complete_other(hs, otags[j], ostreams[j], 200, "text/plain",
                               (const uint8_t*)body, 3);
      }
    }
  });

  // Drain thread (≙ engine drain_native_broadcasts under _host_mu).
  std::thread drainer([&] {
    std::vector<int32_t> dirty(256), prom(64);
    std::vector<int64_t> snap((size_t)256 * (2 * kNodes + 1));
    uint64_t out4[4];
    while (!stop.load()) {
      int np = 0;
      pt_hls_lock(hls);
      pt_hls_drain_locked(hls, dirty.data(), snap.data(), 256, prom.data(),
                          64, &np);
      pt_hls_unlock(hls);
      pt_hls_stats(hls, out4);
      pt_hls_events(hls);
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  });

  // Probe thread: the exact in-front take path from a second thread.
  std::thread prober([&] {
    int64_t rem = 0, now = 1;
    while (!stop.load()) {
      pt_hls_take_probe(hls, dir, (const uint8_t*)"hot-0", 5, 1000,
                        1000000000LL, 1, now, &rem);
      now += 1000000;
      std::this_thread::sleep_for(std::chrono::microseconds(200));
    }
  });

  // Hostile clients interleave with the load below.
  std::thread hostiles([&] {
    while (!stop.load()) {
      hostile_h1(port);
      hostile_h2(port);
    }
  });

  uint64_t out5[5];
  std::thread blast2([&] {
    uint64_t o[5];
    pt_http_blast("127.0.0.1", port, targets_h1.c_str(), 2, 4, kBlastMs, o);
  });
  int rc1 = pt_http_blast("127.0.0.1", port, targets_h1.c_str(), 2, 4,
                          kBlastMs, out5);
  blast2.join();
  uint64_t done_h1 = out5[0];
  int rc2 = pt_http_blast_h2("127.0.0.1", port, targets_h2.c_str(), 4, 4,
                             kBlastMs, out5);
  uint64_t done_h2 = out5[0];

  stop.store(true);
  hostiles.join();
  prober.join();
  drainer.join();
  pump.join();

  uint64_t stats[8];
  pt_http_stats(hs, stats);
  pt_http_attach_host(hs, -1, -1);
  pt_http_stop(hs);
  pt_hls_destroy(hls);
  pt_dir_destroy(dir);

  if (rc1 != 0 || rc2 != 0 || done_h1 == 0 || done_h2 == 0) {
    fprintf(stderr,
            "driver failed: rc1=%d rc2=%d h1=%llu h2=%llu\n", rc1, rc2,
            (unsigned long long)done_h1, (unsigned long long)done_h2);
    return 1;
  }
  printf("san http driver ok: h1=%llu h2=%llu requests=%llu accepted=%llu\n",
         (unsigned long long)done_h1, (unsigned long long)done_h2,
         (unsigned long long)stats[1], (unsigned long long)stats[0]);
  return 0;
}
