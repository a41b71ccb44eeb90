// patrol_host: native host network path for patrol_tpu_torch.
//
// The reference's replication plane is compiled Go: goroutine-per-peer UDP
// fan-out (repo.go:129-158) and a single-packet-per-syscall receive loop
// (repo.go:108-120). This library is the C++ equivalent, shaped for the
// microbatching device runtime instead of goroutines:
//
//   * pt_recv_batch  — recvmmsg(): up to N datagrams per syscall, with a
//                      poll() timeout so the loop stays cancellable (the
//                      3s read-deadline idea of repo.go:109), and each
//                      datagram's kernel receive timestamp.
//   * pt_send_fanout — sendmmsg(): one syscall flushes a whole broadcast
//                      matrix (payloads × peers); pt_send_pairs the same
//                      for distinct datagrams each to its own peer.
//   * pt_decode_batch / pt_encode_batch — the 25-byte-header wire codec
//                      (bucket.go:34-91) + the v2 origin-slot trailer,
//                      vectorized over packet batches into flat arrays that
//                      map 1:1 onto numpy buffers.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
// Build: g++ -O2 -shared -fPIC -o libpatrolhost.so patrol_host.cpp

#include <arpa/inet.h>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/types.h>
#include <unistd.h>

#include <algorithm>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr int kPacketSize = 256;
constexpr int kFixedSize = 25;
constexpr int kTrailerSize = 6;       // base form: P2 | flags=0 | slot u16 | ck
constexpr int kTrailerCapSize = 14;   // with-cap:  P2 | flags=1 | slot u16 | cap u64 | ck
constexpr int kTrailerLaneSize = 30;  // lane: P2 | flags=3 | slot | cap | lane_a | lane_t | ck
constexpr int kTrailerMultiHead = 14;  // multi: P2 | flags=5 | own_slot | cap | K (then K×18 + ck)
constexpr int kMaxBatch = 1024;

inline uint64_t load_be64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  v = __builtin_bswap64(v);
#endif
  return v;
}

inline void store_be64(uint8_t* p, uint64_t v) {
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  v = __builtin_bswap64(v);
#endif
  std::memcpy(p, &v, 8);
}

// FNV-1a 64-bit over the raw name bytes. MUST stay bit-identical to
// patrol_tpu_torch.runtime.directory._fnv1a64 — the directory's vectorized
// hash-table lookup routes on this value (bytes are then verified, so a
// mismatch only costs the slow path, never correctness).
inline uint64_t fnv1a64(const uint8_t* p, int n) {
  uint64_t h = 0xcbf29ce484222325ULL;
  for (int i = 0; i < n; i++) {
    h ^= p[i];
    h *= 0x100000001b3ULL;
  }
  return h;
}

inline double bits_to_double(uint64_t b) {
  double d;
  std::memcpy(&d, &b, 8);
  return d;
}

inline uint64_t double_to_bits(double d) {
  uint64_t b;
  std::memcpy(&b, &d, 8);
  return b;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- sockets

// Open a nonblocking UDP socket bound to ip:port. Returns fd or -errno.
int pt_udp_open(const char* ip, uint16_t port) {
  int fd = socket(AF_INET, SOCK_DGRAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  int buf = 4 << 20;  // fat socket buffers: bursty broadcast matrices
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
  // Each datagram carries the kernel's receive time (pt_recv_batch). In
  // microseconds: a sandboxing kernel such as gVisor delivers
  // SO_TIMESTAMP but no SO_TIMESTAMPNS.
  setsockopt(fd, SOL_SOCKET, SO_TIMESTAMP, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, ip, &addr.sin_addr) != 1) {
    close(fd);
    return -EINVAL;
  }
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  return fd;
}

// Local bound port (for port-0 binds in tests).
int pt_udp_port(int fd) {
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len) < 0) return -errno;
  return ntohs(addr.sin_port);
}

void pt_udp_close(int fd) { close(fd); }

// Receive up to max_packets datagrams (≤row_stride bytes each) in one
// recvmmsg sweep. buf: max_packets*row_stride bytes; sizes/src_ips/
// src_ports: per-packet outputs. row_stride was fixed at 256 (the v1
// packet bound) until ROADMAP 3b: delta-interval datagrams are up to
// 8 KiB, and a 256-B ring row silently truncated them — the backend had
// to advertise a v1-sized rx bound. Callers now size the ring rows to
// the delta bound. stamps_ns (may be null): each datagram's kernel
// receive timestamp in ns (SO_TIMESTAMP, set by pt_udp_open: CLOCK_REALTIME
// to the microsecond), 0 where the kernel gave none. Waits up to timeout_ms for the first
// datagram. Returns n ≥ 0 or -errno.
int pt_recv_batch(int fd, uint8_t* buf, int max_packets, int row_stride,
                  int* sizes, uint32_t* src_ips, uint16_t* src_ports,
                  int64_t* stamps_ns, int timeout_ms) {
  if (max_packets > kMaxBatch) max_packets = kMaxBatch;
  if (row_stride < kPacketSize) return -EINVAL;
  pollfd pfd{fd, POLLIN, 0};
  int pr = poll(&pfd, 1, timeout_ms);
  if (pr < 0) return -errno;
  if (pr == 0) return 0;

  mmsghdr msgs[kMaxBatch];
  iovec iovs[kMaxBatch];
  sockaddr_in addrs[kMaxBatch];
  constexpr size_t kCtrl = CMSG_SPACE(sizeof(timeval));
  alignas(cmsghdr) uint8_t ctrl[kMaxBatch][kCtrl];
  std::memset(msgs, 0, sizeof(mmsghdr) * max_packets);
  for (int i = 0; i < max_packets; i++) {
    iovs[i] = {buf + static_cast<size_t>(i) * row_stride,
               static_cast<size_t>(row_stride)};
    msgs[i].msg_hdr.msg_iov = &iovs[i];
    msgs[i].msg_hdr.msg_iovlen = 1;
    msgs[i].msg_hdr.msg_name = &addrs[i];
    msgs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
    if (stamps_ns != nullptr) {
      msgs[i].msg_hdr.msg_control = ctrl[i];
      msgs[i].msg_hdr.msg_controllen = kCtrl;
    }
  }
  int n = recvmmsg(fd, msgs, max_packets, MSG_DONTWAIT, nullptr);
  if (n < 0) return (errno == EAGAIN || errno == EWOULDBLOCK) ? 0 : -errno;
  for (int i = 0; i < n; i++) {
    sizes[i] = static_cast<int>(msgs[i].msg_len);
    src_ips[i] = ntohl(addrs[i].sin_addr.s_addr);
    src_ports[i] = ntohs(addrs[i].sin_port);
    if (stamps_ns == nullptr) continue;
    stamps_ns[i] = 0;
    msghdr* h = &msgs[i].msg_hdr;
    for (cmsghdr* c = CMSG_FIRSTHDR(h); c != nullptr; c = CMSG_NXTHDR(h, c)) {
      if (c->cmsg_level == SOL_SOCKET && c->cmsg_type == SCM_TIMESTAMP) {
        timeval tv;
        std::memcpy(&tv, CMSG_DATA(c), sizeof(tv));
        stamps_ns[i] = static_cast<int64_t>(tv.tv_sec) * 1000000000LL +
                       static_cast<int64_t>(tv.tv_usec) * 1000LL;
      }
    }
  }
  return n;
}

namespace {

// Datagrams queued for sendmmsg, flushed in chunks of kMaxBatch. A datagram
// the kernel refuses with a hard error (EINVAL for port 0, ENETUNREACH,
// EHOSTUNREACH, EPERM from a filter) is skipped and counted, so one bad
// destination costs only its own datagram; a send buffer still full after a
// 50 ms wait drops the rest of the queue.
struct SendQueue {
  int fd;
  uint8_t* ok;  // per caller row: 1 once handed to the kernel (or null)
  mmsghdr msgs[kMaxBatch];
  iovec iovs[kMaxBatch];
  sockaddr_in addrs[kMaxBatch];
  int rows[kMaxBatch];
  int queued = 0, sent_total = 0, failed = 0, last_errno = 0;

  SendQueue(int fd_, uint8_t* ok_) : fd(fd_), ok(ok_) {}

  void flush() {
    int off = 0;
    while (off < queued) {
      int n = sendmmsg(fd, msgs + off, queued - off, 0);
      if (n < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          pollfd pfd{fd, POLLOUT, 0};
          if (poll(&pfd, 1, 50) <= 0) break;  // give up after 50ms stall
          continue;
        }
        last_errno = errno;  // msgs[off] refused: skip it alone
        failed++;
        off++;
        continue;
      }
      if (ok != nullptr) {
        for (int k = off; k < off + n; k++) ok[rows[k]] = 1;
      }
      off += n;
      sent_total += n;
    }
    queued = 0;
  }

  void push(int row, const uint8_t* data, int size, uint32_t ip,
            uint16_t port) {
    if (queued == kMaxBatch) flush();
    int i = queued++;
    rows[i] = row;
    std::memset(&msgs[i], 0, sizeof(mmsghdr));
    iovs[i] = {const_cast<uint8_t*>(data), static_cast<size_t>(size)};
    addrs[i] = sockaddr_in{};
    addrs[i].sin_family = AF_INET;
    addrs[i].sin_port = htons(port);
    addrs[i].sin_addr.s_addr = htonl(ip);
    msgs[i].msg_hdr.msg_iov = &iovs[i];
    msgs[i].msg_hdr.msg_iovlen = 1;
    msgs[i].msg_hdr.msg_name = &addrs[i];
    msgs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
  }
};

}  // namespace

// Send every payload to every peer: n_payloads × n_peers datagrams, flushed
// through sendmmsg in chunks. payloads: n_payloads rows of row_stride bytes
// (sizes per payload; a delta-interval unicast is one 8-KiB row, the v1
// broadcast matrix stays 256-B rows). Returns datagrams handed to the
// kernel, or -errno where any was refused (the others are still sent).
int pt_send_fanout(int fd, const uint8_t* payloads, const int* sizes,
                   int n_payloads, int row_stride, const uint32_t* peer_ips,
                   const uint16_t* peer_ports, int n_peers) {
  if (row_stride <= 0) return -EINVAL;
  auto q = std::make_unique<SendQueue>(fd, nullptr);
  for (int p = 0; p < n_payloads; p++) {
    for (int j = 0; j < n_peers; j++) {
      q->push(0, payloads + static_cast<size_t>(p) * row_stride, sizes[p],
              peer_ips[j], peer_ports[j]);
    }
  }
  q->flush();
  if (q->failed) return -q->last_errno;
  return q->sent_total;
}

// Send payload i to peer i, for i < n: a tick's distinct datagrams to
// their peers through sendmmsg in chunks, in order. ok (n bytes, zeroed by
// the caller) gets 1 for each datagram handed to the kernel; one refused
// leaves only its own 0. Returns datagrams handed to the kernel, or -EINVAL.
int pt_send_pairs(int fd, const uint8_t* payloads, const int* sizes, int n,
                  int row_stride, const uint32_t* ips, const uint16_t* ports,
                  uint8_t* ok) {
  if (row_stride <= 0) return -EINVAL;
  auto q = std::make_unique<SendQueue>(fd, ok);
  for (int i = 0; i < n; i++) {
    q->push(i, payloads + static_cast<size_t>(i) * row_stride, sizes[i],
            ips[i], ports[i]);
  }
  q->flush();
  return q->sent_total;
}

// ---------------------------------------------------------------- rx ring
//
// Device-resident ingest (ops/ingest.py): the recvmmsg loop writes
// datagrams DIRECTLY into reusable page-aligned byte planes that Python
// views zero-copy (pt_rx_ring_plane); on CUDA each plane is registered
// as page-locked memory (cudaHostRegister) and ships with one
// non-blocking copy — no intermediate copy between the wire and the H2D
// transfer.
// Lease/commit is the ownership protocol: the rx thread LEASES a plane
// before receiving into it, hands the filled plane to the engine, and
// the engine's completion pipeline COMMITS it back once the shipped
// operand is ready (the StagingPool contract). The mutex serializes
// lease/commit across those two threads; planes are C++-owned
// (posix_memalign, page boundaries — the pinned-allocation seam a real
// accelerator transport would mlock/host-register) and freed only at
// destroy, which defers while any plane is still leased so an in-flight
// transfer can never read freed memory.

namespace {

struct PtRxRing {
  std::mutex mu;
  int n_planes = 0;
  int max_batch = 0;
  int row = 0;
  std::vector<uint8_t*> planes;
  std::vector<uint8_t> leased;
  std::vector<uint8_t> used;  // plane saw a prior lease (reuse counter)
  uint64_t leases = 0, commits = 0, reuse = 0, exhausted = 0;
  bool closing = false;
};

PtRxRing* g_rings[16] = {nullptr};
std::mutex g_ring_mu;

void ptring_free(PtRxRing* r) {
  for (uint8_t* p : r->planes) std::free(p);
  delete r;
}

}  // namespace

// Allocate a ring of n_planes page-aligned planes, each max_batch rows
// of row_stride bytes. Returns handle or -errno.
int pt_rx_ring_create(int n_planes, int max_batch, int row_stride) {
  if (n_planes <= 0 || n_planes > 64 || max_batch <= 0 ||
      max_batch > kMaxBatch || row_stride < kPacketSize)
    return -EINVAL;
  std::lock_guard<std::mutex> reg(g_ring_mu);
  int h = -1;
  for (int i = 0; i < 16; i++)
    if (!g_rings[i]) {
      h = i;
      break;
    }
  if (h < 0) return -EMFILE;
  PtRxRing* r = new PtRxRing();
  r->n_planes = n_planes;
  r->max_batch = max_batch;
  r->row = row_stride;
  size_t bytes = static_cast<size_t>(max_batch) * row_stride;
  for (int i = 0; i < n_planes; i++) {
    void* p = nullptr;
    if (posix_memalign(&p, 4096, bytes) != 0) {
      ptring_free(r);
      return -ENOMEM;
    }
    std::memset(p, 0, bytes);
    r->planes.push_back(static_cast<uint8_t*>(p));
  }
  r->leased.assign(n_planes, 0);
  r->used.assign(n_planes, 0);
  g_rings[h] = r;
  return h;
}

// Base address of one plane (Python builds a zero-copy numpy view).
int64_t pt_rx_ring_plane(int h, int plane) {
  PtRxRing* r = (h >= 0 && h < 16) ? g_rings[h] : nullptr;
  if (!r || plane < 0 || plane >= r->n_planes) return 0;
  return reinterpret_cast<int64_t>(r->planes[plane]);
}

// Lease the lowest free plane (deterministic — the abi schedule
// explorer's model relies on it). Returns plane index, or -EAGAIN when
// every plane is in flight (caller falls back / retries next batch).
int pt_rx_ring_lease(int h) {
  PtRxRing* r = (h >= 0 && h < 16) ? g_rings[h] : nullptr;
  if (!r) return -EBADF;
  std::lock_guard<std::mutex> lk(r->mu);
  if (r->closing) return -EBADF;
  for (int i = 0; i < r->n_planes; i++) {
    if (!r->leased[i]) {
      r->leased[i] = 1;
      r->leases++;
      if (r->used[i]) r->reuse++;
      r->used[i] = 1;
      return i;
    }
  }
  r->exhausted++;
  return -EAGAIN;
}

// Return a leased plane to the free set. -EINVAL on a plane that was
// never leased (double-commit / stray index — the ownership bug class
// the PTA004 schedule scenario drives). Frees the ring when a deferred
// destroy is pending and this was the last outstanding lease.
int pt_rx_ring_commit(int h, int plane) {
  std::lock_guard<std::mutex> reg(g_ring_mu);
  PtRxRing* r = (h >= 0 && h < 16) ? g_rings[h] : nullptr;
  if (!r) return -EBADF;
  bool free_now = false;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    if (plane < 0 || plane >= r->n_planes || !r->leased[plane])
      return -EINVAL;
    r->leased[plane] = 0;
    r->commits++;
    if (r->closing) {
      free_now = true;
      for (int i = 0; i < r->n_planes; i++)
        if (r->leased[i]) free_now = false;
    }
  }
  if (free_now) {
    g_rings[h] = nullptr;
    ptring_free(r);
  }
  return 0;
}

// leases, commits, reuse, exhausted — observability (rx_ring_* counters).
int pt_rx_ring_stats(int h, uint64_t* out4) {
  PtRxRing* r = (h >= 0 && h < 16) ? g_rings[h] : nullptr;
  if (!r) return -EBADF;
  std::lock_guard<std::mutex> lk(r->mu);
  out4[0] = r->leases;
  out4[1] = r->commits;
  out4[2] = r->reuse;
  out4[3] = r->exhausted;
  return 0;
}

// Destroy: immediate when no plane is leased; otherwise DEFERRED — the
// ring is marked closing (no new leases) and the last commit frees it,
// so an in-flight H2D transfer can never read freed plane memory.
int pt_rx_ring_destroy(int h) {
  std::lock_guard<std::mutex> reg(g_ring_mu);
  PtRxRing* r = (h >= 0 && h < 16) ? g_rings[h] : nullptr;
  if (!r) return -EBADF;
  bool free_now = true;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closing = true;
    for (int i = 0; i < r->n_planes; i++)
      if (r->leased[i]) free_now = false;
  }
  if (free_now) {
    g_rings[h] = nullptr;
    ptring_free(r);
  }
  return 0;
}

// ------------------------------------------------------------------ codec

// Decode n packets (each at in_stride bytes per row; rows may be the
// 8-KiB rx ring's — a row's decodable prefix is sizes[i] bytes, and
// oversized control-channel payloads like delta intervals simply decode
// as zero-state packets for their reserved name). Outputs per packet:
//   added/taken (float64 tokens), elapsed (uint64 ns, two's complement),
//   name bytes copied into names at 256B stride with name_lens set,
//   origin_slots (-1 when no valid v2 trailer), caps (sender capacity base
//   in int64 nanotokens; -1 when absent — v1 or base-form trailer),
//   lane_added/lane_taken (exact own-lane PN values; -1 when absent),
//   multi_flags: 0 = none, 1 = base trailer with the capability-advert
//   bit (incast requests from multi-capable peers), 2 = a valid
//   multi-lane trailer — the batch path does NOT expand its lanes; the
//   caller re-decodes those few packets (incast replies, cold-start only)
//   through the Python codec.
// Malformed packets get name_lens[i] = -1. Returns count of valid packets.
int pt_decode_batch(const uint8_t* packets, const int* sizes, int n,
                    int in_stride, double* added, double* taken,
                    uint64_t* elapsed, uint8_t* names, int* name_lens,
                    int* origin_slots, int64_t* caps, int64_t* lane_added,
                    int64_t* lane_taken, uint64_t* name_hashes,
                    int* multi_flags) {
  if (in_stride < kPacketSize) return 0;
  int ok = 0;
  for (int i = 0; i < n; i++) {
    const uint8_t* p = packets + static_cast<size_t>(i) * in_stride;
    int sz = sizes[i];
    if (sz > in_stride) sz = in_stride;
    origin_slots[i] = -1;
    caps[i] = -1;
    lane_added[i] = -1;
    lane_taken[i] = -1;
    if (multi_flags) multi_flags[i] = 0;
    if (name_hashes) name_hashes[i] = 0;
    if (sz < kFixedSize) {
      name_lens[i] = -1;
      continue;
    }
    int nlen = p[24];
    if (sz - kFixedSize < nlen) {
      name_lens[i] = -1;
      continue;
    }
    added[i] = bits_to_double(load_be64(p));
    taken[i] = bits_to_double(load_be64(p + 8));
    elapsed[i] = load_be64(p + 16);
    // Zero the full name row so callers can REUSE the output buffer across
    // batches: the directory's vectorized byte-verify compares whole
    // zero-padded rows, which a stale longer name would corrupt.
    uint8_t* nrow = names + i * kPacketSize;
    std::memset(nrow, 0, kPacketSize);
    std::memcpy(nrow, p + kFixedSize, nlen);
    name_lens[i] = nlen;
    if (name_hashes) name_hashes[i] = fnv1a64(nrow, nlen);
    const uint8_t* tail = p + kFixedSize + nlen;
    int tail_len = sz - kFixedSize - nlen;
    if (tail_len >= kTrailerSize && tail[0] == 'P' && tail[1] == '2') {
      bool with_cap = (tail[2] & 0x01) != 0;
      bool with_lane = (tail[2] & 0x02) != 0;
      bool with_multi = (tail[2] & 0x04) != 0;
      if (with_multi && with_cap && !with_lane) {
        // Multi-lane trailer: magic|flags|own_slot u16|cap u64|K u8|
        // K×(slot u16, added u64, taken u64)|ck. Validate whole, flag for
        // Python re-decode; only slot+cap surface through the flat outputs.
        if (tail_len >= kTrailerMultiHead + 1) {
          int K = tail[13];
          int tsz = kTrailerMultiHead + K * 18 + 1;
          if (tail_len >= tsz) {
            uint8_t sum = 0;
            for (int t = 0; t < tsz - 1; t++) sum += tail[t];
            uint64_t cap = load_be64(tail + 5);
            if (sum == tail[tsz - 1] && cap < (1ULL << 63)) {
              origin_slots[i] = (tail[3] << 8) | tail[4];
              caps[i] = static_cast<int64_t>(cap);
              if (multi_flags) multi_flags[i] = 2;
            }
          }
        }
        ok++;
        continue;
      }
      int tsz = with_lane ? kTrailerLaneSize
                          : (with_cap ? kTrailerCapSize : kTrailerSize);
      if (tail_len >= tsz && (!with_lane || with_cap)) {
        uint8_t sum = 0;
        for (int t = 0; t < tsz - 1; t++) sum += tail[t];
        if (sum == tail[tsz - 1]) {
          // Bit-63 values are hostile (non-negative int64 counts by
          // contract). All-or-nothing: any invalid field discards the WHOLE
          // trailer (packet degrades to v1 / deficit-attribution ingest) —
          // a partially-honored lane trailer would merge the header's
          // aggregate into one lane and permanently inflate the PN sum.
          uint64_t cap = with_cap ? load_be64(tail + 5) : 0;
          uint64_t la = with_lane ? load_be64(tail + 13) : 0;
          uint64_t lt = with_lane ? load_be64(tail + 21) : 0;
          if (cap < (1ULL << 63) && la < (1ULL << 63) && lt < (1ULL << 63)) {
            origin_slots[i] = (tail[3] << 8) | tail[4];
            if (with_cap) caps[i] = static_cast<int64_t>(cap);
            if (with_lane) {
              lane_added[i] = static_cast<int64_t>(la);
              lane_taken[i] = static_cast<int64_t>(lt);
            }
            // Base trailer carrying the advert bit: multi-capable sender.
            if (multi_flags && with_multi && !with_cap) multi_flags[i] = 1;
          }
        }
      }
    }
    ok++;
  }
  return ok;
}

// Encode n states into packets at 256B stride. names at 256B stride with
// name_lens; origin_slots ≥ 0 appends the v2 trailer — the 30-byte lane
// form when caps[i] ≥ 0 and lane_added[i]/lane_taken[i] ≥ 0 (names ≤ 201),
// the 14-byte with-cap form when only caps[i] ≥ 0 (names ≤ 217), the 6-byte
// base form otherwise (names ≤ 225; ≤ 231 with no trailer — oversize gets
// out_sizes[i] = -1). Returns count encoded.
int pt_encode_batch(const double* added, const double* taken,
                    const uint64_t* elapsed, const uint8_t* names,
                    const int* name_lens, const int* origin_slots,
                    const int64_t* caps, const int64_t* lane_added,
                    const int64_t* lane_taken, int n,
                    uint8_t* out, int* out_sizes) {
  int ok = 0;
  for (int i = 0; i < n; i++) {
    uint8_t* p = out + i * kPacketSize;
    int nlen = name_lens[i];
    bool with_trailer = origin_slots[i] >= 0;
    bool with_cap = with_trailer && caps[i] >= 0;
    bool with_lane = with_cap && lane_added[i] >= 0 && lane_taken[i] >= 0;
    int tsz = with_trailer
                  ? (with_lane ? kTrailerLaneSize
                               : (with_cap ? kTrailerCapSize : kTrailerSize))
                  : 0;
    int limit = kPacketSize - kFixedSize - tsz;
    if (nlen < 0 || nlen > limit) {
      out_sizes[i] = -1;
      continue;
    }
    store_be64(p, double_to_bits(added[i]));
    store_be64(p + 8, double_to_bits(taken[i]));
    store_be64(p + 16, elapsed[i]);
    p[24] = static_cast<uint8_t>(nlen);
    std::memcpy(p + kFixedSize, names + i * kPacketSize, nlen);
    int sz = kFixedSize + nlen;
    if (with_trailer) {
      uint8_t* t = p + sz;
      t[0] = 'P';
      t[1] = '2';
      t[2] = static_cast<uint8_t>((with_cap ? 1 : 0) | (with_lane ? 2 : 0));
      t[3] = static_cast<uint8_t>((origin_slots[i] >> 8) & 0xFF);
      t[4] = static_cast<uint8_t>(origin_slots[i] & 0xFF);
      if (with_cap) {
        store_be64(t + 5, static_cast<uint64_t>(caps[i]));
      }
      if (with_lane) {
        store_be64(t + 13, static_cast<uint64_t>(lane_added[i]));
        store_be64(t + 21, static_cast<uint64_t>(lane_taken[i]));
      }
      uint8_t sum = 0;
      for (int b = 0; b < tsz - 1; b++) sum += t[b];
      t[tsz - 1] = sum;
      sz += tsz;
    }
    out_sizes[i] = sz;
    ok++;
  }
  return ok;
}

// ------------------------------------------------------- dv2 structure walk

// The host structure walk of raw dv2 delta datagrams (ops/ingest.py
// host_walk_plain, bit for bit): one pass a packet. planes holds P rows at
// `stride` bytes, each `row` bytes wide with lengths[i] bytes of datagram;
// bytes past a row's length are stale ring contents and are never read for
// a verdict (sender_slot and seq are read from the row as it lies, as the
// plain walk reads them). E is the entry bound (max_entries(row)). Every
// output is caller-owned and ZERO-FILLED on entry; scalars are [P], acks
// [P, 32], the entry fields [P, E] row-major. Semantics the plain walk
// encodes, kept here:
//   * the structure walk (name_off/name_len) is gated only on walkability,
//     not on the envelope/checksum/version verdicts: it is the device
//     kernel's framing proposal, and the kernel stays the verdict authority;
//   * acks are filled from the verdict before the entry walk;
//   * a count past E, a payload not ending at the checksum byte, and any
//     value with bit 63 set refuse the whole packet;
//   * a refused packet keeps its structure fields, its value fields are
//     zeroed, its count and n_acks are 0; name_hash only for live entries.
// Returns the count of packets accepted, or -EINVAL on a bad shape.
int pt_walk_batch(const uint8_t* planes, int P, int row, int64_t stride,
                  const int64_t* lengths, int E, uint8_t* ok,
                  int32_t* sender_slot, int64_t* seq, int32_t* n_acks,
                  int64_t* acks, int32_t* count, int32_t* name_off,
                  int32_t* name_len, uint64_t* name_hash, int64_t* slot,
                  int64_t* cap, int64_t* added, int64_t* taken,
                  int64_t* elapsed) {
  constexpr int kBase = 32;       // 25-byte v1 header + 7-byte reserved name
  constexpr int kHead = 8;        // version u8 | sender u16 | seq u32 | n_acks u8
  constexpr int kAck = 4;
  constexpr int kCount = 2;
  constexpr int kTail = 34;       // slot u16 | cap | added | taken | elapsed
  constexpr int kMinLen = kBase + kHead + kCount + 1;
  constexpr int kMaxAcks = 32;    // ops/wire.py DELTA_MAX_ACKS
  constexpr uint8_t kVersion = 2;  // ops/wire.py DELTA_VERSION
  static const uint8_t kName[7] = {0, 'p', 't', '!', 'd', 'v', '2'};
  if (P < 0 || E < 1 || row < kMinLen || stride < row) return -EINVAL;
  int accepted = 0;
  for (int i = 0; i < P; i++) {
    const uint8_t* p = planes + static_cast<size_t>(i) * stride;
    const int64_t len = lengths[i];
    const int64_t end = len - 1;  // the checksum byte
    const bool in_range = len >= kMinLen && len <= row;
    sender_slot[i] = (p[kBase + 1] << 8) | p[kBase + 2];
    seq[i] = (static_cast<int64_t>(p[kBase + 3]) << 24) | (p[kBase + 4] << 16) |
             (p[kBase + 5] << 8) | p[kBase + 6];
    const int na = p[kBase + 7];
    const int64_t off0 = kBase + kHead + kAck * na;
    const bool walkable = in_range && na <= kMaxAcks && off0 + kCount <= end;
    bool good = walkable && p[24] == sizeof(kName) &&
                std::memcmp(p + 25, kName, sizeof(kName)) == 0 &&
                p[kBase] == kVersion;
    for (int k = 0; good && k < 24; k++) good = p[k] == 0;
    if (good) {
      uint8_t sum = 0;
      for (int64_t k = kBase; k < end; k++) sum += p[k];
      good = sum == p[end];
    }
    if (good) {
      int64_t* a = acks + static_cast<size_t>(i) * kMaxAcks;
      for (int k = 0; k < na; k++) {
        const uint8_t* q = p + kBase + kHead + kAck * k;
        a[k] = (static_cast<int64_t>(q[0]) << 24) | (q[1] << 16) | (q[2] << 8) | q[3];
      }
    }
    const int64_t cnt = walkable ? (p[off0] << 8) | p[off0 + 1] : 0;
    const size_t base = static_cast<size_t>(i) * E;
    int64_t off = walkable ? off0 + kCount : 0;
    int64_t walked = 0;
    uint64_t hi = 0;
    for (const int64_t lim = std::min<int64_t>(cnt, E); walked < lim; walked++) {
      if (off >= end) break;
      const int nl = p[off];
      if (off + 1 + nl + kTail > end) break;
      const uint8_t* t = p + off + 1 + nl;
      const uint64_t c = load_be64(t + 2), ad = load_be64(t + 10),
                     tk = load_be64(t + 18), el = load_be64(t + 26);
      hi |= c | ad | tk | el;
      name_off[base + walked] = static_cast<int32_t>(off + 1);
      name_len[base + walked] = nl;
      slot[base + walked] = (t[0] << 8) | t[1];
      cap[base + walked] = static_cast<int64_t>(c);
      added[base + walked] = static_cast<int64_t>(ad);
      taken[base + walked] = static_cast<int64_t>(tk);
      elapsed[base + walked] = static_cast<int64_t>(el);
      off += 1 + nl + kTail;
    }
    good = good && walked == cnt && off == end && (hi >> 63) == 0;
    if (!good) {
      for (int64_t e = 0; e < walked; e++) {
        slot[base + e] = cap[base + e] = added[base + e] = 0;
        taken[base + e] = elapsed[base + e] = 0;
      }
      continue;
    }
    ok[i] = 1;
    n_acks[i] = na;
    count[i] = static_cast<int32_t>(cnt);
    for (int64_t e = 0; e < cnt; e++)
      name_hash[base + e] = fnv1a64(p + name_off[base + e], name_len[base + e]);
    accepted++;
  }
  return accepted;
}

// ---- pt_dir: native bucket-name resolve table ------------------------------
//
// The C++ half of BucketDirectory's hash-routing fast path. Python owns
// binding policy (allocation, eviction, pin lifecycle) and keeps the name
// bytes in numpy arrays; this table holds only (hash → row) and READS the
// numpy buffers (shared pointers, zero copy) to verify bytes. One call
// resolves a whole decoded batch: probe + memcmp + pin + LRU stamp per
// packet — the work the vectorized numpy path pays ~0.5 µs/packet of
// gather overhead for at 1M rows, done here in one cache-aware pass.
//
// Thread safety: every entry point MUST be called under the Python
// directory lock (the Python side guarantees this); no internal locking.

namespace {

// One probe-table entry, 16 bytes — hash, row, and the bound name's
// length packed into ONE cache line (4 entries/line). The r2 layout kept
// hash/row/len in three arrays, so every probe at 1M rows paid two-three
// DRAM lines; this layout pays one (the dominant classify cost is DRAM
// latency on a single host core — see pt_rx_classify).
struct PtSlot {
  uint64_t h;
  int32_t row;  // -1 empty, -2 tombstone, ≥0 bound row
  int32_t len;  // name length of `row` (valid when row ≥ 0)
};
static_assert(sizeof(PtSlot) == 16, "slot must pack to 16 bytes");

struct PtDir {
  int64_t capacity = 0;
  uint64_t mask = 0;
  std::vector<PtSlot> tab;      // open-addressing probe table
  std::vector<uint64_t> row_h;  // row → its hash (for delete/rebuild)
  std::vector<uint8_t> live;    // row → bound?
  const uint8_t* name_bytes = nullptr;  // [capacity, 256], Python-owned
  const int32_t* name_lens = nullptr;   // [capacity], Python-owned
  int64_t tombs = 0;
  int maxprobe = 1;
  // Table writers (insert/delete/rebuild, all Python-lock-serialized
  // already) vs the HTTP front's epoll-thread resolve (pt_dir_resolve_rt,
  // NOT under the Python lock): writers take unique, the runtime resolve
  // takes shared. The Python-side batch resolvers stay lock-free readers
  // — the Python directory lock already serializes them against every
  // writer; only the epoll thread needs this.
  std::shared_mutex tab_mu;
};

PtDir* g_dirs[16] = {nullptr};
// Serializes slot allocation/release: create runs from Python __init__
// (no directory lock exists yet) and destroy can run from GC on any
// thread. Per-table operations are NOT guarded here — the per-directory
// Python lock covers them, and close() nulls its handle under that lock
// before destroying, so no operation can race its own table's teardown.
std::mutex g_dir_mu;

void ptdir_insert(PtDir* d, uint64_t h, int32_t row) {
  uint64_t pos = h & d->mask;
  int probes = 1;
  int64_t tomb = -1;
  while (true) {
    int32_t r = d->tab[pos].row;
    if (r == -1) break;
    if (r == -2 && tomb < 0) tomb = (int64_t)pos;
    pos = (pos + 1) & d->mask;
    probes++;
  }
  if (tomb >= 0) {
    pos = (uint64_t)tomb;
    d->tombs--;
  }
  d->tab[pos].h = h;
  d->tab[pos].row = row;
  // The name bytes/len are already written by the Python bind path when
  // the insert lands (directory._bind_locked order), so the length can be
  // denormalized into the probe entry — resolve then never touches the
  // separate name_lens array.
  d->tab[pos].len = d->name_lens ? d->name_lens[row] : 0;
  if (probes > d->maxprobe) d->maxprobe = probes;
  d->row_h[row] = h;
  d->live[row] = 1;
}

void ptdir_rebuild(PtDir* d) {
  std::fill(d->tab.begin(), d->tab.end(), PtSlot{0, -1, 0});
  d->tombs = 0;
  d->maxprobe = 1;
  for (int64_t r = 0; r < d->capacity; r++)
    if (d->live[r]) ptdir_insert(d, d->row_h[r], (int32_t)r);
}

}  // namespace

int pt_dir_create(int64_t capacity, const uint8_t* name_bytes,
                  const int32_t* name_lens) {
  std::lock_guard<std::mutex> reg(g_dir_mu);
  int h = -1;
  for (int i = 0; i < 16; i++)
    if (!g_dirs[i]) {
      h = i;
      break;
    }
  if (h < 0) return -EMFILE;
  PtDir* d = new PtDir();
  d->capacity = capacity;
  uint64_t m = 64;
  while ((int64_t)m < capacity * 4) m <<= 1;
  d->mask = m - 1;
  d->tab.assign(m, PtSlot{0, -1, 0});
  d->row_h.assign(capacity, 0);
  d->live.assign(capacity, 0);
  d->name_bytes = name_bytes;
  d->name_lens = name_lens;
  g_dirs[h] = d;
  return h;
}

int pt_dir_insert(int h, uint64_t hash, int32_t row) {
  PtDir* d = g_dirs[h];
  if (!d) return -EBADF;
  std::unique_lock<std::shared_mutex> wl(d->tab_mu);
  ptdir_insert(d, hash, row);
  return 0;
}

// Batch insert for the bulk bind path (assign_many): one ctypes call per
// delta chunk instead of one per new bucket.
int pt_dir_insert_batch(int h, const uint64_t* hashes, const int32_t* rows,
                        int n) {
  PtDir* d = g_dirs[h];
  if (!d) return -EBADF;
  std::unique_lock<std::shared_mutex> wl(d->tab_mu);
  for (int i = 0; i < n; i++) ptdir_insert(d, hashes[i], rows[i]);
  return 0;
}

int pt_dir_delete(int h, uint64_t hash, int32_t row) {
  PtDir* d = g_dirs[h];
  if (!d) return -EBADF;
  std::unique_lock<std::shared_mutex> wl(d->tab_mu);
  uint64_t pos = hash & d->mask;
  for (int p = 0; p < d->maxprobe; p++) {
    int32_t r = d->tab[pos].row;
    if (r == row) {
      d->tab[pos] = PtSlot{0, -2, 0};
      d->tombs++;
      break;
    }
    if (r == -1) break;
    pos = (pos + 1) & d->mask;
  }
  d->live[row] = 0;
  if (d->tombs > (int64_t)(d->mask + 1) / 8) ptdir_rebuild(d);
  return 0;
}

namespace {

// One name resolve: probe + verify. Zero-padded 256B rows on both sides,
// so comparing ceil(len/8) u64-words is exact name equality while touching
// ≤1 cache line for typical short names (a full 256B memcmp pulls 4 lines
// of the 1M-row name table per packet — the dominant resolve cost). The
// length check rides the probe entry itself (PtSlot.len), so a resolve
// touches exactly one probe line + one name line.
inline int32_t ptdir_resolve_one(const PtDir* d, uint64_t hv,
                                 const uint8_t* name_row, int32_t len) {
  // Collision discipline (shared with pt_rx_classify pass-1 so both
  // resolvers answer identically for the same name): keep probing past an
  // entry whose hash matches but length differs — distinct same-hash
  // names coexist in the table, so a len mismatch is not this name — and
  // stop at the first (hash, len) match, where a byte-verify failure is
  // reported as a miss (the python slow path re-resolves).
  uint64_t pos = hv & d->mask;
  for (int p = 0; p < d->maxprobe; p++) {
    const PtSlot& s = d->tab[pos];
    if (s.row == -1) return -1;  // definite miss
    if (s.row >= 0 && s.h == hv && s.len == len) {
      if (std::memcmp(d->name_bytes + (size_t)s.row * kPacketSize, name_row,
                      ((size_t)len + 7) & ~(size_t)7) == 0) {
        return s.row;
      }
      return -1;  // byte-verify fail ⇒ miss (slow path re-resolves)
    }
    pos = (pos + 1) & d->mask;
  }
  return -1;
}

}  // namespace

// Single-name resolve for the HTTP front's epoll thread (the only caller
// NOT serialized by the Python directory lock): computes the FNV hash,
// probes under the table's shared lock, and stamps the LRU clock on a hit
// (plain aligned int64 store — tear-free on x86-64; eviction reading a
// stale stamp is the same benignity the Python batch resolve accepts).
// No pin is taken: the inline host take completes before returning to the
// event loop, so there is no in-flight window for eviction to violate —
// a take racing the eviction itself answers from the dying bucket's last
// state, the same bounded anomaly the Python fast path documents.
int32_t pt_dir_resolve_rt(int h, const uint8_t* name_padded, int32_t len,
                          int64_t* last_used, int64_t now) {
  PtDir* d = g_dirs[h];
  if (!d || len < 0) return -1;
  uint64_t hv = fnv1a64(name_padded, len);
  std::shared_lock<std::shared_mutex> rl(d->tab_mu);
  int32_t row = ptdir_resolve_one(d, hv, name_padded, len);
  if (row >= 0 && last_used) last_used[row] = now;
  return row;
}

// Batch resolve: rows_out[i] = row or -1 (miss/malformed). On a hit, pins
// and last_used (Python-owned numpy buffers) are updated in place.
// Returns the hit count.
int64_t pt_dir_resolve(int h, int n, const uint64_t* hashes,
                       const uint8_t* name_buf, const int32_t* lens,
                       int64_t* rows_out, int32_t* pins, int64_t* last_used,
                       int64_t now) {
  PtDir* d = g_dirs[h];
  if (!d) return -EBADF;
  int64_t hits = 0;
  for (int i = 0; i < n; i++) {
    rows_out[i] = -1;
    if (lens[i] < 0) continue;
    int32_t r =
        ptdir_resolve_one(d, hashes[i], name_buf + (size_t)i * kPacketSize,
                          lens[i]);
    if (r >= 0) {
      rows_out[i] = r;
      pins[r]++;
      last_used[r] = now;
      hits++;
    }
  }
  return hits;
}

namespace {

// float64 wire tokens → int64 nanotokens; MUST stay bit-identical to
// ops/wire.py sanitize_nt_array (NaN → 0, ≤0 → 0, ≥2^63 clamps to the
// int64 edge, round-half-even like np.rint — nearbyint under the default
// FE_TONEAREST mode). Native-rx and python-rx peers must merge the same
// packet to the same state or replicas diverge permanently.
inline int64_t sanitize_nt(double tokens) {
  if (!(tokens > 0.0)) return 0;  // NaN fails the comparison, like numpy
  double nt = tokens * 1e9;
  if (nt >= 9223372036854775808.0) return INT64_MAX;  // +Inf / overflow
  return (int64_t)std::nearbyint(nt);
}

}  // namespace

// Fused rx fast path: resolve + sanitize + wire-semantics classification
// in one pass over a decoded batch — the python side of this
// (engine._classify_queue_chunk's ~20 numpy array passes) was the feed
// bottleneck at ~500 ns/delta (BENCH r2: feed 6.76 s of a ~10 s replay).
//
// Two passes: (1) resolve rows (pinning hits) and adopt wire capacities,
// so a v1 delta EARLIER in the batch than a cap-carrying delta for the
// same row still sees the base (order parity with the batch-wide numpy
// adopt); (2) sanitize + classify.
//
// rows_out[i]: ≥0 = resolved row (PINNED — ownership passes to the queued
// chunk); -1 = miss (python binds + classifies the leftover subset);
// -2 = invalid (negative len / slot out of range), not pinned.
// out_scalar[i]: 0 = exact lane merge; 1 = scalar (deficit-attribution)
// merge; 2 = v1 delta whose row capacity was 0 at classify time — python
// re-checks after binding misses (which may adopt caps) and drops the
// still-unknown ones. Must be called under the directory lock.
int64_t pt_rx_classify(int h, int n, const uint64_t* hashes,
                       const uint8_t* name_buf, const int32_t* lens,
                       const double* added_f, const double* taken_f,
                       const uint64_t* elapsed_u, const int64_t* slots_in,
                       int64_t max_slots, const int64_t* caps,
                       const int64_t* lane_a, const int64_t* lane_t,
                       const uint8_t* no_trailer, int64_t* cap_base,
                       int32_t* pins, int64_t* last_used, int64_t now,
                       int64_t* rows_out, int64_t* out_added,
                       int64_t* out_taken, int64_t* out_elapsed,
                       uint8_t* out_scalar) {
  PtDir* d = g_dirs[h];
  if (!d) return -EBADF;
  int64_t hits = 0;
  // Pass 1 is a ROLLING 3-stage pipeline: every loop iteration i runs
  //   A(i):      validate, compute probe position, prefetch the probe line
  //   B(i-GAP):  probe (hash+row+len live in ONE PtSlot line), prefetch
  //              the candidate's name line + pins/cap_base/last_used
  //   C(i-2*GAP): byte-verify, pin, LRU stamp, adopt wire capacities
  // GAP is sized to the core's memory-level parallelism, not to a cache
  // block: this host sustains ~13 overlapped misses at ~200 ns DRAM
  // latency (scripts: /tmp-style pointer-chase probe, r3), so a prefetch
  // needs only ~10-15 iterations of other work to land. The r2 shape
  // (three separate loops over 256-delta blocks) issued hundreds of
  // prefetches ahead — beyond the prefetch queue, most were dropped and
  // the pass ran at near-serial DRAM latency (~440-600 ns/delta at 1M
  // rows). Rolling keeps ≤ ~5·GAP prefetches in flight.
  constexpr int kGap = 12;
  constexpr int kRing = 32;  // ≥ 2*kGap, power of two
  static_assert(kRing >= 2 * kGap, "ring must cover the pipeline depth");
  uint64_t pos[kRing];
  int32_t cand[kRing];
  for (int i = 0; i < n + 2 * kGap; i++) {
    if (i < n) {  // -- A
      out_scalar[i] = 0;
      // rows_out arrives as uninitialized np.empty storage — write every
      // entry here (the later passes branch on it).
      if (lens[i] < 0 || slots_in[i] < 0 || slots_in[i] >= max_slots) {
        rows_out[i] = -2;
      } else {
        rows_out[i] = -1;
        uint64_t p = hashes[i] & d->mask;
        pos[i & (kRing - 1)] = p;
        __builtin_prefetch(&d->tab[p]);
      }
    }
    int j = i - kGap;  // -- B
    if (j >= 0 && j < n && rows_out[j] != -2) {
      uint64_t hv = hashes[j];
      uint64_t p = pos[j & (kRing - 1)];
      int32_t c = -1;
      for (int pr = 0; pr < d->maxprobe; pr++) {
        const PtSlot& s = d->tab[p];
        if (s.row == -1) break;
        if (s.row >= 0 && s.h == hv && s.len == lens[j]) {
          c = s.row;
          break;
        }
        p = (p + 1) & d->mask;
      }
      cand[j & (kRing - 1)] = c;
      if (c >= 0) {
        __builtin_prefetch(d->name_bytes + (size_t)c * kPacketSize);
        __builtin_prefetch(&pins[c], 1);
        __builtin_prefetch(&cap_base[c], 1);
        __builtin_prefetch(&last_used[c], 1);
      }
    }
    int k = i - 2 * kGap;  // -- C
    if (k >= 0 && rows_out[k] != -2) {
      int32_t r = cand[k & (kRing - 1)];
      if (r >= 0 &&
          std::memcmp(d->name_bytes + (size_t)r * kPacketSize,
                      name_buf + (size_t)k * kPacketSize,
                      ((size_t)lens[k] + 7) & ~(size_t)7) == 0) {
        rows_out[k] = r;
        pins[r]++;
        last_used[r] = now;
        hits++;
        if (caps[k] > 0 && cap_base[r] == 0) cap_base[r] = caps[k];
      } else {
        rows_out[k] = -1;  // miss or collision: python slow path
      }
    }
  }
  // Pass 2: classify + per-batch (row, slot) CRDT dedup. Duplicate
  // (row, slot) entries in one batch fold into the FIRST occurrence by
  // elementwise max — exactly the join the device would compute, minus
  // the per-element-update scatter cost (~150 ns each on v5e, the merge
  // throughput ceiling). A hot-key storm collapses to one update per
  // lane per batch; uniform traffic pays one hash probe per delta.
  // Folding is valid across ALL classify codes: lane values join by max,
  // and scalar (deficit-attribution) deltas are monotone in their
  // aggregates, so the max aggregate subsumes the smaller one. Folded
  // entries get rows_out = -4 and their pin is RELEASED here (their
  // state rides the survivor's entry).
  constexpr uint32_t kDedupCap = 16384;  // ≥2× max batch, power of two
  static_assert((kDedupCap & (kDedupCap - 1)) == 0, "power of two");
  uint64_t dkeys[kDedupCap];
  int32_t didx[kDedupCap];
  // Table sized to the batch (next pow2 ≥ 2n): a small rx batch clears a
  // small prefix, not the whole 64 KB — the fixed clear would cost more
  // than the dedup saves under low/steady load.
  uint32_t dcap = 64;
  while (dcap < (uint32_t)(2 * n)) dcap <<= 1;
  // The key packs (row << 22 | slot << 2 | code): needs slot < 2^20 —
  // true for any sane lane count, but guard rather than alias buckets.
  bool dedup = dcap <= kDedupCap && max_slots <= (1 << 20);
  uint32_t dmask = dcap - 1;
  if (dedup)
    for (uint32_t i2 = 0; i2 < dcap; i2++) didx[i2] = -1;
  for (int i = 0; i < n; i++) {
    int64_t r = rows_out[i];
    if (r < 0) continue;
    int64_t a = sanitize_nt(added_f[i]);
    int64_t t = sanitize_nt(taken_f[i]);
    int64_t e = (int64_t)elapsed_u[i];
    out_elapsed[i] = e < 0 ? 0 : e;
    if (caps[i] >= 0) {
      if (lane_a[i] >= 0 && lane_t[i] >= 0) {
        out_added[i] = lane_a[i];  // exact PN lane values (lane trailer)
        out_taken[i] = lane_t[i];
      } else {
        a -= caps[i];  // aggregate header minus wire cap
        out_added[i] = a < 0 ? 0 : a;
        out_taken[i] = t;
        out_scalar[i] = 1;
      }
    } else if (no_trailer[i]) {
      int64_t base = cap_base[r];
      if (base == 0) {
        out_added[i] = a;  // python re-checks after miss binds adopt caps
        out_taken[i] = t;
        out_scalar[i] = 2;
      } else {
        a -= base;
        out_added[i] = a < 0 ? 0 : a;
        out_taken[i] = t;
        out_scalar[i] = 1;
      }
    } else {
      out_added[i] = a;  // base-trailer peer: raw own-lane header
      out_taken[i] = t;
    }
    if (!dedup) continue;
    // The classify code is part of the key: entries fold only with the
    // same code (mixed joins are left to the kernel), and a lone
    // different-code entry must not block a same-code storm behind it.
    uint64_t key = ((uint64_t)r << 22) | ((uint64_t)slots_in[i] << 2) |
                   (uint64_t)out_scalar[i];
    // Fibonacci hashing: the product's entropy lives in its HIGH bits,
    // so fold them down before masking. Masking the raw product (the r2
    // code) kept only bits the key's low 14 bits determine — i.e. only
    // (slot, code) — so any batch with few distinct slots collapsed into
    // a handful of probe chains and the dedup pass went O(n^2) (~390
    // ns/delta measured at n=8192 with 4 slots; ~15 ns/delta fixed).
    uint64_t prod = key * 0x9E3779B97F4A7C15ULL;
    uint64_t pos = (prod ^ (prod >> 32)) & dmask;
    while (true) {
      int32_t j = didx[pos];
      if (j < 0) {
        dkeys[pos] = key;
        didx[pos] = i;
        break;
      }
      if (dkeys[pos] == key) {
        if (out_added[i] > out_added[j]) out_added[j] = out_added[i];
        if (out_taken[i] > out_taken[j]) out_taken[j] = out_taken[i];
        if (out_elapsed[i] > out_elapsed[j]) out_elapsed[j] = out_elapsed[i];
        rows_out[i] = -4;
        pins[r]--;  // the survivor keeps the row pinned
        break;
      }
      pos = (pos + 1) & dmask;
    }
  }
  return hits;
}

int pt_dir_destroy(int h) {
  std::lock_guard<std::mutex> reg(g_dir_mu);
  PtDir* d = g_dirs[h];
  if (!d) return -EBADF;
  g_dirs[h] = nullptr;
  delete d;
  return 0;
}

}  // extern "C"

// ---- Native fold-to-dense hybrid (VERDICT r4 item 6) ----------------------
//
// The engine's hot-key path was fold-dominated: 131k deltas for one row
// cost ~6.1 ms of single-threaded numpy (lexsort + reduceat) against a
// ~0.2 ms device commit. This is the C++ fold: one pass over the batch
// into per-row lane blocks (dense accumulate + touched bitmap), threaded
// across cores for large batches — grouping work the clustered/hot-key
// shapes need WITHOUT a sort. The uniform shape (distinct rows ≈ batch)
// intentionally bails to the numpy path: per-row blocks would allocate
// rows×nodes, and that shape is scatter-bound anyway.

namespace {

struct FoldRowAcc {
  int64_t* lanes = nullptr;   // [nodes, 2] max-joined values
  uint64_t* bits = nullptr;   // touched-slot bitmap
  int64_t elapsed = 0;
  int64_t touched = 0;
};

struct FoldShard {
  std::unordered_map<int64_t, FoldRowAcc> map;
  std::vector<std::unique_ptr<int64_t[]>> lane_arena;
  std::vector<std::unique_ptr<uint64_t[]>> bit_arena;
  bool aborted = false;
};

void fold_shard(const int64_t* rows, const int64_t* slots,
                const int64_t* added, const int64_t* taken,
                const int64_t* elapsed, int64_t lo, int64_t hi,
                int64_t nodes, int64_t max_distinct, int64_t bit_words,
                FoldShard* sh) {
  auto& map = sh->map;
  for (int64_t i = lo; i < hi; i++) {
    int64_t slot = slots[i];
    if (slot < 0 || slot >= nodes) {
      sh->aborted = true;  // malformed: let the python path handle it
      return;
    }
    auto it = map.find(rows[i]);
    if (it == map.end()) {
      if ((int64_t)map.size() >= max_distinct) {
        sh->aborted = true;  // uniform shape: numpy path is the right tool
        return;
      }
      sh->lane_arena.emplace_back(new int64_t[nodes * 2]());
      sh->bit_arena.emplace_back(new uint64_t[bit_words]());
      FoldRowAcc acc;
      acc.lanes = sh->lane_arena.back().get();
      acc.bits = sh->bit_arena.back().get();
      it = map.emplace(rows[i], acc).first;
    }
    FoldRowAcc& a = it->second;
    uint64_t w = (uint64_t)slot >> 6, b = 1ULL << (slot & 63);
    if (!(a.bits[w] & b)) {
      a.bits[w] |= b;
      a.touched++;
    }
    int64_t* lane = a.lanes + slot * 2;
    if (added[i] > lane[0]) lane[0] = added[i];
    if (taken[i] > lane[1]) lane[1] = taken[i];
    if (elapsed[i] > a.elapsed) a.elapsed = elapsed[i];
  }
}

}  // namespace

extern "C" {

// → 0 ok, -1 fall back to the numpy fold (too many distinct rows or a
// malformed slot). out_counts = {n_sparse_pairs, n_sparse_rows, n_dense}.
// Dense rows beyond cap_dense spill to the sparse outputs in ascending
// row order — the same first-cap selection as the numpy hybrid.
int pt_fold_hybrid(const int64_t* rows, const int64_t* slots,
                   const int64_t* added, const int64_t* taken,
                   const int64_t* elapsed, int64_t n, int64_t nodes,
                   int64_t row_dense_min, int64_t max_distinct,
                   int64_t* d_rows, int64_t* d_upd, int64_t* d_el,
                   int64_t cap_dense, int64_t* sp_rows, int64_t* sp_slots,
                   int64_t* sp_a, int64_t* sp_t, int64_t* sp_er,
                   int64_t* sp_e, int64_t* out_counts) {
  if (n <= 0 || nodes <= 0) return -1;
  const int64_t bit_words = (nodes + 63) / 64;
  unsigned hw = std::thread::hardware_concurrency();
  int T = (n >= 65536 && hw > 1) ? (int)std::min<unsigned>(hw, 8) : 1;
  // Test/tuning override: force the shard count (exercises the shard
  // merge on single-core boxes; 0/unset = auto).
  if (const char* tf = getenv("PATROL_FOLD_THREADS")) {
    int v = atoi(tf);
    if (v > 0) T = std::min(v, 8);
  }
  std::vector<FoldShard> shards((size_t)T);
  if (T == 1) {
    fold_shard(rows, slots, added, taken, elapsed, 0, n, nodes,
               max_distinct, bit_words, &shards[0]);
  } else {
    std::vector<std::thread> ts;
    int64_t step = (n + T - 1) / T;
    for (int t = 0; t < T; t++) {
      int64_t lo = t * step, hi = std::min<int64_t>(n, lo + step);
      if (lo >= hi) break;
      ts.emplace_back(fold_shard, rows, slots, added, taken, elapsed, lo,
                      hi, nodes, max_distinct, bit_words, &shards[t]);
    }
    for (auto& t : ts) t.join();
  }
  for (auto& sh : shards)
    if (sh.aborted) return -1;
  // Merge shards 1..T-1 into shard 0 (small maps: ≤ max_distinct rows).
  FoldShard& m = shards[0];
  for (int t = 1; t < T; t++) {
    for (auto& kv : shards[t].map) {
      auto it = m.map.find(kv.first);
      if (it == m.map.end()) {
        if ((int64_t)m.map.size() >= max_distinct) return -1;
        m.lane_arena.emplace_back(new int64_t[nodes * 2]());
        m.bit_arena.emplace_back(new uint64_t[bit_words]());
        FoldRowAcc acc;
        acc.lanes = m.lane_arena.back().get();
        acc.bits = m.bit_arena.back().get();
        it = m.map.emplace(kv.first, acc).first;
      }
      FoldRowAcc& a = it->second;
      const FoldRowAcc& b = kv.second;
      for (int64_t w = 0; w < bit_words; w++) a.bits[w] |= b.bits[w];
      for (int64_t j = 0; j < nodes * 2; j++)
        if (b.lanes[j] > a.lanes[j]) a.lanes[j] = b.lanes[j];
      if (b.elapsed > a.elapsed) a.elapsed = b.elapsed;
      a.touched = 0;
      for (int64_t w = 0; w < bit_words; w++)
        a.touched += __builtin_popcountll(a.bits[w]);
    }
  }
  // Emit in ascending row order (the numpy fold's sorted invariant).
  std::vector<std::pair<int64_t, const FoldRowAcc*>> ordered;
  ordered.reserve(m.map.size());
  for (auto& kv : m.map) ordered.emplace_back(kv.first, &kv.second);
  std::sort(ordered.begin(), ordered.end(),
            [](const auto& x, const auto& y) { return x.first < y.first; });
  int64_t np = 0, nr = 0, nd = 0;
  for (auto& [row, acc] : ordered) {
    if (acc->touched >= row_dense_min && nd < cap_dense) {
      d_rows[nd] = row;
      d_el[nd] = acc->elapsed;
      std::memcpy(d_upd + nd * nodes * 2, acc->lanes,
                  sizeof(int64_t) * nodes * 2);
      nd++;
      continue;
    }
    for (int64_t w = 0; w < bit_words; w++) {
      uint64_t bits = acc->bits[w];
      while (bits) {
        int64_t slot = w * 64 + __builtin_ctzll(bits);
        bits &= bits - 1;
        sp_rows[np] = row;
        sp_slots[np] = slot;
        sp_a[np] = acc->lanes[slot * 2];
        sp_t[np] = acc->lanes[slot * 2 + 1];
        np++;
      }
    }
    sp_er[nr] = row;
    sp_e[nr] = acc->elapsed;
    nr++;
  }
  out_counts[0] = np;
  out_counts[1] = nr;
  out_counts[2] = nd;
  return 0;
}

}  // extern "C"
