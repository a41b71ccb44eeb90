// patrol_http: native HTTP/1.1 front for the /take hot path.
//
// The reference serves /take from compiled Go net/http (command.go:41-44,
// api.go:51-86) — a performance class a Python asyncio server cannot
// reach. This is the C++ equivalent, shaped for the microbatching device
// runtime the same way patrol_host.cpp shapes the UDP plane:
//
//   * one epoll thread owns accept/read/parse/write — zero Python on the
//     socket path;
//   * /take requests are FULLY parsed in C++ (percent-decoding, Go
//     ParseRate/ParseDuration semantics ported below) into fixed records
//     on a ring; the Python pump drains the ring in BATCHES (one ctypes
//     call), submits them to the device engine, and completes them in
//     batches — so Python cost amortizes over the batch exactly like the
//     engine's take microbatching;
//   * responses are formatted and written back in C++;
//   * non-/take routes (debug, metrics) ride a slow-path ring to Python.
//
// Concurrency: the epoll thread and the Python pump share one mutex per
// server (batch-level contention only) plus an eventfd to kick the epoll
// loop when completions arrive. Connection slots carry a generation tag
// so a completion for a closed/reused connection is dropped, never
// misdelivered.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <deque>
#include <dlfcn.h>
#include <mutex>
#include <thread>
#include <string_view>
#include <unordered_map>
#include <vector>

// From patrol_host.cpp (same shared library): epoll-thread-safe single
// name resolve against the C++ directory probe table.
extern "C" int32_t pt_dir_resolve_rt(int h, const uint8_t* name_padded,
                                     int32_t len, int64_t* last_used,
                                     int64_t now);

namespace {

constexpr int kNameMax = 256;     // matches wire NAME_BYTES_MAX
constexpr int kNameLimit = 231;   // MAX_NAME_LENGTH_V1 (bucket.go:43-44)
constexpr int kPathMax = 2048;    // slow-path target cap
constexpr int kRbufMax = 16384;   // per-connection read buffer cap
constexpr int kRingCap = 8192;    // parsed-take ring capacity
// Sane request-body bound. The API carries take input in the URL; a
// Content-Length beyond this is hostile (or a config error) and gets a
// 400 + close instead of a body drain — and the digit parse saturates
// HERE rather than wrapping size_t, which under-skipped the body and
// re-parsed its bytes as pipelined requests (request-smuggling surface
// behind a connection-reusing proxy; ADVICE r5).
constexpr size_t kMaxContentLen = (size_t)1 << 30;
constexpr int64_t kInt64Max = 0x7FFFFFFFFFFFFFFFLL;

// ---- Go time.ParseDuration / ParseRate port (ops/rate.py parity) ----------

// Unit table incl. both µ (U+00B5, "\xc2\xb5") and μ (U+03BC, "\xce\xbc").
struct Unit { const char* s; int len; int64_t scale; };
const Unit kUnits[] = {
    {"ns", 2, 1LL},
    {"us", 2, 1000LL},
    {"\xc2\xb5s", 3, 1000LL},
    {"\xce\xbcs", 3, 1000LL},
    {"ms", 2, 1000000LL},
    {"s", 1, 1000000000LL},
    {"m", 1, 60LL * 1000000000LL},
    {"h", 1, 3600LL * 1000000000LL},
};
// Bare units accepted as "1<unit>" shorthand (bucket.go:116-119): the
// reference's list has µs but NOT μs.
const char* kBareUnits[] = {"ns", "us", "\xc2\xb5s", "ms", "s", "m", "h"};

// Longest-match unit lookup at s[i:]; returns scale or 0.
int64_t match_unit(const std::string& s, size_t i, size_t* adv) {
  const Unit* best = nullptr;
  for (const auto& u : kUnits) {
    if (s.compare(i, u.len, u.s) == 0 && (!best || u.len > best->len)) best = &u;
  }
  if (!best) return 0;
  *adv = best->len;
  return best->scale;
}

// parse_duration (ops/rate.py:41-92). Returns false on malformed input.
bool parse_duration(const std::string& orig, int64_t* out) {
  std::string s = orig;
  bool neg = false;
  if (!s.empty() && (s[0] == '+' || s[0] == '-')) {
    neg = s[0] == '-';
    s.erase(0, 1);
  }
  if (s == "0") {
    *out = 0;
    return true;
  }
  if (s.empty()) return false;
  __int128 total = 0;
  size_t i = 0;
  while (i < s.size()) {
    size_t d0 = i;
    while (i < s.size() && s[i] >= '0' && s[i] <= '9') i++;
    size_t int_len = i - d0;
    __int128 int_part = 0;
    for (size_t k = d0; k < i; k++) {
      int_part = int_part * 10 + (s[k] - '0');
      if (int_part > (__int128)kInt64Max * 10) return false;  // overflow guard
    }
    size_t f0 = i, frac_len = 0;
    __int128 frac_part = 0;
    if (i < s.size() && s[i] == '.') {
      i++;
      f0 = i;
      while (i < s.size() && s[i] >= '0' && s[i] <= '9') i++;
      frac_len = i - f0;
      // Cap fraction digits the way Python's exact-int math behaves for
      // practical inputs: accumulate into int128 (19+ digits saturate).
      for (size_t k = f0; k < i && k < f0 + 18; k++)
        frac_part = frac_part * 10 + (s[k] - '0');
      for (size_t k = f0 + 18; k < i; k++) frac_len--;  // drop beyond 18
    }
    if (int_len == 0 && frac_len == 0 && (i == f0)) return false;
    if (int_len == 0 && f0 == d0) return false;  // no digits at all
    size_t adv = 0;
    int64_t scale = match_unit(s, i, &adv);
    if (scale == 0) return false;
    i += adv;
    total += int_part * scale;
    if (frac_len > 0) {
      __int128 p10 = 1;
      for (size_t k = 0; k < frac_len; k++) p10 *= 10;
      total += frac_part * scale / p10;
    }
    if (total > (__int128)kInt64Max) return false;
  }
  int64_t v = (int64_t)total;
  *out = neg ? -v : v;
  return true;
}

// strconv.Atoi semantics (ops/rate.py:_atoi): optional sign, ASCII digits.
bool parse_atoi(const std::string& s, int64_t* out) {
  size_t i = 0;
  bool neg = false;
  if (i < s.size() && (s[i] == '+' || s[i] == '-')) {
    neg = s[i] == '-';
    i++;
  }
  if (i >= s.size()) return false;
  __int128 v = 0;
  for (; i < s.size(); i++) {
    if (s[i] < '0' || s[i] > '9') return false;
    v = v * 10 + (s[i] - '0');
    if (v > (__int128)kInt64Max + 1) return false;
  }
  if (!neg && v > (__int128)kInt64Max) return false;
  if (neg && v > (__int128)kInt64Max + 1) return false;
  *out = neg ? (int64_t)(-v) : (int64_t)v;
  return true;
}

// parse_rate "freq:duration" (ops/rate.py:177-192). false ⇒ malformed
// (callers use the zero Rate: unconditional 429, api.go:61).
bool parse_rate(const std::string& v, int64_t* freq, int64_t* per_ns) {
  std::string fpart = v, dpart = "1s";
  size_t colon = v.find(':');
  if (colon != std::string::npos) {
    fpart = v.substr(0, colon);
    dpart = v.substr(colon + 1);
  }
  if (!parse_atoi(fpart, freq)) return false;
  for (const char* u : kBareUnits) {
    if (dpart == u) {
      dpart = std::string("1") + u;
      break;
    }
  }
  return parse_duration(dpart, per_ns);
}

// ---- HTTP plumbing --------------------------------------------------------

int hexval(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

// Percent-decode. plus_to_space mirrors urllib parse_qs for query values;
// path segments keep '+' literal (urllib.unquote semantics).
std::string pct_decode(std::string_view s, bool plus_to_space) {
  std::string out;
  out.reserve(s.size());
  for (size_t i = 0; i < s.size(); i++) {
    if (s[i] == '%' && i + 2 < s.size()) {
      int hi = hexval(s[i + 1]), lo = hexval(s[i + 2]);
      if (hi >= 0 && lo >= 0) {
        out.push_back((char)((hi << 4) | lo));
        i += 2;
        continue;
      }
    }
    if (plus_to_space && s[i] == '+') {
      out.push_back(' ');
      continue;
    }
    out.push_back(s[i]);
  }
  return out;
}

// ---- Host-lane store (the C++ twin of runtime/engine.py HostLanes) --------
//
// The reference serves the whole /take decision natively in-process
// (api.go:51-86 → bucket.go:186-225). This store lets the epoll thread do
// the same for host-resident buckets: per-row PN lane blocks in plain
// int64 memory, shared with Python — the engine maps each block as numpy
// views (runtime/hoststore.py), so every Python-side operation (rx
// absorb, snapshot, checkpoint, promotion join) runs the EXISTING
// HostLanes code on the same bytes. One native mutex replaces the
// engine's _host_mu: Python takes it via pt_hls_lock/unlock (ctypes
// releases the GIL), the epoll thread takes it inline per take.
//
// Block layout (int64 words): added[nodes] | taken[nodes] | elapsed_ns |
// win_start_ns | win_takes | win_rx | resident | dirty.
constexpr int64_t kNano = 1000000000LL;

struct HostStore {
  std::mutex mu;
  int nodes = 0;
  int words = 0;          // per-block int64 words = 2*nodes + 6
  int64_t node_slot = 0;
  int64_t promote_takes = 0;  // <=0: native take pressure never promotes
  int64_t window_ns = 0;
  int64_t clock_offset_ns = 0;  // realtime → injected-clock domain
  const int64_t* cap_base = nullptr;  // Python directory arrays (stable
  const int64_t* created = nullptr;   // fixed-size allocations)
  int64_t* last_used = nullptr;       // LRU stamps (eviction input)
  // row → block. Blocks are immortal until store destroy: a popped
  // (promoted/evicted) row's Python views stay valid, and a re-host of
  // the same row reuses its block (bounded by rows ever hosted).
  std::unordered_map<int32_t, int64_t*> blocks;
  std::vector<int32_t> dirty_rows;    // coalesced-broadcast queue
  std::vector<int32_t> promote_rows;  // take-pressure threshold crossings
  // Event sequence for the pump's poll predicate (read without mu).
  std::atomic<uint64_t> events{0};
  uint64_t native_takes = 0;  // takes served by the epoll thread
};

HostStore* g_hls[16] = {nullptr};
std::mutex g_hls_mu;

inline int64_t sat_mul_nano(int64_t v) {
  if (v > kInt64Max / kNano) return kInt64Max;
  if (v < -(kInt64Max / kNano)) return -kInt64Max;
  return v * kNano;
}

// One take against a resident block. MUST mirror HostLanes.take
// (runtime/engine.py) step-for-step — the same lazy capacity base,
// monotonic-time guard, float64 refill grant, capacity cap (possibly
// negative ⇒ monotone forfeit booked as taken), conditional commit, and
// remaining_for_request(have, k, count_nt, 0) fan-out — so a bucket's
// observable behavior is identical whichever side serves it and the
// promotion join stays exact. Caller holds st->mu.
void hls_take_locked(HostStore* st, int64_t* blk, int32_t row, int64_t freq,
                     int64_t per_ns, int64_t count, int64_t now,
                     int64_t* remaining, int* ok, bool* events_bumped) {
  const int n = st->nodes;
  int64_t* added = blk;
  int64_t* taken = blk + n;
  int64_t* sc = blk + 2 * n;  // scalars (layout above)
  if (now - sc[1] > st->window_ns) {
    sc[1] = now;
    sc[2] = 0;
    sc[3] = 0;
  }
  sc[2]++;
  if (st->promote_takes > 0 && sc[2] == st->promote_takes + 1) {
    st->promote_rows.push_back(row);
    // Promotions wake the pump promptly (poll predicate); dirty marks
    // below deliberately don't — broadcasts coalesce on the pump's short
    // poll tick, so a take never pays a pump wakeup on its latency path.
    st->events.fetch_add(1, std::memory_order_relaxed);
    *events_bumped = true;
  }
  const int64_t cap = st->cap_base[row];
  const int64_t cap_now = sat_mul_nano(freq);
  int64_t sum_a = 0, sum_t = 0;
  for (int i = 0; i < n; i++) {
    sum_a += added[i];
    sum_t += taken[i];
  }
  const int64_t tokens = cap + sum_a - sum_t;
  int64_t last = st->created[row] + sc[0];
  if (now < last) last = now;
  const int64_t delta = now - last;  // >= 0 by the min above
  const int64_t interval = freq ? per_ns / freq : 0;
  int64_t grant = 0;
  if (freq != 0 && per_ns != 0 && interval != 0) {
    // float64(delta)/float64(interval) tokens then ·1e9, floored — the
    // exact expression (and operation order) of the kernel and of
    // HostLanes.take.
    double gf = ((double)delta / (double)interval) * 1e9;
    if (gf < 0.0) gf = 0.0;
    const double hi = 4611686018427387904.0;  // float(2**62), exact
    if (gf > hi) gf = hi;
    grant = (int64_t)std::floor(gf);
  }
  if (grant > cap_now - tokens) grant = cap_now - tokens;
  const int64_t have = tokens + grant;
  const int64_t count_nt = sat_mul_nano(count);
  const int k = (count_nt > 0 && have >= count_nt) ? 1 : 0;
  if (k) {
    const int64_t forfeit = grant < 0 ? -grant : 0;
    added[st->node_slot] += grant > 0 ? grant : 0;
    taken[st->node_slot] += count_nt + forfeit;
    sc[0] += delta;
  }
  int64_t rem = have - (k ? count_nt : 0);
  if (rem < 0) rem = 0;
  *remaining = rem / kNano;
  *ok = k;
  st->native_takes++;
  if (!sc[5]) {
    sc[5] = 1;
    st->dirty_rows.push_back(row);
  }
}

int64_t realtime_ns() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (int64_t)ts.tv_sec * kNano + ts.tv_nsec;
}

struct TakeRec {
  uint64_t tag;
  int32_t stream;  // h2 stream id; 0 = HTTP/1.1
  int64_t freq, per_ns, count;
  uint8_t name[kNameMax];
  int name_len;
};

struct OtherRec {
  uint64_t tag;
  int32_t stream;  // h2 stream id; 0 = HTTP/1.1
  char method[8];
  char target[kPathMax];  // path?query
  int target_len;
};

// ---- native h2c (VERDICT r4 item 9) ---------------------------------------
//
// The reference serves h2c from its single front (command.go:41-44); r4's
// splice satisfied protocol parity at python-front speed. This serves the
// h2 request/response framing DIRECTLY for the API's bodyless shapes:
// SETTINGS/PING/WINDOW_UPDATE handling, HEADERS (+CONTINUATION, padding,
// priority) with HPACK decoding delegated to the system libnghttp2
// inflater (the same battle-tested one net/h2.py and curl use; response
// headers use only HPACK literals-without-indexing, so no deflater), and
// flow-controlled DATA out. net/h2.py is the porting spec. When
// libnghttp2 is unavailable the old splice (python h2 backend) remains
// the fallback; the h1→h2c Upgrade dance stays a python-front feature.

struct Nghttp2 {
  void* handle = nullptr;
  int (*inflate_new)(void**) = nullptr;
  void (*inflate_del)(void*) = nullptr;
  ssize_t (*inflate_hd2)(void*, void* nv, int* flags, const uint8_t* in,
                         size_t inlen, int in_final) = nullptr;
  int (*inflate_end_headers)(void*) = nullptr;
  bool ok() const { return inflate_hd2 != nullptr; }
};

struct NgNV {  // nghttp2_nv layout (name/value pointers + lengths + flags)
  uint8_t* name;
  uint8_t* value;
  size_t namelen;
  size_t valuelen;
  uint8_t flags;
};

Nghttp2* load_nghttp2() {
  static Nghttp2 g;
  static std::once_flag once;
  std::call_once(once, [] {
    void* h = dlopen("libnghttp2.so.14", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libnghttp2.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return;
    g.handle = h;
    g.inflate_new = (int (*)(void**))dlsym(h, "nghttp2_hd_inflate_new");
    g.inflate_del = (void (*)(void*))dlsym(h, "nghttp2_hd_inflate_del");
    g.inflate_hd2 = (ssize_t (*)(void*, void*, int*, const uint8_t*, size_t,
                                 int))dlsym(h, "nghttp2_hd_inflate_hd2");
    g.inflate_end_headers =
        (int (*)(void*))dlsym(h, "nghttp2_hd_inflate_end_headers");
    if (!g.inflate_new || !g.inflate_del || !g.inflate_end_headers)
      g.inflate_hd2 = nullptr;
  });
  return g.ok() ? &g : nullptr;
}

constexpr int kH2HeadersFrame = 0x1;
constexpr int kH2Priority = 0x2;
constexpr int kH2RstStream = 0x3;
constexpr int kH2Settings = 0x4;
constexpr int kH2Ping = 0x6;
constexpr int kH2Goaway = 0x7;
constexpr int kH2WindowUpdate = 0x8;
constexpr int kH2Continuation = 0x9;
constexpr int kH2Data = 0x0;
constexpr uint8_t kH2FlagEndStream = 0x1;
constexpr uint8_t kH2FlagAck = 0x1;
constexpr uint8_t kH2FlagEndHeaders = 0x4;
constexpr uint8_t kH2FlagPadded = 0x8;
constexpr uint8_t kH2FlagPriority = 0x20;

// Peers must accept frames up to the h2 default; we never send larger
// (RFC 7540 §4.2: SETTINGS_MAX_FRAME_SIZE is never below this).
constexpr size_t kH2MaxSend = 16384;
// Hostile-input bounds: one header block, and the conn's total write
// backlog (an unread socket must backpressure, not buffer unboundedly).
constexpr size_t kH2MaxHeaderBlock = 64 * 1024;
constexpr size_t kH2MaxWbuf = 1 << 20;

// Client-reset stream ids remembered per conn (bounded; oldest pruned on
// overflow, each id pruned when a completion for it is dropped): ring-
// completed takes must not answer on a closed stream — HEADERS there is
// a STREAM_CLOSED/PROTOCOL_ERROR that can GOAWAY every other in-flight
// stream on the connection (ADVICE r5).
constexpr size_t kH2MaxResetTracked = 128;

struct H2State {
  void* inflater = nullptr;
  int64_t conn_send_window = 65535;
  int64_t peer_initial_window = 65535;
  // CONTINUATION accumulation for one in-flight header block.
  int32_t hdr_stream = 0;
  std::string hdr_block;
  // DATA parked behind a spent connection OR stream window:
  // (stream, body, stream_window_remaining).
  std::deque<std::tuple<int32_t, std::string, int64_t>> pending;
  uint64_t rx_data_unacked = 0;
  std::deque<int32_t> reset_streams;
};

void h2_append_frame(std::string& out, int type, uint8_t flags,
                     int32_t stream, const char* payload, size_t n) {
  out.push_back((char)((n >> 16) & 0xFF));
  out.push_back((char)((n >> 8) & 0xFF));
  out.push_back((char)(n & 0xFF));
  out.push_back((char)type);
  out.push_back((char)flags);
  out.push_back((char)((stream >> 24) & 0x7F));
  out.push_back((char)((stream >> 16) & 0xFF));
  out.push_back((char)((stream >> 8) & 0xFF));
  out.push_back((char)(stream & 0xFF));
  out.append(payload, n);
}

// HPACK literal-without-indexing, new name, no Huffman (RFC 7541 §6.2.2)
// — the always-valid canonical form net/h2.py uses for responses.
void hpack_literal(std::string& out, const char* name, size_t nlen,
                   const char* value, size_t vlen) {
  out.push_back('\0');
  auto prefix_int = [&](size_t n) {
    if (n < 127) {
      out.push_back((char)n);
      return;
    }
    out.push_back(127);
    n -= 127;
    while (n >= 128) {
      out.push_back((char)((n & 0x7F) | 0x80));
      n >>= 7;
    }
    out.push_back((char)n);
  };
  prefix_int(nlen);
  out.append(name, nlen);
  prefix_int(vlen);
  out.append(value, vlen);
}

struct Conn {
  int fd = -1;
  uint32_t gen = 0;
  std::string rbuf;
  std::string wbuf;
  size_t woff = 0;
  bool in_flight = false;   // one request at a time; pipelined bytes wait
  bool close_after = false;
  bool want_close = false;  // fully close once wbuf drains
  size_t body_skip = 0;     // request body bytes still to drain
  // h2c splice mode: this conn forwards raw bytes to/from its peer slot
  // (an h2 client conn and its backend conn form a pair) — the h2
  // protocol itself is served by the python front on the backend port.
  bool proxy = false;
  int peer_slot = -1;
  // Native h2c mode (preferred over the splice when libnghttp2 loads):
  // the connection speaks h2 frames directly; h2 != nullptr is the flag.
  H2State* h2 = nullptr;
  std::chrono::steady_clock::time_point req_start{};  // latency stamp
};

struct Server {
  int listen_fd = -1;
  int epoll_fd = -1;
  int event_fd = -1;
  uint16_t port = 0;
  std::thread thread;
  // Read by the epoll thread each loop, written by pt_http_stop from the
  // caller's thread: atomic, or the stop handshake is a data race.
  std::atomic<bool> running{false};

  std::mutex mu;
  std::condition_variable cv;  // signals the Python pump: work available
  std::vector<Conn> conns;     // slot-indexed
  std::vector<int> free_slots;
  uint16_t h2_backend_port = 0;  // 0 = h2c preface rejected with 400
  // In-front host serving (pt_http_attach_host): resolve via this C++
  // directory handle, serve host-resident rows from this store without
  // ever crossing into Python. -1/null = every take rides the ring.
  int dir_h = -1;
  HostStore* hls = nullptr;
  uint64_t hls_events_seen = 0;  // poll predicate cursor
  uint64_t hls_takes = 0;        // served in-front (this server)
  std::deque<TakeRec> take_q;
  std::deque<OtherRec> other_q;
  // Completions flow: pump → (mu) wbuf append → eventfd kick.

  // stats
  uint64_t accepted = 0, requests = 0, dropped = 0;
  // Server-side request latency (parse → response queued): a fixed-size
  // sample ring; percentiles computed on read. ~32 KB, overwrites oldest.
  static constexpr int kLatRing = 4096;
  uint64_t lat_ns[kLatRing] = {0};
  uint64_t lat_count = 0;
};

Server* g_servers[8] = {nullptr};
// Guards registry lookup+use in the completion entry points vs teardown:
// pt_http_stop nulls the slot under this mutex BEFORE deleting, and the
// completion calls hold it across their whole body, so a late completion
// can never touch a freed Server. (pt_http_poll is exempt: the Python
// front joins its pump thread before calling pt_http_stop.)
std::mutex g_reg_mu;

uint64_t make_tag(int slot, uint32_t gen) {
  return ((uint64_t)(uint32_t)slot << 32) | gen;
}

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

const char* status_text(int code) {
  switch (code) {
    case 200: return "OK";
    case 400: return "Bad Request";
    case 404: return "Not Found";
    case 405: return "Method Not Allowed";
    case 429: return "Too Many Requests";
    case 431: return "Request Header Fields Too Large";
    case 500: return "Internal Server Error";
    case 503: return "Service Unavailable";
    default: return "OK";
  }
}

// Append a full response to the conn's write buffer (mu held).
void queue_response(Server* s, Conn* c, int code, const char* ctype,
                    const char* body, size_t body_len) {
  if (c->req_start.time_since_epoch().count() != 0) {
    uint64_t ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                      std::chrono::steady_clock::now() - c->req_start)
                      .count();
    s->lat_ns[s->lat_count++ % Server::kLatRing] = ns;
    c->req_start = {};
  }
  char head[256];
  int hl = snprintf(head, sizeof(head),
                    "HTTP/1.1 %d %s\r\nContent-Type: %s\r\n"
                    "Content-Length: %zu\r\n%s\r\n",
                    code, status_text(code), ctype, body_len,
                    c->close_after ? "Connection: close\r\n" : "");
  // snprintf returns the would-be length on truncation; clamping keeps a
  // hostile/long Content-Type from overreading the stack buffer.
  if (hl > (int)sizeof(head) - 1) hl = (int)sizeof(head) - 1;
  c->wbuf.append(head, hl);
  c->wbuf.append(body, body_len);
  c->in_flight = false;
  if (c->close_after) c->want_close = true;
}

void epoll_mod(Server* s, int slot) {
  Conn& c = s->conns[slot];
  epoll_event ev{};
  ev.events = EPOLLIN | (c.wbuf.size() > c.woff ? EPOLLOUT : 0);
  ev.data.u64 = make_tag(slot, c.gen);
  epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, c.fd, &ev);
}

void close_conn(Server* s, int slot) {
  Conn& c = s->conns[slot];
  if (c.fd < 0) return;  // already closed (e.g. via a splice pair-close):
  // a second close must not re-push the slot into free_slots — two
  // accepts would then alias one Conn.
  epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, c.fd, nullptr);
  ::close(c.fd);
  c.fd = -1;
  c.gen++;  // invalidate outstanding tags
  if (c.h2) {
    if (c.h2->inflater) {
      Nghttp2* ng = load_nghttp2();
      if (ng) ng->inflate_del(c.h2->inflater);
    }
    delete c.h2;
    c.h2 = nullptr;
  }
  c.rbuf.clear();
  c.rbuf.shrink_to_fit();
  c.wbuf.clear();
  c.wbuf.shrink_to_fit();
  c.woff = 0;
  c.in_flight = c.close_after = c.want_close = false;
  c.body_skip = 0;
  int peer = c.peer_slot;
  c.proxy = false;
  c.peer_slot = -1;
  s->free_slots.push_back(slot);
  if (peer >= 0 && peer < (int)s->conns.size() &&
      s->conns[peer].peer_slot == slot) {
    // Unlink FIRST so the recursive close can't bounce back.
    s->conns[peer].peer_slot = -1;
    close_conn(s, peer);
  }
}

// Emit one stream's DATA, split to the always-valid frame size, debiting
// the connection window (the caller already cleared the stream window).
void h2_emit_data(Conn* c, int32_t stream, const char* body, size_t n) {
  c->h2->conn_send_window -= (int64_t)n;
  size_t off = 0;
  do {
    size_t chunk = std::min(n - off, kH2MaxSend);
    bool last = off + chunk == n;
    h2_append_frame(c->wbuf, kH2Data, last ? kH2FlagEndStream : 0, stream,
                    body + off, chunk);
    off += chunk;
  } while (off < n);
}

// Queue one h2 response (HEADERS + DATA/END_STREAM) onto the conn,
// respecting BOTH flow-control windows (HEADERS frames are exempt; DATA
// debits the connection window and must fit the stream's initial window
// — we send exactly one response per stream, so its window at send time
// is the peer's INITIAL_WINDOW_SIZE plus any stream WINDOW_UPDATEs,
// tracked only for parked responses). mu held.
void queue_h2_response(Server* s, Conn* c, int32_t stream, int code,
                       const char* ctype, const char* body,
                       size_t body_len) {
  // Client already reset the stream: drop the completion (and prune the
  // tracked id — one response per stream, so it cannot recur).
  auto& resets = c->h2->reset_streams;
  auto rit = std::find(resets.begin(), resets.end(), stream);
  if (rit != resets.end()) {
    resets.erase(rit);
    return;
  }
  std::string block;
  char st[8], cl[8];
  int stl = snprintf(st, sizeof(st), "%d", code);
  int cll = snprintf(cl, sizeof(cl), "%zu", body_len);
  hpack_literal(block, ":status", 7, st, stl);
  hpack_literal(block, "content-type", 12, ctype, strlen(ctype));
  hpack_literal(block, "content-length", 14, cl, cll);
  // Header blocks above the frame bound continue in CONTINUATION frames.
  size_t off = 0;
  bool first = true;
  do {
    size_t chunk = std::min(block.size() - off, kH2MaxSend);
    bool last = off + chunk == block.size();
    uint8_t fl = (last ? kH2FlagEndHeaders : 0) |
                 (first && body_len == 0 ? kH2FlagEndStream : 0);
    h2_append_frame(c->wbuf, first ? kH2HeadersFrame : kH2Continuation, fl,
                    stream, block.data() + off, chunk);
    first = false;
    off += chunk;
  } while (off < block.size());
  if (body_len == 0) return;
  H2State* h = c->h2;
  if ((int64_t)body_len <= h->conn_send_window &&
      (int64_t)body_len <= h->peer_initial_window) {
    h2_emit_data(c, stream, body, body_len);
  } else {
    // Spent window (connection, or a client that paused reads with a
    // tiny INITIAL_WINDOW_SIZE): park until WINDOW_UPDATEs arrive.
    h->pending.emplace_back(stream, std::string(body, body_len),
                            h->peer_initial_window);
  }
}

void h2_flush_pending(Server* s, Conn* c) {
  H2State* h = c->h2;
  while (!h->pending.empty()) {
    auto& [stream, body, swin] = h->pending.front();
    if ((int64_t)body.size() > h->conn_send_window ||
        (int64_t)body.size() > swin)
      break;
    h2_emit_data(c, stream, body.data(), body.size());
    h->pending.pop_front();
  }
}

bool try_parse_one(Server* s, int slot);  // fwd (h1 parser)
void serve_h2_request(Server* s, int slot, int32_t stream,
                      const std::string& method, const std::string& target);

// Decode one accumulated header block and dispatch the request. Returns
// false on a connection-fatal HPACK error.
bool h2_dispatch_headers(Server* s, int slot) {
  Conn& c = s->conns[slot];
  H2State* h = c.h2;
  Nghttp2* ng = load_nghttp2();
  std::string method, path;
  void* inf = h->inflater;
  const uint8_t* in = (const uint8_t*)h->hdr_block.data();
  size_t left = h->hdr_block.size();
  while (true) {
    NgNV nv{};
    int flags = 0;
    ssize_t used = ng->inflate_hd2(inf, &nv, &flags, in, left, 1);
    if (used < 0) return false;
    in += used;
    left -= (size_t)used;
    if (flags & 0x02 /*EMIT*/) {
      if (nv.namelen == 7 && memcmp(nv.name, ":method", 7) == 0)
        method.assign((const char*)nv.value, nv.valuelen);
      else if (nv.namelen == 5 && memcmp(nv.name, ":path", 5) == 0)
        path.assign((const char*)nv.value, nv.valuelen);
    }
    if (flags & 0x01 /*FINAL*/) break;
    if (used == 0 && !(flags & 0x02)) return false;  // stalled: malformed
  }
  ng->inflate_end_headers(inf);
  int32_t stream = h->hdr_stream;
  h->hdr_stream = 0;
  h->hdr_block.clear();
  serve_h2_request(s, slot, stream, method, path);
  return true;
}

// Process buffered h2 frames on an h2-mode conn (mu held). Returns false
// when the connection must close (protocol error / GOAWAY). Frames are
// walked by offset and the buffer compacted ONCE per call — a per-frame
// erase is quadratic over a pipelined client's event batch.
bool h2_process(Server* s, int slot) {
  Conn& c = s->conns[slot];
  H2State* h = c.h2;
  size_t pos = 0;
  bool ok = true;
  while (ok && c.rbuf.size() - pos >= 9) {
    const uint8_t* p = (const uint8_t*)c.rbuf.data() + pos;
    size_t len = ((size_t)p[0] << 16) | ((size_t)p[1] << 8) | p[2];
    int type = p[3];
    uint8_t flags = p[4];
    int32_t stream =
        (int32_t)((((uint32_t)p[5] & 0x7F) << 24) | ((uint32_t)p[6] << 16) |
                  ((uint32_t)p[7] << 8) | p[8]);
    if (len > (size_t)1 << 20) {  // absurd frame: kill conn
      ok = false;
      break;
    }
    if (c.rbuf.size() - pos < 9 + len) break;
    const uint8_t* pl = p + 9;
    // A CONTINUATION for an open header block must be exactly next.
    if (h->hdr_stream != 0 &&
        (type != kH2Continuation || stream != h->hdr_stream)) {
      ok = false;
      break;
    }
    switch (type) {
      case kH2Settings: {
        if (!(flags & kH2FlagAck)) {
          for (size_t i = 0; i + 6 <= len; i += 6) {
            uint16_t id = ((uint16_t)pl[i] << 8) | pl[i + 1];
            uint32_t v = ((uint32_t)pl[i + 2] << 24) |
                         ((uint32_t)pl[i + 3] << 16) |
                         ((uint32_t)pl[i + 4] << 8) | pl[i + 5];
            if (id == 0x4) {
              // RFC 7540 §6.9.2: the delta applies to every open
              // stream's window — ours are only the parked responses.
              int64_t delta = (int64_t)v - h->peer_initial_window;
              h->peer_initial_window = v;
              for (auto& [st_, body_, swin] : h->pending) swin += delta;
            }
          }
          h2_append_frame(c.wbuf, kH2Settings, kH2FlagAck, 0, "", 0);
          h2_flush_pending(s, &c);
        }
        break;
      }
      case kH2Ping:
        if (!(flags & kH2FlagAck) && len == 8)
          h2_append_frame(c.wbuf, kH2Ping, kH2FlagAck, 0, (const char*)pl, 8);
        break;
      case kH2WindowUpdate:
        if (len == 4) {
          uint32_t incr = (((uint32_t)pl[0] & 0x7F) << 24) |
                          ((uint32_t)pl[1] << 16) | ((uint32_t)pl[2] << 8) |
                          pl[3];
          if (stream == 0) {
            h->conn_send_window += incr;
          } else {
            for (auto& [st_, body_, swin] : h->pending)
              if (st_ == stream) swin += incr;
          }
          h2_flush_pending(s, &c);
        }
        break;
      case kH2HeadersFrame: {
        if (stream <= 0 || (stream & 1) == 0) {  // RFC 7540 §5.1.1
          ok = false;
          break;
        }
        size_t off = 0, tail = 0;
        if (flags & kH2FlagPadded) {
          if (len < 1) {
            ok = false;
            break;
          }
          tail = pl[0];
          off = 1;
        }
        if (flags & kH2FlagPriority) off += 5;
        if (off + tail > len || len - off - tail > kH2MaxHeaderBlock) {
          ok = false;
          break;
        }
        h->hdr_stream = stream;
        h->hdr_block.assign((const char*)pl + off, len - off - tail);
        if (flags & kH2FlagEndHeaders) ok = h2_dispatch_headers(s, slot);
        break;
      }
      case kH2Continuation:
        if (h->hdr_block.size() + len > kH2MaxHeaderBlock) {
          ok = false;  // unbounded-CONTINUATION flood
          break;
        }
        h->hdr_block.append((const char*)pl, len);
        if (flags & kH2FlagEndHeaders) ok = h2_dispatch_headers(s, slot);
        break;
      case kH2Data: {
        // API requests are bodyless; tolerate and drain bodies, crediting
        // BOTH flow-control windows back so clients never stall. The
        // connection window batches (32 KiB hysteresis); the per-stream
        // window is credited per frame — without it the comment's
        // "never stall" only held for bodies under the 64 KiB initial
        // stream window, and a larger upload wedged its stream
        // mid-body (ADVICE r5).
        h->rx_data_unacked += len;
        if (h->rx_data_unacked >= 32768) {
          uint8_t w[4] = {
              (uint8_t)((h->rx_data_unacked >> 24) & 0x7F),
              (uint8_t)(h->rx_data_unacked >> 16),
              (uint8_t)(h->rx_data_unacked >> 8),
              (uint8_t)h->rx_data_unacked,
          };
          h2_append_frame(c.wbuf, kH2WindowUpdate, 0, 0, (const char*)w, 4);
          h->rx_data_unacked = 0;
        }
        if (len > 0 && !(flags & kH2FlagEndStream)) {
          uint8_t w[4] = {
              (uint8_t)((len >> 24) & 0x7F),
              (uint8_t)(len >> 16),
              (uint8_t)(len >> 8),
              (uint8_t)len,
          };
          h2_append_frame(c.wbuf, kH2WindowUpdate, 0, stream,
                          (const char*)w, 4);
        }
        break;
      }
      case kH2Goaway:
        ok = false;
        break;
      case kH2RstStream: {
        if (len == 4 && stream > 0) {
          // Drop any parked response body for the stream, then remember
          // the id so a late ring completion is dropped too.
          for (auto it = h->pending.begin(); it != h->pending.end();)
            it = std::get<0>(*it) == stream ? h->pending.erase(it)
                                            : std::next(it);
          if (std::find(h->reset_streams.begin(), h->reset_streams.end(),
                        stream) == h->reset_streams.end()) {
            h->reset_streams.push_back(stream);
            if (h->reset_streams.size() > kH2MaxResetTracked)
              h->reset_streams.pop_front();
          }
        }
        break;
      }
      case kH2Priority:
      default:
        break;  // ignore (incl. unknown extension frames, RFC 7540 §4.1)
    }
    pos += 9 + len;
  }
  if (pos > 0) c.rbuf.erase(0, pos);
  // Write-backlog bound: an unread client socket must not buffer replies
  // without limit (PING floods, pipelined takes against a stalled
  // reader) — the h1 path's bound is its one-in-flight gate; this is
  // the h2 equivalent.
  if (c.wbuf.size() - c.woff > kH2MaxWbuf) ok = false;
  return ok;
}

// Turn an h2c client conn into a splice pair with a fresh backend conn
// to the python front (which speaks the actual h2 protocol). The client
// conn's buffered bytes (the preface and anything after it) are queued
// verbatim to the backend. Returns false when the backend is not
// configured or the connect fails — the caller falls back to the 400.
bool start_h2_proxy(Server* s, int slot) {
  if (s->h2_backend_port == 0) return false;
  int bfd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (bfd < 0) return false;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(s->h2_backend_port);
  inet_pton(AF_INET, "127.0.0.1", &addr.sin_addr);
  if (connect(bfd, (sockaddr*)&addr, sizeof(addr)) < 0 &&
      errno != EINPROGRESS) {
    ::close(bfd);
    return false;
  }
  int one = 1;
  setsockopt(bfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  int bslot;
  if (!s->free_slots.empty()) {
    bslot = s->free_slots.back();
    s->free_slots.pop_back();
  } else {
    bslot = (int)s->conns.size();
    s->conns.emplace_back();
  }
  // emplace_back may reallocate: re-take the client ref after.
  Conn& b = s->conns[bslot];
  Conn& c = s->conns[slot];
  b.fd = bfd;
  b.proxy = true;
  b.peer_slot = slot;
  b.wbuf.swap(c.rbuf);  // forward everything read so far (incl. preface)
  c.rbuf.clear();
  c.proxy = true;
  c.peer_slot = bslot;
  c.in_flight = false;
  c.req_start = {};
  epoll_event ev{};
  ev.events = EPOLLIN | (b.wbuf.size() ? EPOLLOUT : 0);
  ev.data.u64 = make_tag(bslot, b.gen);
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, bfd, &ev);
  return true;
}

// Shared /take query parsing (h1 + h2): first rate= and count= win
// (parse_qs[0] semantics); malformed rate ⇒ zero Rate (429, api.go:61).
void parse_take_query(std::string_view query, int64_t* freq,
                      int64_t* per_ns, int64_t* count) {
  *freq = *per_ns = *count = 0;
  bool have_rate = false, have_count = false;
  size_t qp = 0;
  while (qp <= query.size() && query.size()) {
    size_t amp = query.find('&', qp);
    if (amp == std::string::npos) amp = query.size();
    std::string_view kv = query.substr(qp, amp - qp);
    qp = amp + 1;
    size_t eq = kv.find('=');
    std::string_view k =
        kv.substr(0, eq == std::string_view::npos ? kv.size() : eq);
    std::string v = eq == std::string_view::npos
                        ? std::string()
                        : pct_decode(kv.substr(eq + 1), true);
    if (k == "rate" && !have_rate) {
      have_rate = true;
      if (!parse_rate(v, freq, per_ns)) *freq = *per_ns = 0;
    } else if (k == "count" && !have_count) {
      have_count = true;
      size_t b = 0, e2 = v.size();
      while (b < e2 && isspace((unsigned char)v[b])) b++;
      while (e2 > b && isspace((unsigned char)v[e2 - 1])) e2--;
      int64_t cv = 0;
      if (parse_atoi(v.substr(b, e2 - b), &cv) && cv >= 0) *count = cv;
    }
    if (amp == query.size()) break;
  }
  if (*count == 0) *count = 1;  // api.go:63-65 (incl. bad/negative count)
}

// In-front host-store take attempt (h1 + h2). Returns true when served,
// filling remaining/ok; false ⇒ the caller rides the Python ring.
bool try_inline_take(Server* s, const std::string& name, int64_t freq,
                     int64_t per_ns, int64_t count, int64_t* remaining,
                     int* ok, bool* events_bumped) {
  if (s->hls == nullptr || s->dir_h < 0) return false;
  alignas(8) uint8_t padded[kNameMax] = {0};
  memcpy(padded, name.data(), name.size());
  const int64_t now = realtime_ns() + s->hls->clock_offset_ns;
  std::lock_guard<std::mutex> hlk(s->hls->mu);
  int32_t row = pt_dir_resolve_rt(s->dir_h, padded, (int32_t)name.size(),
                                  s->hls->last_used, now);
  if (row < 0) return false;
  auto it = s->hls->blocks.find(row);
  if (it == s->hls->blocks.end() ||
      it->second[2 * s->hls->nodes + 4] == 0)
    return false;
  hls_take_locked(s->hls, it->second, row, freq, per_ns, count, now,
                  remaining, ok, events_bumped);
  return true;
}

// Dispatch one decoded h2 request (mu held): the same routing as the h1
// parser — in-front take, else the Python rings — answered as h2 frames
// on `stream`. No in_flight gate: h2 multiplexes streams per conn.
void serve_h2_request(Server* s, int slot, int32_t stream,
                      const std::string& method, const std::string& target) {
  Conn& c = s->conns[slot];
  s->requests++;
  // No per-conn req_start stamp here: h2 multiplexes streams, so a
  // single stamp would be overwritten by concurrent requests and
  // corrupt the latency ring. In-front takes are timed inline below;
  // ring-completed h2 requests go unsampled (h1 keeps sampling both).
  auto t0 = std::chrono::steady_clock::now();
  std::string path = target, query;
  size_t qm = target.find('?');
  if (qm != std::string::npos) {
    path = target.substr(0, qm);
    query = target.substr(qm + 1);
  }
  if (path.compare(0, 6, "/take/") == 0) {
    if (method != "POST") {
      queue_h2_response(s, &c, stream, 405, "text/plain",
                        "method not allowed\n", 19);
      return;
    }
    std::string name = pct_decode(path.substr(6), false);
    if (name.size() > kNameLimit) {
      char body[64];
      int bl = snprintf(body, sizeof(body), "bucket name larger than %d",
                        kNameLimit);
      queue_h2_response(s, &c, stream, 400, "text/plain", body, bl);
      return;
    }
    int64_t freq, per_ns, count;
    parse_take_query(query, &freq, &per_ns, &count);
    bool bumped = false;
    int64_t remaining = 0;
    int ok = 0;
    if (try_inline_take(s, name, freq, per_ns, count, &remaining, &ok,
                        &bumped)) {
      s->hls_takes++;
      char body[24];
      int bl = snprintf(body, sizeof(body), "%lld", (long long)remaining);
      queue_h2_response(s, &c, stream, ok ? 200 : 429, "text/plain", body,
                        bl);
      s->lat_ns[s->lat_count++ % Server::kLatRing] =
          std::chrono::duration_cast<std::chrono::nanoseconds>(
              std::chrono::steady_clock::now() - t0)
              .count();
      if (bumped) s->cv.notify_one();
      return;
    }
    if ((int)s->take_q.size() >= kRingCap) {
      s->dropped++;
      queue_h2_response(s, &c, stream, 503, "text/plain", "overloaded\n",
                        11);
      return;
    }
    TakeRec r{};
    r.tag = make_tag(slot, c.gen);
    r.stream = stream;
    r.freq = freq;
    r.per_ns = per_ns;
    r.count = count;
    r.name_len = (int)name.size();
    memcpy(r.name, name.data(), name.size());
    s->take_q.push_back(r);
    s->cv.notify_one();
    return;
  }
  if (target.size() >= kPathMax || (int)s->other_q.size() >= 1024) {
    queue_h2_response(s, &c, stream,
                      target.size() >= kPathMax ? 431 : 503, "text/plain",
                      "unavailable\n", 12);
    return;
  }
  OtherRec o{};
  o.tag = make_tag(slot, c.gen);
  o.stream = stream;
  snprintf(o.method, sizeof(o.method), "%.7s", method.c_str());
  memcpy(o.target, target.data(), target.size());
  o.target_len = (int)target.size();
  s->other_q.push_back(o);
  s->cv.notify_one();
}

// Activate native h2 on a preface-bearing conn: per-conn HPACK inflater
// + the server's (empty) SETTINGS preface. mu held.
bool start_h2_native(Server* s, int slot) {
  Nghttp2* ng = load_nghttp2();
  if (!ng) return false;
  Conn& c = s->conns[slot];
  H2State* h = new H2State();
  if (ng->inflate_new(&h->inflater) != 0) {
    delete h;
    return false;
  }
  c.h2 = h;
  c.in_flight = false;
  c.req_start = {};
  h2_append_frame(c.wbuf, kH2Settings, 0, 0, "", 0);
  return true;
}

// Parse one request out of c->rbuf (mu held). Returns false when more
// bytes are needed. May queue an immediate response or push ring records.
bool try_parse_one(Server* s, int slot) {
  Conn& c = s->conns[slot];
  if (c.in_flight || c.want_close || c.h2 != nullptr || c.proxy) return false;
  if (c.body_skip > 0) {
    size_t n = c.rbuf.size() < c.body_skip ? c.rbuf.size() : c.body_skip;
    c.rbuf.erase(0, n);
    c.body_skip -= n;
    if (c.body_skip > 0) return false;
  }
  size_t hdr_end = c.rbuf.find("\r\n\r\n");
  if (hdr_end == std::string::npos) {
    // h2c preface detection: reject cleanly (use the python front for h2).
    // Only the full 16-byte connection-preface request line ("PRI * ...")
    // triggers it — a request whose method merely starts with "PRI"
    // (e.g. "PRINT") must keep accumulating; and the 431 branch below is
    // exclusive so an oversized PRI-prefixed buffer queues ONE response.
    static const char kPreface[] = "PRI * HTTP/2.0\r\n";
    constexpr size_t kPrefaceLen = sizeof(kPreface) - 1;
    if (c.rbuf.size() >= kPrefaceLen &&
        c.rbuf.compare(0, kPrefaceLen, kPreface) == 0) {
      // h2c prior-knowledge client. Preference order: serve h2 natively
      // (libnghttp2 inflater available — wait for the full 24-byte
      // preface, which contains \r\n\r\n and so reaches the PRI method
      // branch below once ≥18 bytes arrive); else splice to the python
      // h2 backend; else reject cleanly.
      if (load_nghttp2() != nullptr) return false;  // accumulate
      if (start_h2_proxy(s, slot)) return false;
      c.close_after = true;
      queue_response(s, &c, 400, "text/plain", "h2c not supported here\n", 23);
    } else if (c.rbuf.size() > kRbufMax) {
      c.close_after = true;
      queue_response(s, &c, 431, "text/plain", "header too large\n", 17);
    }
    return false;
  }
  // Zero-copy parse: views over c.rbuf (valid until the single erase
  // below — everything that outlives it is materialized first). The
  // prior shape copied the whole header block plus ~6 substrings per
  // request; at 300k+ rps on one core that allocator churn was a
  // measurable slice of the budget.
  std::string_view head(c.rbuf.data(), hdr_end);
  size_t consumed = hdr_end + 4;

  // Request line.
  size_t eol = head.find("\r\n");
  std::string_view reqline =
      head.substr(0, eol == std::string_view::npos ? head.size() : eol);
  size_t sp1 = reqline.find(' ');
  size_t sp2 = reqline.rfind(' ');
  if (sp1 == std::string_view::npos || sp2 == sp1) {
    c.close_after = true;
    queue_response(s, &c, 400, "text/plain", "bad request\n", 12);
    c.rbuf.erase(0, consumed);
    return true;
  }
  std::string_view method = reqline.substr(0, sp1);
  std::string_view target = reqline.substr(sp1 + 1, sp2 - sp1 - 1);
  if (method == "PRI") {
    // A complete h2 preface ("PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n") contains
    // \r\n\r\n, so it reaches the normal parse path rather than the
    // incomplete-header preface check above. NOTHING was consumed yet, so
    // both handoffs see the raw buffer verbatim.
    static const char kFullPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
    if (load_nghttp2() != nullptr) {
      if (c.rbuf.size() < 24) return false;  // wait for the whole preface
      if (c.rbuf.compare(0, 24, kFullPreface, 24) == 0 &&
          start_h2_native(s, slot)) {
        c.rbuf.erase(0, 24);
        // Frames may already be buffered behind the preface.
        if (!h2_process(s, slot)) {
          close_conn(s, slot);
          return false;
        }
        return false;  // h2 conns never re-enter the h1 parser
      }
      // Malformed preface tail: fall through to the h1 400 below.
    }
    if (c.h2 == nullptr && start_h2_proxy(s, slot)) return false;
    c.close_after = true;
    queue_response(s, &c, 400, "text/plain", "h2c not supported here\n", 23);
    c.rbuf.erase(0, consumed);
    return true;
  }

  // Headers we care about: Content-Length, Connection — matched
  // case-insensitively in place, no per-line copies.
  auto ieq = [](std::string_view a, const char* b, size_t bn) {
    if (a.size() != bn) return false;
    for (size_t i = 0; i < bn; i++)
      if (tolower((unsigned char)a[i]) != b[i]) return false;
    return true;
  };
  size_t content_len = 0;
  bool conn_close = false;
  size_t pos = (eol == std::string_view::npos) ? head.size() : eol + 2;
  while (pos < head.size()) {
    size_t e = head.find("\r\n", pos);
    if (e == std::string_view::npos) e = head.size();
    std::string_view line = head.substr(pos, e - pos);
    pos = e + 2;
    size_t colon = line.find(':');
    if (colon == std::string_view::npos) continue;
    std::string_view key = line.substr(0, colon);
    size_t v0 = colon + 1;
    while (v0 < line.size() && line[v0] == ' ') v0++;
    std::string_view val = line.substr(v0);
    if (ieq(key, "content-length", 14)) {
      content_len = 0;
      for (char ch : val) {
        if (ch < '0' || ch > '9') break;
        if (content_len > kMaxContentLen / 10) {
          // Saturate past the sane bound (a 20+-digit value used to wrap
          // size_t to a small count — under-skipped body bytes then
          // reparsed as pipelined requests); the bound check after the
          // header loop turns this into a 400 + close.
          content_len = kMaxContentLen + 1;
          break;
        }
        content_len = content_len * 10 + (size_t)(ch - '0');
      }
    } else if (ieq(key, "connection", 10)) {
      for (size_t i = 0; i + 5 <= val.size(); i++) {
        if (tolower((unsigned char)val[i]) == 'c' &&
            tolower((unsigned char)val[i + 1]) == 'l' &&
            tolower((unsigned char)val[i + 2]) == 'o' &&
            tolower((unsigned char)val[i + 3]) == 's' &&
            tolower((unsigned char)val[i + 4]) == 'e') {
          conn_close = true;
          break;
        }
      }
    }
  }
  if (content_len > kMaxContentLen) {
    // Oversized (or saturated-overflow) Content-Length: reject and close.
    // The whole buffer is dropped — body bytes must never be re-parsed
    // as pipelined requests (the desync/request-smuggling surface).
    c.close_after = true;
    queue_response(s, &c, 400, "text/plain", "content length too large\n", 25);
    c.rbuf.clear();
    return true;
  }
  std::string_view path = target, query;
  size_t qm = target.find('?');
  if (qm != std::string_view::npos) {
    path = target.substr(0, qm);
    query = target.substr(qm + 1);
  }
  // Materialize everything that outlives the erase BEFORE it runs: the
  // views above point into c.rbuf.
  const bool is_take = path.compare(0, 6, "/take/") == 0;
  const bool is_post = method == "POST";
  std::string name;
  int64_t freq = 0, per_ns = 0, count = 1;
  OtherRec o{};
  if (is_take) {
    if (is_post) {
      name = pct_decode(path.substr(6), false);
      parse_take_query(query, &freq, &per_ns, &count);
    }
  } else if (target.size() < kPathMax) {
    o.tag = make_tag(slot, c.gen);
    snprintf(o.method, sizeof(o.method), "%.*s",
             (int)std::min(method.size(), (size_t)7), method.data());
    memcpy(o.target, target.data(), target.size());
    o.target_len = (int)target.size();
  }
  const bool target_oversize = target.size() >= kPathMax;

  c.rbuf.erase(0, consumed);
  // Drain any request body (take input rides the URL, api.py contract).
  if (content_len > 0) {
    size_t n = c.rbuf.size() < content_len ? c.rbuf.size() : content_len;
    c.rbuf.erase(0, n);
    c.body_skip = content_len - n;
  }
  c.close_after = conn_close;
  s->requests++;
  c.req_start = std::chrono::steady_clock::now();

  if (is_take) {
    if (!is_post) {
      queue_response(s, &c, 405, "text/plain", "method not allowed\n", 19);
      return true;
    }
    if (name.size() > kNameLimit) {
      // api.go:55-58 → 400 with the error text.
      char body[64];
      int bl = snprintf(body, sizeof(body), "bucket name larger than %d", kNameLimit);
      queue_response(s, &c, 400, "text/plain", body, bl);
      return true;
    }

    // In-front fast path: a host-resident bucket's whole take decision —
    // resolve, lane arithmetic, response — runs here on the epoll thread,
    // the reference's in-process shape (api.go:51-86). The resolve runs
    // INSIDE the store's critical section: re-hosting a recycled row
    // requires the same mutex (_host_mu IS this lock), so the pair can
    // never be interleaved by evict→rebind→rehost and charge the wrong
    // bucket; the nested tab_mu(shared) is cycle-free. Misses (unknown
    // names, device-resident rows) fall through to the Python ring,
    // which binds/hosts/promotes exactly as before.
    {
      bool bumped = false;
      int64_t remaining = 0;
      int ok = 0;
      if (try_inline_take(s, name, freq, per_ns, count, &remaining, &ok,
                          &bumped)) {
        s->hls_takes++;
        char body[24];
        int bl = snprintf(body, sizeof(body), "%lld", (long long)remaining);
        queue_response(s, &c, ok ? 200 : 429, "text/plain", body, bl);
        // Promotions wake the pump promptly (poll predicate); broadcast
        // dirty marks ride the pump's short poll tick instead.
        if (bumped) s->cv.notify_one();
        return true;
      }
    }

    if ((int)s->take_q.size() >= kRingCap) {
      s->dropped++;
      queue_response(s, &c, 503, "text/plain", "overloaded\n", 11);
      return true;
    }
    TakeRec r{};
    r.tag = make_tag(slot, c.gen);
    r.freq = freq;
    r.per_ns = per_ns;
    r.count = count;
    r.name_len = (int)name.size();
    memcpy(r.name, name.data(), name.size());
    c.in_flight = true;
    s->take_q.push_back(r);
    s->cv.notify_one();
    return true;
  }

  // Slow path: hand method+target to Python (debug routes, 404s). The
  // record was filled BEFORE the erase (the views are dead by now).
  if (target_oversize || (int)s->other_q.size() >= 1024) {
    queue_response(s, &c, target_oversize ? 431 : 503, "text/plain",
                   "unavailable\n", 12);
    return true;
  }
  c.in_flight = true;
  s->other_q.push_back(o);
  s->cv.notify_one();
  return true;
}

void flush_writes(Server* s, int slot) {
  while (true) {
    Conn& c = s->conns[slot];  // re-take: try_parse_one may grow conns
    while (c.woff < c.wbuf.size()) {
      ssize_t n = ::send(c.fd, c.wbuf.data() + c.woff, c.wbuf.size() - c.woff,
                         MSG_NOSIGNAL);
      if (n > 0) {
        c.woff += (size_t)n;
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        epoll_mod(s, slot);  // arm EPOLLOUT
        return;
      }
      close_conn(s, slot);
      return;
    }
    c.wbuf.clear();
    c.woff = 0;
    if (c.want_close) {
      close_conn(s, slot);
      return;
    }
    if (c.proxy) break;  // splice conns carry no h1 requests to parse
    // Response done: a pipelined next request may already be buffered —
    // and may queue an immediate response (405/400), so loop until the
    // write buffer stays empty.
    bool parsed = false;
    while (try_parse_one(s, slot)) parsed = true;
    if (!parsed || s->conns[slot].wbuf.empty()) break;
  }
  if (s->conns[slot].fd >= 0) epoll_mod(s, slot);
}

void serve_loop(Server* s) {
  epoll_event evs[256];
  while (s->running.load(std::memory_order_relaxed)) {
    int n = epoll_wait(s->epoll_fd, evs, 256, 100);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    std::unique_lock<std::mutex> lk(s->mu);
    for (int i = 0; i < n; i++) {
      uint64_t tag = evs[i].data.u64;
      if (tag == (uint64_t)-1) {  // listen socket
        while (true) {
          int fd = accept4(s->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (fd < 0) break;
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          int slot;
          if (!s->free_slots.empty()) {
            slot = s->free_slots.back();
            s->free_slots.pop_back();
          } else {
            slot = (int)s->conns.size();
            s->conns.emplace_back();
          }
          Conn& c = s->conns[slot];
          c.fd = fd;
          s->accepted++;
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.u64 = make_tag(slot, c.gen);
          epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, fd, &ev);
        }
        continue;
      }
      if (tag == (uint64_t)-2) {  // eventfd kick: completions queued
        uint64_t v;
        ssize_t rd = read(s->event_fd, &v, 8);
        (void)rd;
        // Flush every conn with pending writes.
        for (int slot = 0; slot < (int)s->conns.size(); slot++) {
          if (s->conns[slot].fd >= 0 &&
              s->conns[slot].wbuf.size() > s->conns[slot].woff)
            flush_writes(s, slot);
        }
        continue;
      }
      int slot = (int)(tag >> 32);
      uint32_t gen = (uint32_t)tag;
      if (slot >= (int)s->conns.size() || s->conns[slot].gen != gen ||
          s->conns[slot].fd < 0)
        continue;
      Conn& c = s->conns[slot];
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        close_conn(s, slot);
        continue;
      }
      if (evs[i].events & EPOLLIN) {
        char buf[8192];
        bool closed = false;
        while (true) {
          ssize_t rd = recv(c.fd, buf, sizeof(buf), 0);
          if (rd > 0) {
            c.rbuf.append(buf, rd);
            // Hostile-flood cap: h1 conns only. A splice conn's rbuf is
            // a transit buffer cleared every event (large h2 bodies are
            // legitimate); its backpressure is the peer-wbuf cap below.
            // Native-h2 conns drain frame-by-frame per event with a 1 MB
            // frame sanity bound of their own. A conn that opened with the
            // h2 preface is an h2 conn before its handoff: a client may
            // send a whole 64 KiB stream window of DATA behind the preface,
            // and one read can hold all of it.
            if (!c.proxy && c.h2 == nullptr &&
                c.rbuf.size() > (size_t)kRbufMax * 4 &&
                c.rbuf.compare(0, 16, "PRI * HTTP/2.0\r\n") != 0) {
              closed = true;
              break;
            }
            continue;
          }
          if (rd == 0) closed = true;
          break;  // EAGAIN or close
        }
        if (c.proxy && c.peer_slot < 0) {
          // Orphaned splice (peer closed; we survive only to drain
          // want_close writes): incoming bytes have no destination —
          // discard them (unbounded rbuf otherwise, the flood cap is
          // proxy-exempt), and EOF closes NOW (the h1 tail below skips
          // proxy conns, which would leave a level-triggered EPOLLIN
          // refiring on the dead socket forever).
          c.rbuf.clear();
          if (closed) close_conn(s, slot);
          continue;
        }
        if (c.proxy && c.peer_slot >= 0) {
          // Splice: everything read forwards verbatim to the peer.
          Conn& p = s->conns[c.peer_slot];
          if (!c.rbuf.empty()) {
            p.wbuf.append(c.rbuf);
            c.rbuf.clear();
          }
          if (p.wbuf.size() - p.woff > (size_t)kRbufMax * 16) {
            close_conn(s, slot);  // runaway peer backlog: drop the pair
            continue;
          }
          if (p.fd >= 0 && p.wbuf.size() > p.woff)
            flush_writes(s, c.peer_slot);
          if (closed) {
            // Half-close: let the peer DRAIN its pending bytes (the tail
            // of an h2 response/GOAWAY) before closing — an immediate
            // pair-close would clear its wbuf mid-flight.
            int peer = c.peer_slot;
            c.peer_slot = -1;
            if (peer >= 0 && s->conns[peer].fd >= 0 &&
                s->conns[peer].peer_slot == slot) {
              Conn& pc = s->conns[peer];
              pc.peer_slot = -1;  // unlink: no recursive close
              if (pc.wbuf.size() > pc.woff) {
                pc.want_close = true;  // close once drained
              } else {
                close_conn(s, peer);
              }
            }
            close_conn(s, slot);
            continue;
          }
          continue;
        }
        if (c.h2 != nullptr) {
          // Native h2: frame processing replaces the h1 parser entirely.
          if (!h2_process(s, slot)) {
            close_conn(s, slot);
            continue;
          }
          Conn& ch = s->conns[slot];
          if (ch.fd >= 0 && ch.wbuf.size() > ch.woff) flush_writes(s, slot);
          if (closed && s->conns[slot].fd >= 0) close_conn(s, slot);
          continue;
        }
        if (closed && c.rbuf.empty()) {
          close_conn(s, slot);
          continue;
        }
        while (try_parse_one(s, slot)) {
        }
        // Re-take the ref: an h2 handoff inside try_parse_one may have
        // grown the conn table (reference invalidation) and turned this
        // conn into a splice.
        Conn& c2 = s->conns[slot];
        if (c2.fd >= 0 && c2.wbuf.size() > c2.woff) flush_writes(s, slot);
        if (closed && s->conns[slot].fd >= 0 && !s->conns[slot].in_flight &&
            !s->conns[slot].proxy)
          close_conn(s, slot);
      }
      if (s->conns[slot].fd >= 0 && (evs[i].events & EPOLLOUT))
        flush_writes(s, slot);
    }
  }
}

}  // namespace

extern "C" {

// Start a server; returns handle ≥0 or -errno.
int pt_http_start(const char* ip, uint16_t port) {
  int h = -1;
  for (int i = 0; i < 8; i++)
    if (!g_servers[i]) {
      h = i;
      break;
    }
  if (h < 0) return -EMFILE;

  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, ip, &addr.sin_addr) != 1) {
    ::close(fd);
    return -EINVAL;
  }
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0 || listen(fd, 1024) < 0) {
    int e = errno;
    ::close(fd);
    return -e;
  }

  Server* s = new Server();
  s->listen_fd = fd;
  socklen_t alen = sizeof(addr);
  getsockname(fd, (sockaddr*)&addr, &alen);
  s->port = ntohs(addr.sin_port);
  s->epoll_fd = epoll_create1(0);
  s->event_fd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.u64 = (uint64_t)-1;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, fd, &ev);
  ev.events = EPOLLIN;
  ev.data.u64 = (uint64_t)-2;
  epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->event_fd, &ev);
  s->running = true;
  s->thread = std::thread(serve_loop, s);
  g_servers[h] = s;
  return h;
}

int pt_http_port(int h) {
  Server* s = g_servers[h];
  return s ? s->port : -1;
}

// Configure the h2c splice backend (the python front's loopback h2
// server). 0 disables (preface → 400, the pre-r4 behavior).
int pt_http_set_h2_backend(int h, uint16_t port) {
  std::lock_guard<std::mutex> reg(g_reg_mu);
  Server* s = g_servers[h];
  if (!s) return -EBADF;
  std::lock_guard<std::mutex> lk(s->mu);
  s->h2_backend_port = port;
  return 0;
}

// Drain parsed requests. Blocks up to timeout_ms when both queues are
// empty (GIL released by ctypes). Fills up to cap_t takes and cap_o
// others; *n_other receives the other-count; returns the take-count.
int pt_http_poll(int h, int timeout_ms,
                 uint64_t* tags, int32_t* streams, uint8_t* names,
                 int* name_lens,
                 int64_t* freqs, int64_t* pers, int64_t* counts, int cap_t,
                 uint64_t* otags, int32_t* ostreams, uint8_t* otargets,
                 int* otarget_lens,
                 uint8_t* omethods, int cap_o, int* n_other) {
  Server* s = g_servers[h];
  if (!s) return -EBADF;
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->take_q.empty() && s->other_q.empty() && timeout_ms > 0) {
    auto pred = [&] {
      return !s->take_q.empty() || !s->other_q.empty() || !s->running ||
             (s->hls != nullptr &&
              s->hls->events.load(std::memory_order_relaxed) !=
                  s->hls_events_seen);
    };
#if defined(PT_STEADY_CV_WAIT)
    // Modern toolchain (gcc >= 12 / llvm >= 14, probed by check.sh):
    // the steady-clock wait_for is the correct form — immune to
    // realtime clock jumps — and its pthread_cond_clockwait lowering is
    // intercepted by these sanitizer runtimes.
    s->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
#else
    // wait_until(system_clock) rather than wait_for: wait_for's
    // steady_clock lowers to pthread_cond_clockwait, which the gcc-10
    // libtsan doesn't intercept — TSan then never sees the mutex release
    // inside the wait and reports every later acquisition as a double
    // lock (the checker must stay usable; scripts/check.sh runs it). A
    // realtime-clock jump can only shorten/stretch one poll timeout.
    s->cv.wait_until(
        lk,
        std::chrono::system_clock::now() +
            std::chrono::milliseconds(timeout_ms),
        pred);
#endif
  }
  if (s->hls != nullptr)
    s->hls_events_seen = s->hls->events.load(std::memory_order_relaxed);
  int nt = 0;
  while (nt < cap_t && !s->take_q.empty()) {
    TakeRec& r = s->take_q.front();
    tags[nt] = r.tag;
    streams[nt] = r.stream;
    memset(names + nt * kNameMax, 0, kNameMax);
    memcpy(names + nt * kNameMax, r.name, r.name_len);
    name_lens[nt] = r.name_len;
    freqs[nt] = r.freq;
    pers[nt] = r.per_ns;
    counts[nt] = r.count;
    s->take_q.pop_front();
    nt++;
  }
  int no = 0;
  while (no < cap_o && !s->other_q.empty()) {
    OtherRec& o = s->other_q.front();
    otags[no] = o.tag;
    ostreams[no] = o.stream;
    memcpy(otargets + no * kPathMax, o.target, o.target_len);
    otarget_lens[no] = o.target_len;
    memset(omethods + no * 8, 0, 8);
    memcpy(omethods + no * 8, o.method, strnlen(o.method, 7));
    s->other_q.pop_front();
    no++;
  }
  *n_other = no;
  return nt;
}

// Complete a batch of takes: status 200/429 + remaining-tokens body.
// streams[i] > 0 answers on that h2 stream; 0 = HTTP/1.1.
int pt_http_complete_takes(int h, const uint64_t* tags,
                           const int32_t* streams, const int* statuses,
                           const int64_t* remaining, int n) {
  std::lock_guard<std::mutex> reg(g_reg_mu);
  Server* s = g_servers[h];
  if (!s) return -EBADF;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    for (int i = 0; i < n; i++) {
      int slot = (int)(tags[i] >> 32);
      uint32_t gen = (uint32_t)tags[i];
      if (slot >= (int)s->conns.size()) continue;
      Conn& c = s->conns[slot];
      if (c.fd < 0 || c.gen != gen) continue;  // conn died mid-flight
      char body[24];
      int bl = snprintf(body, sizeof(body), "%lld", (long long)remaining[i]);
      if (streams[i] > 0 && c.h2 != nullptr)
        queue_h2_response(s, &c, streams[i], statuses[i], "text/plain",
                          body, bl);
      else
        queue_response(s, &c, statuses[i], "text/plain", body, bl);
    }
  }
  uint64_t one = 1;
  ssize_t wr = write(s->event_fd, &one, 8);
  (void)wr;
  return 0;
}

// Complete one slow-path request with an arbitrary body.
int pt_http_complete_other(int h, uint64_t tag, int32_t stream, int status,
                           const char* ctype, const uint8_t* body,
                           int body_len) {
  std::lock_guard<std::mutex> reg(g_reg_mu);
  Server* s = g_servers[h];
  if (!s) return -EBADF;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    int slot = (int)(tag >> 32);
    uint32_t gen = (uint32_t)tag;
    if (slot < (int)s->conns.size()) {
      Conn& c = s->conns[slot];
      if (c.fd >= 0 && c.gen == gen) {
        if (stream > 0 && c.h2 != nullptr)
          queue_h2_response(s, &c, stream, status, ctype,
                            (const char*)body, body_len);
        else
          queue_response(s, &c, status, ctype, (const char*)body, body_len);
      }
    }
  }
  uint64_t one = 1;
  ssize_t wr = write(s->event_fd, &one, 8);
  (void)wr;
  return 0;
}

// out8 = {accepted, requests, active_conns, dropped, lat_p50_ns,
// lat_p99_ns, lat_max_ns, lat_samples} — latency is server-side
// (request parsed → response queued) over a 4096-sample ring.
int pt_http_stats(int h, uint64_t* out8) {
  std::lock_guard<std::mutex> reg(g_reg_mu);
  Server* s = g_servers[h];
  if (!s) return -EBADF;
  std::lock_guard<std::mutex> lk(s->mu);
  out8[0] = s->accepted;
  out8[1] = s->requests;
  out8[2] = 0;
  for (const auto& c : s->conns)
    if (c.fd >= 0) out8[2]++;
  out8[3] = s->dropped;
  uint64_t n = s->lat_count < Server::kLatRing ? s->lat_count : Server::kLatRing;
  out8[4] = out8[5] = out8[6] = 0;
  out8[7] = n;
  if (n > 0) {
    std::vector<uint64_t> lat(s->lat_ns, s->lat_ns + n);
    std::sort(lat.begin(), lat.end());
    out8[4] = lat[n / 2];
    out8[5] = lat[(size_t)(n * 0.99) < n ? (size_t)(n * 0.99) : n - 1];
    out8[6] = lat[n - 1];
  }
  return 0;
}

int pt_http_stop(int h) {
  Server* s;
  {
    // Unregister FIRST (under the registry lock) so any completion that
    // races with shutdown either sees the slot and finishes before we
    // proceed, or sees nullptr and returns EBADF — never a freed Server.
    std::lock_guard<std::mutex> reg(g_reg_mu);
    s = g_servers[h];
    if (!s) return -EBADF;
    g_servers[h] = nullptr;
  }
  s->running = false;
  s->cv.notify_all();
  uint64_t one = 1;
  ssize_t wr = write(s->event_fd, &one, 8);
  (void)wr;
  if (s->thread.joinable()) s->thread.join();
  {
    std::lock_guard<std::mutex> lk(s->mu);
    for (int i = 0; i < (int)s->conns.size(); i++)
      if (s->conns[i].fd >= 0) close_conn(s, i);
  }
  ::close(s->listen_fd);
  ::close(s->epoll_fd);
  ::close(s->event_fd);
  delete s;
  return 0;
}

// Closed-loop load client: `conns` keep-alive connections, each keeping
// `pipeline` requests in flight, for `duration_ms`. A C++ client is the
// only way to measure the server on a 1-core box — a Python client costs
// more per request than the C++ front does and dominates the machine.
// `target` may be a single path or many paths joined by '\n'; requests
// cycle through them round-robin (how the zipf multi-bucket workloads
// are driven: the caller pre-samples the key distribution into paths).
// out5 = {requests_completed, p50_ns, p99_ns, ok_200, limited_429}
// (latency per response at pipeline depth, i.e. includes queueing behind
// the pipeline window; the status split feeds admitted-vs-limit checks).
int pt_http_blast(const char* ip, uint16_t port, const char* target,
                  int conns, int pipeline, int duration_ms, uint64_t* out5) {
  std::vector<std::string> reqs;
  {
    const char* t = target;
    while (*t) {
      const char* e = strchr(t, '\n');
      size_t len = e ? (size_t)(e - t) : strlen(t);
      if (len)
        reqs.push_back("POST " + std::string(t, len) +
                       " HTTP/1.1\r\nHost: x\r\n\r\n");
      t += len + (e ? 1 : 0);
    }
  }
  if (reqs.empty()) return -EINVAL;
  size_t req_rr = 0;
  struct CC {
    int fd = -1;
    std::string rbuf;
    std::string wpend;  // partially-sent bytes (non-blocking send)
    size_t woff = 0;
    int inflight = 0;
    std::deque<std::chrono::steady_clock::time_point> sent;
  };
  std::vector<CC> cs(conns);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, ip, &addr.sin_addr) != 1) return -EINVAL;
  int ep = epoll_create1(0);
  for (int i = 0; i < conns; i++) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (connect(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
      ::close(fd);
      ::close(ep);
      return -errno;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    set_nonblock(fd);
    cs[i].fd = fd;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u32 = i;
    epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ev);
  }
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto t_end = now() + std::chrono::milliseconds(duration_ms);
  std::vector<uint64_t> lats;
  lats.reserve(1 << 20);
  uint64_t done = 0, ok200 = 0, lim429 = 0;

  auto pump_conn = [&](CC& c) {  // fill the pipeline window
    // Queue whole requests, then flush as far as the socket allows: a
    // partial non-blocking send must never splice the NEXT request into
    // the middle of a half-written one.
    while (c.inflight < pipeline) {
      c.wpend += reqs[req_rr++ % reqs.size()];
      c.inflight++;
      c.sent.push_back(now());
    }
    while (c.woff < c.wpend.size()) {
      ssize_t wr = ::send(c.fd, c.wpend.data() + c.woff,
                          c.wpend.size() - c.woff, MSG_NOSIGNAL);
      if (wr <= 0) break;  // EAGAIN: socket buffer full
      c.woff += (size_t)wr;
    }
    if (c.woff >= c.wpend.size()) {
      c.wpend.clear();
      c.woff = 0;
    }
  };
  for (auto& c : cs) pump_conn(c);

  epoll_event evs[64];
  char buf[65536];
  while (now() < t_end) {
    int n = epoll_wait(ep, evs, 64, 50);
    for (int i = 0; i < n; i++) {
      CC& c = cs[evs[i].data.u32];
      while (true) {
        ssize_t rd = recv(c.fd, buf, sizeof(buf), 0);
        if (rd <= 0) break;
        c.rbuf.append(buf, rd);
      }
      // Count complete responses (Content-Length framing).
      while (true) {
        size_t he = c.rbuf.find("\r\n\r\n");
        if (he == std::string::npos) break;
        size_t clen = 0;
        size_t p = c.rbuf.find("Content-Length:");
        if (p != std::string::npos && p < he)
          clen = strtoul(c.rbuf.c_str() + p + 15, nullptr, 10);
        if (c.rbuf.size() < he + 4 + clen) break;
        if (c.rbuf.size() >= 12 && c.rbuf.compare(9, 3, "200") == 0) ok200++;
        else if (c.rbuf.size() >= 12 && c.rbuf.compare(9, 3, "429") == 0) lim429++;
        c.rbuf.erase(0, he + 4 + clen);
        c.inflight--;
        done++;
        if (!c.sent.empty()) {
          lats.push_back(std::chrono::duration_cast<std::chrono::nanoseconds>(
                             now() - c.sent.front())
                             .count());
          c.sent.pop_front();
        }
      }
      pump_conn(c);
    }
  }
  for (auto& c : cs) ::close(c.fd);
  ::close(ep);
  out5[0] = done;
  if (!lats.empty()) {
    std::sort(lats.begin(), lats.end());
    out5[1] = lats[lats.size() / 2];
    out5[2] = lats[(size_t)(lats.size() * 0.99)];
  } else {
    out5[1] = out5[2] = 0;
  }
  out5[3] = ok200;
  out5[4] = lim429;
  return 0;
}

// ---- Host-lane store ABI --------------------------------------------------

// Create a store. cap_base/created/last_used are the Python directory's
// fixed-size int64 arrays (stable allocations; the C++ side reads the
// first two and stamps the third). promote_takes <= 0 disables native
// take-pressure promotion: an in-front take costs ~0.2 µs, so unlike the
// Python host path there is no QPS past which the device tick serves ONE
// row's takes faster — promotion stays rx-pressure/scalar-driven.
int pt_hls_create(int nodes, int64_t node_slot, int64_t promote_takes,
                  int64_t window_ns, int64_t clock_offset_ns,
                  const int64_t* cap_base, const int64_t* created,
                  int64_t* last_used) {
  std::lock_guard<std::mutex> reg(g_hls_mu);
  int h = -1;
  for (int i = 0; i < 16; i++)
    if (!g_hls[i]) {
      h = i;
      break;
    }
  if (h < 0) return -EMFILE;
  HostStore* st = new HostStore();
  st->nodes = nodes;
  st->words = 2 * nodes + 6;
  st->node_slot = node_slot;
  st->promote_takes = promote_takes;
  st->window_ns = window_ns;
  st->clock_offset_ns = clock_offset_ns;
  st->cap_base = cap_base;
  st->created = created;
  st->last_used = last_used;
  g_hls[h] = st;
  return h;
}

// Destroy: caller (engine.stop) must guarantee the HTTP front is detached
// and no Python proxy views the blocks afterwards.
int pt_hls_destroy(int h) {
  HostStore* st;
  {
    std::lock_guard<std::mutex> reg(g_hls_mu);
    st = g_hls[h];
    if (!st) return -EBADF;
    g_hls[h] = nullptr;
  }
  for (auto& kv : st->blocks) delete[] kv.second;
  delete st;
  return 0;
}

// Python's _host_mu: ctypes releases the GIL for the blocking acquire, so
// the epoll thread (which never takes the GIL) cannot deadlock it.
int pt_hls_lock(int h) {
  HostStore* st = g_hls[h];
  if (!st) return -EBADF;
  st->mu.lock();
  return 0;
}

int pt_hls_unlock(int h) {
  HostStore* st = g_hls[h];
  if (!st) return -EBADF;
  st->mu.unlock();
  return 0;
}

// Get-or-create the row's block, zeroed, resident. Returns the block
// address for numpy views (0 on failure). Caller holds the store lock.
int64_t pt_hls_host_locked(int h, int32_t row) {
  HostStore* st = g_hls[h];
  if (!st) return 0;
  int64_t*& blk = st->blocks[row];
  if (blk == nullptr) blk = new int64_t[st->words];
  std::memset(blk, 0, sizeof(int64_t) * st->words);
  blk[2 * st->nodes + 4] = 1;  // resident
  return (int64_t)(intptr_t)blk;
}

// Stop serving the row in-front (promotion pop / eviction / release).
// The block and its Python views stay valid. Caller holds the store lock.
int pt_hls_unhost_locked(int h, int32_t row) {
  HostStore* st = g_hls[h];
  if (!st) return -EBADF;
  auto it = st->blocks.find(row);
  if (it != st->blocks.end()) it->second[2 * st->nodes + 4] = 0;
  return 0;
}

// Drain pending events: dirty rows (coalesced-broadcast queue; flags
// cleared) and promote rows. For each dirty row, `snap` receives a
// consistent lane snapshot — added[nodes] | taken[nodes] | elapsed, one
// stride of 2*nodes+1 int64 per row — taken HERE, in C++, under the
// lock, so the caller's per-row Python work (which previously held the
// store mutex for ~ms per drain at 1000 dirty rows and showed up as the
// front's p99 tail) happens outside it. Caller holds the store lock.
int pt_hls_drain_locked(int h, int32_t* dirty_out, int64_t* snap, int cap_d,
                        int32_t* promote_out, int cap_p, int* n_promote) {
  HostStore* st = g_hls[h];
  if (!st) return -EBADF;
  // Pop at most cap rows; the remainder KEEPS its queue entries and dirty
  // flags, so overflow rows are re-delivered on the caller's next drain
  // (a silent truncation here would permanently lose a bucket's final
  // broadcast — the caller loops until both queues come back empty).
  const int stride = 2 * st->nodes + 1;
  int nd = 0;
  for (; nd < cap_d && nd < (int)st->dirty_rows.size(); nd++) {
    int32_t row = st->dirty_rows[nd];
    auto it = st->blocks.find(row);
    if (it != st->blocks.end()) {
      it->second[2 * st->nodes + 5] = 0;
      std::memcpy(snap + (size_t)nd * stride, it->second,
                  sizeof(int64_t) * (2 * st->nodes));
      snap[(size_t)nd * stride + 2 * st->nodes] = it->second[2 * st->nodes];
    } else {
      std::memset(snap + (size_t)nd * stride, 0, sizeof(int64_t) * stride);
    }
    dirty_out[nd] = row;
  }
  st->dirty_rows.erase(st->dirty_rows.begin(), st->dirty_rows.begin() + nd);
  int np = 0;
  for (; np < cap_p && np < (int)st->promote_rows.size(); np++)
    promote_out[np] = st->promote_rows[np];
  st->promote_rows.erase(st->promote_rows.begin(),
                         st->promote_rows.begin() + np);
  *n_promote = np;
  return nd;
}

// Promotion-event counter: bumped by the epoll thread's takes ONLY on a
// take-pressure promotion threshold crossing (hls_take_locked). Lock-free
// read — the pump compares it against its cursor after a poll wake and
// runs a promotions-only drain when it moved, bypassing the broadcast
// cadence gate so a newly-hot bucket leaves the slow path promptly.
int64_t pt_hls_events(int h) {
  HostStore* st = g_hls[h];
  if (!st) return -EBADF;
  return (int64_t)st->events.load(std::memory_order_relaxed);
}

// out4 = {native_takes, resident_rows, blocks_allocated, pending_events}.
int pt_hls_stats(int h, uint64_t* out4) {
  HostStore* st = g_hls[h];
  if (!st) return -EBADF;
  std::lock_guard<std::mutex> lk(st->mu);
  out4[0] = st->native_takes;
  uint64_t res = 0;
  for (auto& kv : st->blocks)
    if (kv.second[2 * st->nodes + 4]) res++;
  out4[1] = res;
  out4[2] = st->blocks.size();
  out4[3] = st->dirty_rows.size() + st->promote_rows.size();
  return 0;
}

// Wire the HTTP front to a store + C++ directory; -1/-1 detaches.
int pt_http_attach_host(int http_h, int hls_h, int dir_h) {
  std::lock_guard<std::mutex> reg(g_reg_mu);
  Server* s = g_servers[http_h];
  if (!s) return -EBADF;
  std::lock_guard<std::mutex> lk(s->mu);
  if (hls_h < 0) {
    s->hls = nullptr;
    s->dir_h = -1;
    return 0;
  }
  HostStore* st = g_hls[hls_h];
  if (!st) return -EBADF;
  s->hls = st;
  s->dir_h = dir_h;
  return 0;
}

// Test hook: run the EXACT in-front take path (resolve + residency +
// hls_take_locked) with a caller-controlled clock. Returns 1 (admitted),
// 0 (limited), -1 (not servable in front: miss or device-resident).
int pt_hls_take_probe(int hls_h, int dir_h, const uint8_t* name, int len,
                      int64_t freq, int64_t per_ns, int64_t count,
                      int64_t now, int64_t* remaining) {
  HostStore* st = g_hls[hls_h];
  if (!st) return -EBADF;
  alignas(8) uint8_t padded[kNameMax] = {0};
  if (len < 0 || len > kNameMax) return -EINVAL;
  std::memcpy(padded, name, (size_t)len);
  // Same shape as the front's inline path: resolve inside the store's
  // critical section (see try_parse_one).
  std::lock_guard<std::mutex> lk(st->mu);
  int32_t row = pt_dir_resolve_rt(dir_h, padded, len, st->last_used, now);
  if (row < 0) return -1;
  auto it = st->blocks.find(row);
  if (it == st->blocks.end() || it->second[2 * st->nodes + 4] == 0) return -1;
  bool bumped = false;
  int ok = 0;
  hls_take_locked(st, it->second, row, freq, per_ns, count, now, remaining,
                  &ok, &bumped);
  return ok;
}

// h2 prior-knowledge closed-loop load client: `conns` connections, each
// keeping `pipeline` streams in flight. The request HEADERS block uses
// HPACK literals-without-indexing only (stateless, always valid), so no
// deflater is needed; responses are counted by END_STREAM DATA frames
// and the :status literal is peeked from our server's known block shape.
// out5 = {requests_completed, p50_ns, p99_ns, ok_200, limited_429}.
int pt_http_blast_h2(const char* ip, uint16_t port, const char* target,
                     int conns, int pipeline, int duration_ms,
                     uint64_t* out5) {
  std::vector<std::string> head_frames;  // per-target HEADERS payloads
  {
    const char* t = target;
    while (*t) {
      const char* e = strchr(t, '\n');
      size_t len = e ? (size_t)(e - t) : strlen(t);
      if (len) {
        std::string block;
        hpack_literal(block, ":method", 7, "POST", 4);
        hpack_literal(block, ":scheme", 7, "http", 4);
        hpack_literal(block, ":authority", 10, "x", 1);
        hpack_literal(block, ":path", 5, t, len);
        head_frames.push_back(block);
      }
      t += len + (e ? 1 : 0);
    }
  }
  if (head_frames.empty()) return -EINVAL;
  size_t rr = 0;
  struct HC {
    int fd = -1;
    std::string rbuf, wpend;
    size_t woff = 0;
    int inflight = 0;
    int32_t next_stream = 1;
    uint64_t rx_data = 0;
    std::deque<std::chrono::steady_clock::time_point> sent;
  };
  std::vector<HC> cs(conns);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, ip, &addr.sin_addr) != 1) return -EINVAL;
  int ep = epoll_create1(0);
  for (int i = 0; i < conns; i++) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (connect(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
      ::close(fd);
      ::close(ep);
      return -errno;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    set_nonblock(fd);
    cs[i].fd = fd;
    cs[i].wpend.assign("PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n");
    h2_append_frame(cs[i].wpend, kH2Settings, 0, 0, "", 0);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u32 = i;
    epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ev);
  }
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto t_end = now() + std::chrono::milliseconds(duration_ms);
  std::vector<uint64_t> lats;
  lats.reserve(1 << 20);
  uint64_t done = 0, ok200 = 0, lim429 = 0;

  auto pump_conn = [&](HC& c) {
    while (c.inflight < pipeline) {
      const std::string& block = head_frames[rr++ % head_frames.size()];
      h2_append_frame(c.wpend, kH2HeadersFrame,
                      kH2FlagEndHeaders | kH2FlagEndStream, c.next_stream,
                      block.data(), block.size());
      c.next_stream += 2;
      c.inflight++;
      c.sent.push_back(now());
    }
    while (c.woff < c.wpend.size()) {
      ssize_t wr = ::send(c.fd, c.wpend.data() + c.woff,
                          c.wpend.size() - c.woff, MSG_NOSIGNAL);
      if (wr <= 0) break;
      c.woff += (size_t)wr;
    }
    if (c.woff >= c.wpend.size()) {
      c.wpend.clear();
      c.woff = 0;
    }
  };
  for (auto& c : cs) pump_conn(c);

  epoll_event evs[64];
  char buf[65536];
  while (now() < t_end) {
    int n = epoll_wait(ep, evs, 64, 50);
    for (int i = 0; i < n; i++) {
      HC& c = cs[evs[i].data.u32];
      while (true) {
        ssize_t rd = recv(c.fd, buf, sizeof(buf), 0);
        if (rd <= 0) break;
        c.rbuf.append(buf, rd);
      }
      size_t rpos = 0;
      while (c.rbuf.size() - rpos >= 9) {
        const uint8_t* p = (const uint8_t*)c.rbuf.data() + rpos;
        size_t len = ((size_t)p[0] << 16) | ((size_t)p[1] << 8) | p[2];
        if (c.rbuf.size() - rpos < 9 + len) break;
        int type = p[3];
        uint8_t flags = p[4];
        const uint8_t* pl = p + 9;
        if (type == kH2Settings && !(flags & kH2FlagAck)) {
          h2_append_frame(c.wpend, kH2Settings, kH2FlagAck, 0, "", 0);
        } else if (type == kH2HeadersFrame && len > 10 && pl[0] == 0 &&
                   pl[1] == 7) {
          // Our server's block: literal :status first; peek the value.
          const uint8_t* v = pl + 2 + 7 + 1;  // 0x00, len, ":status", vlen
          if (pl[9] >= 3 && v[0] == '2') ok200++;
          else if (pl[9] >= 3 && v[0] == '4') lim429++;
        } else if (type == kH2Data) {
          c.rx_data += len;
          if (flags & kH2FlagEndStream) {
            c.inflight--;
            done++;
            if (!c.sent.empty()) {
              lats.push_back(
                  std::chrono::duration_cast<std::chrono::nanoseconds>(
                      now() - c.sent.front())
                      .count());
              c.sent.pop_front();
            }
          }
          if (c.rx_data >= 16384) {
            uint8_t w[4] = {(uint8_t)((c.rx_data >> 24) & 0x7F),
                            (uint8_t)(c.rx_data >> 16),
                            (uint8_t)(c.rx_data >> 8), (uint8_t)c.rx_data};
            h2_append_frame(c.wpend, kH2WindowUpdate, 0, 0, (const char*)w,
                            4);
            c.rx_data = 0;
          }
        } else if (type == kH2Goaway) {
          rpos = c.rbuf.size();
          break;
        }
        rpos += 9 + len;
      }
      if (rpos > 0) c.rbuf.erase(0, rpos);
      pump_conn(c);
    }
  }
  for (auto& c : cs) ::close(c.fd);
  ::close(ep);
  out5[0] = done;
  if (!lats.empty()) {
    std::sort(lats.begin(), lats.end());
    out5[1] = lats[lats.size() / 2];
    out5[2] = lats[(size_t)(lats.size() * 0.99)];
  } else {
    out5[1] = out5[2] = 0;
  }
  out5[3] = ok200;
  out5[4] = lim429;
  return 0;
}

// Exposed for differential tests against ops/rate.py.
int pt_parse_rate(const char* v, int64_t* freq, int64_t* per_ns) {
  return parse_rate(std::string(v), freq, per_ns) ? 0 : -1;
}

int pt_parse_duration(const char* v, int64_t* out) {
  return parse_duration(std::string(v), out) ? 0 : -1;
}

}  // extern "C"
