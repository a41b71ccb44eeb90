// TSan exercise driver for patrol_host.cpp (the C++ host network path).
//
// The library is deliberately stateless (all state is per-fd kernel state
// or caller-owned buffers), but the production process calls it from
// multiple threads: the replication receive loop and the broadcast path
// share one socket fd, while encode/decode run on the engine feeder
// thread. This driver reproduces that concurrency shape — two senders,
// two receivers, and two codec threads hammering a loopback socket pair —
// so `-fsanitize=thread` can prove the no-shared-mutable-state claim.
//
// Reference concurrency bar: Go's `-race` on `go test ./...`
// (repo.go:13-14 documents the Repo thread-safety contract).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {
int pt_udp_open(const char* ip, uint16_t port);
int pt_udp_port(int fd);
void pt_udp_close(int fd);
int pt_recv_batch(int fd, uint8_t* buf, int max_packets, int row_stride,
                  int* sizes, uint32_t* ips, uint16_t* ports,
                  int64_t* stamps_ns, int timeout_ms);
int pt_send_fanout(int fd, const uint8_t* payloads, const int* sizes, int n,
                   int row_stride, const uint32_t* peer_ips,
                   const uint16_t* peer_ports, int n_peers);
int pt_decode_batch(const uint8_t* packets, const int* sizes, int n,
                    int in_stride, double* added, double* taken,
                    uint64_t* elapsed,
                    uint8_t* names, int* name_lens, int* origin_slots,
                    int64_t* caps, int64_t* lane_added, int64_t* lane_taken,
                    uint64_t* name_hashes, int* multi_flags);
int pt_encode_batch(const double* added, const double* taken,
                    const uint64_t* elapsed, const uint8_t* names,
                    const int* name_lens, const int* origin_slots,
                    const int64_t* caps, const int64_t* lane_added,
                    const int64_t* lane_taken, int n,
                    uint8_t* out, int* out_sizes);
int pt_dir_create(int64_t capacity, const uint8_t* name_bytes,
                  const int32_t* name_lens);
int pt_dir_insert(int h, uint64_t hash, int32_t row);
int pt_dir_delete(int h, uint64_t hash, int32_t row);
int pt_dir_destroy(int h);
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
                       uint8_t* out_scalar);
}

static constexpr int PACKET = 256;
static constexpr int BATCH = 64;
static constexpr int ROUNDS = 200;

static uint64_t fnv1a(const uint8_t* b, int len) {
  uint64_t h = 0xcbf29ce484222325ULL;
  for (int i = 0; i < len; i++) {
    h ^= b[i];
    h *= 0x100000001b3ULL;
  }
  return h;
}

// Directory concurrency scenario: the production contract is that every
// pt_dir_* / pt_rx_classify call runs under ONE python-side mutex per
// directory (patrol_host.cpp "Thread safety" note), with the rx thread
// classifying while the engine thread binds/unbinds. Reproduce that shape
// — two threads alternating classify / insert+delete under a shared
// mutex — so TSan proves the lock is sufficient (and would catch any
// racy global the registry or the rolling classify pipeline introduced).
static void dir_scenario() {
  constexpr int CAP = 512;
  std::vector<uint8_t> name_bytes(static_cast<size_t>(CAP) * PACKET, 0);
  std::vector<int32_t> name_lens_v(CAP, 0);
  int h = pt_dir_create(CAP, name_bytes.data(), name_lens_v.data());

  std::vector<uint8_t> pkt_names(static_cast<size_t>(BATCH) * PACKET, 0);
  std::vector<int32_t> lens(BATCH);
  std::vector<uint64_t> hashes(BATCH);
  for (int i = 0; i < BATCH; i++) {
    char buf[32];
    int n = snprintf(buf, sizeof buf, "dir-%d", i);
    memcpy(&pkt_names[static_cast<size_t>(i) * PACKET], buf, n);
    memcpy(&name_bytes[static_cast<size_t>(i) * PACKET], buf, n);
    name_lens_v[i] = n;
    lens[i] = n;
    hashes[i] = fnv1a(reinterpret_cast<const uint8_t*>(buf), n);
  }
  std::mutex mu;  // ≙ BucketDirectory._mu
  {
    std::lock_guard<std::mutex> g(mu);
    for (int i = 0; i < BATCH; i++) pt_dir_insert(h, hashes[i], i);
  }

  std::atomic<bool> stop{false};
  auto classifier = [&]() {
    std::vector<double> added(BATCH, 1.5), taken(BATCH, 0.5);
    std::vector<uint64_t> elapsed(BATCH, 1000);
    std::vector<int64_t> slots(BATCH), caps(BATCH, -1), la(BATCH, -1),
        lt(BATCH, -1);
    for (int i = 0; i < BATCH; i++) slots[i] = i % 4;
    std::vector<uint8_t> no_tr(BATCH, 0);
    std::vector<int64_t> cap_base(CAP, 1000000000);
    std::vector<int32_t> pins(CAP, 0);
    std::vector<int64_t> last_used(CAP, 0);
    std::vector<int64_t> rows(BATCH), oa(BATCH), ot(BATCH), oe(BATCH);
    std::vector<uint8_t> os_(BATCH);
    for (int r = 0; r < ROUNDS; r++) {
      std::lock_guard<std::mutex> g(mu);
      pt_rx_classify(h, BATCH, hashes.data(), pkt_names.data(), lens.data(),
                     added.data(), taken.data(), elapsed.data(), slots.data(),
                     4, caps.data(), la.data(), lt.data(), no_tr.data(),
                     cap_base.data(), pins.data(), last_used.data(), r,
                     rows.data(), oa.data(), ot.data(), oe.data(), os_.data());
      for (int i = 0; i < BATCH; i++)
        if (rows[i] >= 0) pins[rows[i]]--;  // ≙ unpin after queueing
    }
    stop.store(true);
  };
  auto binder = [&]() {
    // Churn a disjoint row range: bind/unbind like eviction + re-assign.
    int row = BATCH;
    while (!stop.load()) {
      char buf[32];
      int n = snprintf(buf, sizeof buf, "churn-%d", row);
      uint64_t hv = fnv1a(reinterpret_cast<const uint8_t*>(buf), n);
      {
        std::lock_guard<std::mutex> g(mu);
        memcpy(&name_bytes[static_cast<size_t>(row) * PACKET], buf, n);
        name_lens_v[row] = n;
        pt_dir_insert(h, hv, row);
        pt_dir_delete(h, hv, row);
      }
      row = BATCH + (row - BATCH + 1) % (CAP - BATCH);
    }
  };
  std::thread t1(classifier), t2(binder);
  t1.join();
  t2.join();
  pt_dir_destroy(h);
}

int main() {
  dir_scenario();
  int tx = pt_udp_open("127.0.0.1", 0);
  int rx = pt_udp_open("127.0.0.1", 0);
  if (tx < 0 || rx < 0) {
    fprintf(stderr, "socket open failed\n");
    return 1;
  }
  uint32_t loop_ip = (127u << 24) | 1u;
  uint16_t rx_port = static_cast<uint16_t>(pt_udp_port(rx));

  std::atomic<long> received{0};
  std::atomic<bool> stop{false};

  auto sender = [&](int seed) {
    double added[BATCH], taken[BATCH];
    uint64_t elapsed[BATCH];
    uint8_t names[BATCH * PACKET];
    int name_lens[BATCH], slots[BATCH], sizes[BATCH];
    int64_t caps[BATCH], lane_a[BATCH], lane_t[BATCH];
    uint8_t out[BATCH * PACKET];
    for (int r = 0; r < ROUNDS && !stop.load(); ++r) {
      for (int i = 0; i < BATCH; ++i) {
        added[i] = seed + i + r * 0.5;
        taken[i] = i * 0.25;
        elapsed[i] = static_cast<uint64_t>(r) * 1000 + i;
        int n = snprintf(reinterpret_cast<char*>(names + i * PACKET), PACKET,
                         "bucket-%d-%d", seed, i);
        name_lens[i] = n;
        slots[i] = i & 0xFF;
        // Mix the three trailer forms across the batch.
        caps[i] = (i % 3 == 0) ? -1 : 1000000000LL * (i + 1);
        lane_a[i] = (i % 3 == 2) ? 500000000LL * i : -1;
        lane_t[i] = (i % 3 == 2) ? 250000000LL * i : -1;
      }
      pt_encode_batch(added, taken, elapsed, names, name_lens, slots, caps,
                      lane_a, lane_t, BATCH, out, sizes);
      pt_send_fanout(tx, out, sizes, BATCH, PACKET, &loop_ip, &rx_port, 1);
    }
  };

  auto receiver = [&]() {
    uint8_t buf[BATCH * PACKET];
    int sizes[BATCH];
    uint32_t ips[BATCH];
    uint16_t ports[BATCH];
    int64_t stamps[BATCH];
    double added[BATCH], taken[BATCH];
    uint64_t elapsed[BATCH];
    uint8_t names[BATCH * PACKET];
    int name_lens[BATCH], slots[BATCH];
    int64_t caps[BATCH], lane_a[BATCH], lane_t[BATCH];
    uint64_t hashes[BATCH];
    int multi[BATCH];
    while (!stop.load()) {
      int n = pt_recv_batch(rx, buf, BATCH, PACKET, sizes, ips, ports, stamps, 50);
      if (n <= 0) continue;
      pt_decode_batch(buf, sizes, n, PACKET, added, taken, elapsed, names,
                      name_lens, slots, caps, lane_a, lane_t, hashes, multi);
      received.fetch_add(n);
    }
  };

  std::vector<std::thread> threads;
  threads.emplace_back(receiver);
  threads.emplace_back(receiver);
  threads.emplace_back(sender, 1);
  threads.emplace_back(sender, 2);
  for (int i = 2; i < 4; ++i) threads[i].join();
  // drain, then stop receivers
  std::this_thread::sleep_for(std::chrono::milliseconds(200));
  stop.store(true);
  threads[0].join();
  threads[1].join();
  pt_udp_close(tx);
  pt_udp_close(rx);
  printf("tsan driver ok: %ld packets received\n", received.load());
  return 0;
}
