// Raw wire-v2 (dv2) decode + fold on Hopper (sm_90a).
//
// Replaces patrol_tpu/ops/ingest.py::decode_fold_raw_pallas (pallas_call
// at :589; its core _device_decode + _decode_fold_core, :374-509). For
// each of P raw delta datagrams, staged as byte planes:
//   ok[p]          the all-or-nothing verdict of wire.decode_delta_packet:
//                  43 <= length <= ROW; 24 zero bytes, the reserved name
//                  "\x00pt!dv2" and its length byte; the byte-sum checksum
//                  of [32, end) & 0xFF equal to the byte at end = length-1;
//                  version 2; n_acks <= 32; off0 + 2 <= end; count <= E;
//                  the host's proposed entry offsets re-checked as a chain
//                  (first at off0 + 2, each next exactly off + 1 + name_len
//                  + 34, every entry inside the payload, the last ending
//                  exactly at end, or off0 + 2 == end when count == 0);
//                  no value with bit 63 set in a live entry;
//   fields[k,p,e]  slot, cap, added, taken, elapsed, big-endian;
//   entry_ok       ok && e < count && slot < N;  hosted_mask = entry_ok && hosted;
//   fold           every entry_ok && !hosted entry with row in [0, B):
//                  pn[row, slot] = max(pn, (added, taken)),
//                  elapsed[row]  = max(elapsed, max(elapsed_e, 0)).
// A lying plan (entry_off) can only reject a packet, never smuggle one in:
// the chain is fully determined by the bytes.
//
// What bounds it on this card. Bytes, in principle: a call reads each
// datagram once and the [P, E] plan, writes the [P, E] outputs and
// read-modify-writes 16 B per folded pair and 8 B per folded elapsed --
// about 10 MB, 3 us of HBM time, at the ring batch (P = 512 planes of
// 8 KiB). In practice latency: a datagram of 8 KiB is almost no work, so
// what a block costs is its chain of dependent steps, and at P = 1 that
// chain (behind the launch) is the whole time; at P = 512 every block
// fits in one wave, so the same chain sets the pace there too. The end of
// the chain is the fold: its 64-bit atomics go to scattered rows, one
// address at a time through the block's SM.
//
// Design: one block per datagram, one thread per entry ordinal (the
// block has max(256, E rounded to a warp) threads), and a chain of two
// global round trips (the length, then the datagram) and three barriers.
//  * Every load that does not depend on the datagram goes out first:
//    each thread loads its ordinal's plan (entry_off, rows, hosted) into
//    registers, and thread 0 loads lengths[p].
//  * Thread 0 arms an mbarrier and stages the datagram with one bulk
//    asynchronous copy (TMA, cp.async.bulk) of round_up_16(length) bytes
//    into shared memory; after barrier 1 (the mbarrier armed, the length
//    published) every thread waits on the mbarrier for the bytes. The
//    wrapper guarantees what the copy needs: a 16-byte-aligned plane base
//    and a row width that is a multiple of 16. The bytes past the length
//    that the round-up brings in never enter the checksum, the chain or a
//    field. A length outside [43, ROW] is rejected before any byte is
//    copied.
//  * Between barriers 1 and 2: every thread sums its share of the
//    checksum bytes [32, end) as 16-byte shared-memory vectors with a
//    SIMD byte sum (__dp4a; the ragged end masked), reduced per warp;
//    warp 0 checks the 32 envelope bytes, one a lane, with __all_sync;
//    every thread reads its proposed entry's name length and the header
//    fields it needs (n_acks, off0, count) itself, and publishes where its
//    entry ends.
//  * Between barriers 2 and 3: warp 0 adds the warp partials (one a
//    lane, __reduce_add_sync) and lane 0 checks the checksum and the
//    header; every thread checks its link of the chain and decodes its
//    34-byte tail from aligned 4-byte words (__funnelshift_r for the
//    misaligned start, __byte_perm for the big-endian swap), which also
//    gives the bit-63 guard. Barrier 3 is __syncthreads_and: the packet's
//    verdict.
//  * Only after that verdict does any thread fold: an entry must never be
//    folded before a later entry's guard has had its say. The fold is
//    64-bit atomicMax, exact on all of int64 and on duplicate keys across
//    packets (as in join.cu). Decoded fields of entries that are not live
//    are written as 0 (the contract leaves them unspecified).
//
// C interface (loaded with ctypes): device pointers of contiguous tensors
// -- pn/elapsed int64, planes uint8[P, ROW] (16-byte-aligned base, ROW a
// multiple of 16), lengths int32[P], entry_off and rows int32[P, E],
// hosted bool[P, E]; outputs ok bool[P], masks bool[2, P, E] (entry_ok,
// hosted_mask), fields int64[5, P, E]. `stream` is a cudaStream_t. Returns
// the cudaError_t of the launch (0 on success; cudaErrorInvalidValue for
// E > 1024 or a misaligned plane); P <= 0 launches nothing and returns 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinThreads = 256;
constexpr int kMaxThreads = 1024;  // one thread per entry ordinal: E <= 1024
constexpr int kBase = 32;   // envelope: 25-byte v1 header + 7-byte name
constexpr int kHead = 8;    // version u8 | sender_slot u16 | seq u32 | n_acks u8
constexpr int kAck = 4;
constexpr int kCount = 2;
constexpr int kTail = 34;   // slot u16 | cap u64 | added u64 | taken u64 | elapsed u64
constexpr int kMinLen = kBase + kHead + kCount + 1;  // 43
constexpr int kVersion = 2;
constexpr int kMaxAcks = 32;
constexpr int kSlack = 16;  // tail words may read a few bytes past `end`
// The envelope: 24 zero bytes, the name's length (7), then the reserved
// name "\x00pt!dv2", here little-endian (byte i of the name is bits 8i..).
constexpr unsigned long long kName = 0x0032766421747000ull;

__device__ __forceinline__ unsigned envelope_byte(int i) {
  return i < 24 ? 0u : (i == 24 ? 7u : (unsigned)(kName >> (8 * (i - 25))) & 0xFFu);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 8-byte big-endian value from two byte-stream words.
__device__ __forceinline__ long long be64(uint32_t hi, uint32_t lo) {
  return (long long)(((unsigned long long)__byte_perm(hi, 0, 0x0123) << 32) |
                     __byte_perm(lo, 0, 0x0123));
}

__global__ void __launch_bounds__(kMaxThreads)
decode_fold_kernel(long long* __restrict__ pn, long long* __restrict__ elapsed,
                   long long B, long long N,
                   const unsigned char* __restrict__ planes, long long row_bytes,
                   const int* __restrict__ lengths,
                   const int* __restrict__ entry_off,
                   const int* __restrict__ rows,
                   const bool* __restrict__ hosted, int E, long long PE,
                   bool* __restrict__ ok_out, bool* __restrict__ masks,
                   long long* __restrict__ fields) {
  extern __shared__ __align__(16) unsigned char smem[];  // the datagram
  __shared__ __align__(8) unsigned long long bar;
  __shared__ int nxt_s[kMaxThreads];  // where entry e ends; -1 outside
  __shared__ unsigned warp_sum[kMaxThreads / 32];
  __shared__ int s_len;

  const long long p = blockIdx.x;
  const long long pe0 = p * E;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool mine = tid < E;  // this thread's entry ordinal exists

  // 1. Every load that does not depend on the datagram goes out before
  // anything waits: the plan of this thread's ordinal, and the length.
  const int len0 = tid == 0 ? lengths[p] : 0;
  int eo = 0, row = -1;
  bool host = false;
  if (mine) {
    eo = entry_off[pe0 + tid];
    row = rows[pe0 + tid];
    host = hosted[pe0 + tid];
  }
  const uint32_t b = smem_addr(&bar);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int len = len0;
    s_len = len;
    // The length bounds reject before any byte is read.
    if (len >= kMinLen && (long long)len <= row_bytes) {
      const uint32_t nbytes = (uint32_t)((len + 15) & ~15);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(b), "r"(nbytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          ::"r"(smem_addr(smem)), "l"(planes + p * row_bytes), "r"(nbytes), "r"(b)
          : "memory");
    }
  }
  __syncthreads();  // barrier 1: the mbarrier is armed and the length known
  const int len = s_len;
  if (len >= kMinLen && (long long)len <= row_bytes) {
    // Every thread waits for the copy's bytes on the mbarrier (phase 0),
    // which makes the async proxy's writes visible to it.
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred q;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 q, [%1], 0;\n"
          "selp.u32 %0, 1, 0, q;\n}\n"
          : "=r"(done) : "r"(b) : "memory");
    }
  } else {
    if (tid == 0) ok_out[p] = false;
    if (mine) {
      masks[pe0 + tid] = false;
      masks[PE + pe0 + tid] = false;
#pragma unroll
      for (int k = 0; k < 5; ++k) fields[k * PE + pe0 + tid] = 0;
    }
    return;  // block-uniform
  }
  const int end = len - 1;  // the checksum byte

  // 2a. Checksum of [kBase, end): 16-byte vectors (kBase is a multiple of
  // 16, so only the vector holding `end` is ragged, and thread 0 masks
  // it), summed four bytes at a time with __dp4a.
  unsigned sum = 0;
  const uint4* v4 = reinterpret_cast<const uint4*>(smem);
  const int full = end / 16;  // vectors wholly before end
  for (int v = kBase / 16 + tid; v < full; v += blockDim.x) {
    const uint4 x = v4[v];
    sum = __dp4a(x.x, 0x01010101u, sum);
    sum = __dp4a(x.y, 0x01010101u, sum);
    sum = __dp4a(x.z, 0x01010101u, sum);
    sum = __dp4a(x.w, 0x01010101u, sum);
  }
  if (tid == 0 && full * 16 < end) {  // the ragged vector (end >= 42: full >= 2)
    const uint4 x = v4[full];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int left = end - (full * 16 + 4 * j);  // bytes of this word before end
      const uint32_t m = left >= 4 ? 0xFFFFFFFFu : (left <= 0 ? 0u : (1u << (8 * left)) - 1u);
      sum = __dp4a(w[j] & m, 0x01010101u, sum);
    }
  }
  sum = __reduce_add_sync(0xFFFFFFFFu, sum);
  if (lane == 0) warp_sum[tid >> 5] = sum;

  // The name length at this ordinal's proposed offset, read before the
  // header's verdict (an offset outside [0, end) reads nothing).
  const int nl = (mine && eo >= 0 && eo < end) ? smem[eo] : -1;

  // 2b. The header, read by every thread; warp 0 checks the envelope
  // bytes one a lane.
  bool good = true;
  if (tid < 32) good = __all_sync(0xFFFFFFFFu, smem[lane] == envelope_byte(lane)) != 0;
  const int n_acks = smem[kBase + 7];
  const int off0 = kBase + kHead + kAck * n_acks;
  bool hdr = smem[kBase] == kVersion && n_acks <= kMaxAcks && off0 + kCount <= end;
  int count = 0;
  if (hdr) {  // off0 + 2 <= end < len: the count bytes are staged
    count = (smem[off0] << 8) | smem[off0 + 1];
    hdr = count <= E && (count != 0 || off0 + kCount == end);
  }
  if (!hdr) count = 0;

  // 2c. Where this thread's entry ends; -1 for an offset outside the
  // payload, which rejects the packet below (and is never read through).
  const bool live = tid < count;
  int nx = -1;
  if (live) {
    nx = nl >= 0 ? eo + 1 + nl + kTail : -1;
    nxt_s[tid] = nx;
  }
  __syncthreads();  // barrier 2: warp partials and entry ends published

  if (tid < 32) {  // warp 0 adds the warp partials
    unsigned total = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0u;
    total = __reduce_add_sync(0xFFFFFFFFu, total);
    if (tid == 0) good &= hdr && (total & 0xFFu) == smem[end];
  }
  long long f[5] = {0, 0, 0, 0, 0};
  if (live) {
    const bool inside = nx >= 0 && nx <= end;
    good &= inside;
    good &= eo == (tid == 0 ? off0 + kCount : nxt_s[tid - 1]);
    if (tid == count - 1) good &= nx == end;
    if (inside) {
      // The tail is [t, t + 34): slot at t, then four u64 at t + 2 + 8i.
      // Nine aligned words from a = (t + 2) & ~3 cover the four values;
      // funnel shifts realign them, __byte_perm swaps them big-endian.
      const int t = nx - kTail;
      const int a = (t + 2) & ~3;
      const uint32_t sh = 8u * (uint32_t)((t + 2) & 3);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(smem + a);
      uint32_t u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) u[k] = __funnelshift_r(w[k], w[k + 1], sh);
      f[0] = (smem[t] << 8) | smem[t + 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) f[1 + k] = be64(u[2 * k], u[2 * k + 1]);
      // Bit 63 of a big-endian u64 is the top bit of its first byte.
      good &= (f[1] | f[2] | f[3] | f[4]) >= 0;
    }
  }
  const bool pkt_ok = __syncthreads_and(good) != 0;  // barrier 3: the verdict

  // 3. Only now, with the packet's verdict known, write and fold.
  if (tid == 0) ok_out[p] = pkt_ok;
  if (!mine) return;
  bool eok = false, hm = false;
  if (pkt_ok && live) {
    eok = f[0] < N;
    hm = eok && host;
    if (eok && !hm && row >= 0 && (long long)row < B) {
      long long* dst = pn + ((long long)row * N + f[0]) * 2;
      atomicMax(dst, f[2]);
      atomicMax(dst + 1, f[3]);
      atomicMax(elapsed + row, f[4] > 0 ? f[4] : 0LL);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 5; ++k) f[k] = 0;
  }
  masks[pe0 + tid] = eok;
  masks[PE + pe0 + tid] = hm;
#pragma unroll
  for (int k = 0; k < 5; ++k) fields[k * PE + pe0 + tid] = f[k];
}

}  // namespace

extern "C" int patrol_decode_fold(void* pn, void* elapsed, long long B, long long N,
                                  const void* planes, long long P, long long row_bytes,
                                  const void* lengths, const void* entry_off,
                                  const void* rows, const void* hosted, long long E,
                                  void* ok, void* masks, void* fields, void* stream) {
  if (P <= 0) return 0;
  // The bulk copy's contract: a 16-byte-aligned source and a size that is
  // a multiple of 16 (round_up_16(length) <= ROW needs ROW % 16 == 0).
  if (E < 1 || E > kMaxThreads || (uintptr_t)planes % 16 != 0 || row_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)row_bytes + kSlack;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        decode_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int threads = E > kMinThreads ? (int)((E + 31) / 32 * 32) : kMinThreads;
  decode_fold_kernel<<<(unsigned)P, threads, smem, (cudaStream_t)stream>>>(
      (long long*)pn, (long long*)elapsed, B, N, (const unsigned char*)planes,
      row_bytes, (const int*)lengths, (const int*)entry_off,
      (const int*)rows, (const bool*)hosted, (int)E, P * E, (bool*)ok,
      (bool*)masks, (long long*)fields);
  return (int)cudaGetLastError();
}
