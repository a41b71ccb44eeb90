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
// What bounds it on this card: bytes. A call reads each datagram's bytes
// once and the [P, E] plan, writes the [P, E] outputs, and read-modify-
// writes 16 B per folded pair and 8 B per folded elapsed; at the ring
// batch (P = 512 planes of 8 KiB) that is a few MB, so a few microseconds
// of HBM time, and at P = 1 a launch is bound by launch latency.
//
// Design. One block of 256 threads per packet. The block stages the
// datagram's [0, length) bytes into shared memory (16-byte loads when the
// rows are 16-byte aligned), so every later read -- header, name-length
// bytes, the 34-byte entry tails -- hits shared memory, and bytes past the
// length are never read as data. A block reduction gives the checksum;
// thread 0 checks the header. Then one thread per entry ordinal reads its
// proposed offset and name-length byte and publishes where its entry
// ends; after a barrier each thread checks its link of the chain and the
// bit-63 guards, and __syncthreads_and gives the packet's verdict. Only
// after that verdict does any thread fold: an entry must never be folded
// before a later entry's guard has had its say. The fold is 64-bit
// atomicMax, exact on all of int64 and on duplicate keys across packets
// (as in join.cu). Decoded fields of entries that are not live are
// written as 0 (the contract leaves them unspecified).
//
// C interface (loaded with ctypes): device pointers of contiguous tensors
// -- pn/elapsed int64, planes uint8[P, ROW], lengths int32[P], entry_off
// and rows int32[P, E], hosted bool[P, E]; outputs ok bool[P], masks
// bool[2, P, E] (entry_ok, hosted_mask), fields int64[5, P, E]. `stream`
// is a cudaStream_t. Returns the cudaError_t of the launch (0 on
// success); P <= 0 launches nothing and returns 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBase = 32;   // envelope: 25-byte v1 header + 7-byte name
constexpr int kHead = 8;    // version u8 | sender_slot u16 | seq u32 | n_acks u8
constexpr int kAck = 4;
constexpr int kCount = 2;
constexpr int kTail = 34;   // slot u16 | cap u64 | added u64 | taken u64 | elapsed u64
constexpr int kMinLen = kBase + kHead + kCount + 1;  // 43
constexpr int kVersion = 2;
constexpr int kMaxAcks = 32;
__constant__ unsigned char kName[7] = {0x00, 0x70, 0x74, 0x21, 0x64, 0x76, 0x32};

__device__ __forceinline__ long long be64(const unsigned char* s) {
  unsigned long long v = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) v = (v << 8) | s[k];
  return (long long)v;
}

// Rejected packet: verdict false, every entry dead, fields zero.
__device__ void write_rejected(long long p, long long pe0, int E, long long PE,
                               bool* ok_out, bool* masks, long long* fields) {
  if (threadIdx.x == 0) ok_out[p] = false;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    masks[pe0 + e] = false;
    masks[PE + pe0 + e] = false;
#pragma unroll
    for (int k = 0; k < 5; ++k) fields[k * PE + pe0 + e] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
decode_fold_kernel(long long* __restrict__ pn, long long* __restrict__ elapsed,
                   long long B, long long N,
                   const unsigned char* __restrict__ planes, long long row_bytes,
                   long long row_pad, int vec16,
                   const int* __restrict__ lengths,
                   const int* __restrict__ entry_off,
                   const int* __restrict__ rows,
                   const bool* __restrict__ hosted, int E, long long PE,
                   bool* __restrict__ ok_out, bool* __restrict__ masks,
                   long long* __restrict__ fields) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* nxt_s = reinterpret_cast<int*>(smem + row_pad);  // [E] end of entry e
  __shared__ int warp_sum[kThreads / 32];
  __shared__ int s_ok, s_count, s_off0;

  const long long p = blockIdx.x;
  const long long pe0 = p * E;
  const int tid = threadIdx.x;
  const int len = lengths[p];
  // The length bounds reject before any byte is read (block-uniform).
  if (len < kMinLen || (long long)len > row_bytes) {
    write_rejected(p, pe0, E, PE, ok_out, masks, fields);
    return;
  }
  const int end = len - 1;  // the checksum byte

  // Stage [0, len) into shared memory. With 16-byte loads the last vector
  // may carry a few stale bytes past len; nothing below reads them.
  const unsigned char* src = planes + p * row_bytes;
  if (vec16) {
    const int nv = (len + 15) / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < nv; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = tid; i < len; i += blockDim.x) smem[i] = src[i];
  }
  __syncthreads();

  // Checksum: sum of [kBase, end), a block reduction.
  int sum = 0;
  for (int i = kBase + tid; i < end; i += blockDim.x) sum += smem[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = sum;
  __syncthreads();

  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_sum[w];
    bool h = true;
    for (int i = 0; i < 24; ++i) h &= smem[i] == 0;
    h &= smem[24] == 7;
    for (int i = 0; i < 7; ++i) h &= smem[25 + i] == kName[i];
    h &= (total & 0xFF) == smem[end];
    h &= smem[kBase] == kVersion;
    const int n_acks = smem[kBase + 7];
    h &= n_acks <= kMaxAcks;
    const int off0 = kBase + kHead + kAck * n_acks;
    h &= off0 + kCount <= end;
    int count = 0;
    if (h) {  // off0 + 2 <= end < len: the count bytes are staged
      count = (smem[off0] << 8) | smem[off0 + 1];
      h &= count <= E;
      if (count == 0) h &= off0 + kCount == end;
    }
    s_ok = h;
    s_count = h ? count : 0;
    s_off0 = off0;
  }
  __syncthreads();
  if (!s_ok) {
    write_rejected(p, pe0, E, PE, ok_out, masks, fields);
    return;
  }
  const int count = s_count;
  const int off0 = s_off0;

  // Where each proposed entry ends; -1 for an offset outside the payload,
  // which rejects the packet below (and is never read through).
  for (int e = tid; e < count; e += blockDim.x) {
    const int eo = entry_off[pe0 + e];
    nxt_s[e] = (eo >= 0 && eo < end) ? eo + 1 + smem[eo] + kTail : -1;
  }
  __syncthreads();

  bool good = true;
  for (int e = tid; e < count; e += blockDim.x) {
    const int eo = entry_off[pe0 + e];
    const int nx = nxt_s[e];
    const bool inside = nx >= 0 && nx <= end;
    good &= inside;
    good &= eo == (e == 0 ? off0 + kCount : nxt_s[e - 1]);
    if (e == count - 1) good &= nx == end;
    if (inside) {
      // Bit 63 of a big-endian u64 is the top bit of its first byte.
      const unsigned char* t = smem + nx - kTail;
      good &= ((t[2] | t[10] | t[18] | t[26]) & 0x80) == 0;
    }
  }
  const bool pkt_ok = __syncthreads_and(good) != 0;

  // Only now, with the packet's verdict known, write and fold.
  if (tid == 0) ok_out[p] = pkt_ok;
  for (int e = tid; e < E; e += blockDim.x) {
    long long f[5] = {0, 0, 0, 0, 0};
    bool eok = false, hm = false;
    if (pkt_ok && e < count) {
      const unsigned char* t = smem + nxt_s[e] - kTail;
      f[0] = (t[0] << 8) | t[1];
      f[1] = be64(t + 2);
      f[2] = be64(t + 10);
      f[3] = be64(t + 18);
      f[4] = be64(t + 26);
      eok = f[0] < N;
      hm = eok && hosted[pe0 + e];
      if (eok && !hm) {
        const long long r = rows[pe0 + e];
        if (r >= 0 && r < B) {
          long long* dst = pn + (r * N + f[0]) * 2;
          atomicMax(dst, f[2]);
          atomicMax(dst + 1, f[3]);
          atomicMax(elapsed + r, f[4] > 0 ? f[4] : 0LL);
        }
      }
    }
    masks[pe0 + e] = eok;
    masks[PE + pe0 + e] = hm;
#pragma unroll
    for (int k = 0; k < 5; ++k) fields[k * PE + pe0 + e] = f[k];
  }
}

}  // namespace

extern "C" int patrol_decode_fold(void* pn, void* elapsed, long long B, long long N,
                                  const void* planes, long long P, long long row_bytes,
                                  const void* lengths, const void* entry_off,
                                  const void* rows, const void* hosted, long long E,
                                  void* ok, void* masks, void* fields, void* stream) {
  if (P <= 0) return 0;
  const long long row_pad = (row_bytes + 15) / 16 * 16;
  const size_t smem = (size_t)row_pad + 4 * (size_t)E;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        decode_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int vec16 = ((uintptr_t)planes % 16 == 0) && (row_bytes % 16 == 0);
  decode_fold_kernel<<<(unsigned)P, kThreads, smem, (cudaStream_t)stream>>>(
      (long long*)pn, (long long*)elapsed, B, N, (const unsigned char*)planes,
      row_bytes, row_pad, vec16, (const int*)lengths, (const int*)entry_off,
      (const int*)rows, (const bool*)hosted, (int)E, P * E, (bool*)ok,
      (bool*)masks, (long long*)fields);
  return (int)cudaGetLastError();
}
