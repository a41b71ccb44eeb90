// Lifecycle probe on Hopper (sm_90a): the IsZero verdict of the idle-bucket
// sweep.
//
// Replaces patrol_tpu/ops/lifecycle.py::lifecycle_probe (:69). That
// function is plain XLA in the reference, not Pallas; every sweep of the
// lifecycle layer (on by default on the serving path) runs it over up to
// GC_SWEEP_MAX = 8192 candidate rows, so the port writes it by hand. In:
// the state (pn int64[B, N, 2], elapsed int64[B], only read) and K
// candidates, five int64[K] columns (rows, now_ns, per_ns, cap_base_nt,
// created_ns). Out, in ONE buffer so the sweep reads it back with one copy:
// own_added int64[K], own_taken int64[K], elapsed int64[K], then full as
// one byte per candidate (25 bytes a candidate).
//
// What bounds it on this card. Bytes: each candidate's N x 16 B lane plane
// and its elapsed counter once, the 40 B of its probe and the 25 B of its
// verdict -- about 9.0 MB, 2.7 us of HBM time, at K = 8192 x 64 lanes. The
// launch itself costs about as much (2.2-2.8 us for a launch that does
// little on this card), so the design aims only at not adding to it: every
// load of a row in flight at once, no shared memory, no barrier.
//
// Design: take-n's read half (take.cu). One warp per candidate, 8 per
// block (K = 8192 gives 1024 blocks).
//  * Lane r < 5 loads probe field r; the warp reads each by shuffle.
//  * Lane l loads lane pairs n = l, l + 32, ... as 16-byte vectors, a pass
//    of kPass loads in flight before any is used; lane 0 loads elapsed
//    beside them. N need not be a multiple of 32: lanes past N add 0.
//  * The warp sums added and taken with a __shfl_xor_sync tree of wrapping
//    int64 adds; any order of a sum mod 2^64 is the same value, so the sums
//    equal the reference's bit for bit. The own lane comes from the lane
//    that loaded node_slot, broadcast by shuffle.
//  * Lane 0 does the scalar work: freq = cap_base // 1e9, interval =
//    per // safe_freq (floor divisions, floordiv64), the float64 grant
//    with the explicit round-to-nearest intrinsics (so nvcc contracts
//    nothing into an FMA), the clip to [0, 2^62], floor, the conversion,
//    and the verdict grant >= cap_base - tokens. This is take.cu's grant to
//    the bit; the one difference is the capacity, which the probe takes
//    from cap_base_nt (the row's pinned base) and not from a rate's freq.
//
// Hazards, and what the design does about each:
//  * Padding candidates carry cap_base_nt == 0: their verdict is false,
//    but, as in the reference, their own lane and elapsed are still the
//    gathered values (the engine pads with row 0 and reads only the live
//    prefix). The probe writes no state, so padding aliasing a live row is
//    harmless.
//  * Index semantics. Rows are cast to int32 as the reference's int32 rows
//    are; a row in [-B, 0) wraps by B, and the gather clamps to [0, B).
//  * int64 wrap. tokens, last, delta and missing use wrapping adds, as XLA
//    does; the reference's sums wrap too.
//
// C interface (ctypes): device pointers of contiguous tensors; the function
// returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kNano = 1000000000LL;
constexpr int kRowsPerBlock = 8;  // candidates (warps) per block
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kPass = 2;  // lane-pair loads a lane has in flight
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ long long wmul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

__device__ __forceinline__ long long floordiv64(long long a, long long b) {
  // b != 0 at every call site; b == -1 is (wrapping) negation.
  if (b == -1) return wsub(0, a);
  const long long q = a / b;
  const long long r = wsub(a, wmul(q, b));
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void __launch_bounds__(kThreads)
lifecycle_probe_kernel(const long long* __restrict__ pn,
                       const long long* __restrict__ elapsed, long long B,
                       long long N, long long node_slot,
                       const long long* __restrict__ rows,
                       const long long* __restrict__ now_ns,
                       const long long* __restrict__ per_ns,
                       const long long* __restrict__ cap_base_nt,
                       const long long* __restrict__ created_ns,
                       unsigned char* __restrict__ out, long long K) {
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (k >= K) return;  // warp-uniform

  // The candidate's probe: lane r < 5 loads field r.
  long long mine = 0;
  if (lane == 0) mine = rows[k];
  else if (lane == 1) mine = now_ns[k];
  else if (lane == 2) mine = per_ns[k];
  else if (lane == 3) mine = cap_base_nt[k];
  else if (lane == 4) mine = created_ns[k];
  long long row = (long long)(int)__shfl_sync(kAll, mine, 0);  // int32 rows
  if (row < 0) row += B;                                      // numpy wrap
  row = row < 0 ? 0 : (row >= B ? B - 1 : row);               // gather clamp

  // Every load of the row goes out before any is used.
  const longlong2* lanes = reinterpret_cast<const longlong2*>(pn + row * N * 2);
  const long long el = lane == 0 ? elapsed[row] : 0;
  unsigned long long sa = 0, st = 0;
  long long own_a = 0, own_t = 0;
  for (long long base = lane; base < N; base += 32 * kPass) {
    longlong2 v[kPass];
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      const long long n = base + 32 * j;
      v[j] = n < N ? lanes[n] : make_longlong2(0, 0);
    }
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      sa += (unsigned long long)v[j].x;
      st += (unsigned long long)v[j].y;
      if (base + 32 * j == node_slot) {
        own_a = v[j].x;
        own_t = v[j].y;
      }
    }
  }

  // The probe's fields, and the work that does not need the row, while
  // its loads are in flight.
  const long long now = __shfl_sync(kAll, mine, 1);
  const long long per = __shfl_sync(kAll, mine, 2);
  const long long cap = __shfl_sync(kAll, mine, 3);
  const long long created = __shfl_sync(kAll, mine, 4);
  const long long freq = floordiv64(cap, kNano);
  const long long safe_freq = freq == 0 ? 1 : freq;
  const long long interval = floordiv64(per, safe_freq);
  const bool rate_zero = (freq == 0) || (per == 0) || (interval == 0);
  const long long safe_interval = interval == 0 ? 1 : interval;

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sa += __shfl_xor_sync(kAll, sa, o);
    st += __shfl_xor_sync(kAll, st, o);
  }
  const int own_src = (int)(node_slot & 31);
  own_a = __shfl_sync(kAll, own_a, own_src);
  own_t = __shfl_sync(kAll, own_t, own_src);
  if (lane != 0) return;  // the scalar work: lane 0

  const long long tokens = wsub(wadd(cap, (long long)sa), (long long)st);
  const long long c_el = wadd(created, el);
  const long long last = c_el < now ? c_el : now;
  const long long delta = wsub(now, last);
  const double grant_tokens =
      __ddiv_rn(__ll2double_rn(delta), __ll2double_rn(safe_interval));
  double grant_f = rate_zero ? 0.0 : __dmul_rn(grant_tokens, 1e9);
  grant_f = fmax(grant_f, 0.0);
  grant_f = fmin(grant_f, 4611686018427387904.0);  // 2^62
  const long long grant = __double2ll_rz(floor(grant_f));
  const long long missing = wsub(cap, tokens);
  const bool full = cap > 0 && grant >= missing;

  long long* o64 = reinterpret_cast<long long*>(out);
  o64[k] = own_a;
  o64[K + k] = own_t;
  o64[2 * K + k] = el;
  out[24 * K + k] = full ? 1 : 0;
}

}  // namespace

extern "C" int patrol_lifecycle_probe(const void* pn, const void* elapsed,
                                      long long B, long long N,
                                      long long node_slot, const void* rows,
                                      const void* now_ns, const void* per_ns,
                                      const void* cap_base_nt,
                                      const void* created_ns, void* out,
                                      long long K, void* stream) {
  if (K <= 0) return 0;
  const unsigned blocks = (unsigned)((K + kRowsPerBlock - 1) / kRowsPerBlock);
  lifecycle_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)pn, (const long long*)elapsed, B, N, node_slot,
      (const long long*)rows, (const long long*)now_ns,
      (const long long*)per_ns, (const long long*)cap_base_nt,
      (const long long*)created_ns, (unsigned char*)out, K);
  return (int)cudaGetLastError();
}
