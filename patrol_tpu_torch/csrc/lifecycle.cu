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
// verdict -- about 9.0 MB, 2.7 us of HBM time, at K = 8192 x 64 lanes. A
// launch that does little costs 2.2-2.8 us back to back on this card, and
// each candidate is a chain of two dependent memory trips (its row, then
// the row's lanes) and a scalar tail of int64 and fp64 divisions before
// its verdict is stored. So the design keeps every candidate's chain in
// flight at once and moves the tail off it.
//
// Design: 32 candidates a block, 256 threads. Thread t < 32 is candidate
// t's own thread; the 8 threads 8c .. 8c + 7 are candidate c's lane group.
//  * One wave. K = 8192 gives 256 blocks of 256 threads at 64 registers a
//    thread (-Xptxas -v): four blocks fit an SM, so all 256 are resident
//    at once and no candidate's chain waits for another wave (the first
//    design ran 1,024 blocks of 256 threads, more than the card held).
//  * Coalesced probe fields. Candidate t's own thread loads its five
//    fields, so each column is read as the block's 32 contiguous values.
//    A lane group loads its candidate's row itself (one broadcast load in
//    the same trip), so the group needs no barrier before its lanes.
//  * Lane planes by lane groups. Lane l of a group loads lane pairs
//    l, l + 8, ... as 16-byte vectors, a pass of 8 loads in flight before
//    any is used: a plane of 64 lanes is one pass, every plane of the
//    block in flight at once. The loads are marked streaming (__ldcs,
//    evict first): a sweep reads each plane once, and so its 8 MB leaves
//    the rest of L2 in place. A sweep's rows are idle, so past L2: there
//    this is 0.5-0.9 us a call faster than plain loads, which win only
//    when the same rows are probed again while in L2 (PERF.md). The own
//    thread loads elapsed[row] in the same trip.
//  * Work off the chain while the lanes fly: after its group's loads are
//    out, the own thread computes freq, interval, rate_zero and the whole
//    fp64 grant (which needs elapsed, not the lanes), so after the planes
//    land only the sums and one compare are left.
//  * Sums by shuffle. A group sums added and taken with wrapping int64
//    adds and a 3-step __shfl_xor_sync tree; any order of a sum mod 2^64
//    is the same value, so the sums equal the reference's bit for bit. The
//    group's first lane puts them in shared memory, and the lane that
//    loaded node_slot its own lane; one barrier hands them to the own
//    threads.
//  * The scalar tail one candidate a thread: 32 tails run in one warp's
//    instructions (the first design ran one a warp, on lane 0).
//  * Coalesced stores: each output column is written as the block's 32
//    contiguous values.
// Tried and not kept: each plane moved into shared memory by one TMA bulk
// copy (cp.async.bulk on an mbarrier counting bytes) and summed there,
// slower at every K (PERF.md); and groups of 4 and 16 lanes, 16 and 64
// candidates a block, 16 loads in flight a lane, and L2::256B-hinted
// loads, none of them faster than this design both warm and cold at
// K = 8192.
//
// Hazards, and what the design does about each:
//  * The verdict must equal take-n's grant to the last nanotoken (take.cu):
//    the same floor divisions (floordiv64), the round-to-nearest intrinsics
//    (__ll2double_rn, __ddiv_rn, __dmul_rn, so nvcc contracts nothing into
//    an FMA), the clip to [0, 2^62], floor and __double2ll_rz. The one
//    difference is the capacity, which the probe takes from cap_base_nt
//    (the row's pinned base) and not from a rate's freq.
//  * Padding candidates carry cap_base_nt == 0: their verdict is false,
//    but, as in the reference, their own lane and elapsed are still the
//    gathered values (the engine pads with row 0 and reads only the live
//    prefix). The probe writes no state, so padding aliasing a live row is
//    harmless.
//  * Index semantics. Rows are cast to int32 as the reference's int32 rows
//    are; a row in [-B, 0) wraps by B, and the gather clamps to [0, B).
//    The own thread and the lane group compute the same row.
//  * int64 wrap. tokens, last, delta and missing use wrapping adds, as XLA
//    does; the reference's sums wrap too.
//  * Any N >= 1: a group's lanes past N load nothing and add 0, and a
//    plane of more than 64 lanes takes more passes. Shared memory is
//    1,024 B a block whatever N is.
//
// C interface (ctypes): device pointers of contiguous tensors; the function
// returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kNano = 1000000000LL;
constexpr int kCandidates = 32;  // a block's candidates
constexpr int kGroup = 8;        // a candidate's lane group
constexpr int kThreads = kCandidates * kGroup;
constexpr int kPass = 8;         // lane-pair loads a lane has in flight
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

// The gathered row: int32 rows as the reference's, the numpy wrap of
// [-B, 0), the gather's clamp to [0, B).
__device__ __forceinline__ long long gather_row(long long row, long long B) {
  row = (long long)(int)row;
  if (row < 0) row += B;
  return row < 0 ? 0 : (row >= B ? B - 1 : row);
}

__global__ void __launch_bounds__(kThreads)
lifecycle_probe_kernel(const long long* __restrict__ pn,
                       const long long* __restrict__ elapsed, long long B,
                       int N, int node_slot, const long long* __restrict__ rows,
                       const long long* __restrict__ now_ns,
                       const long long* __restrict__ per_ns,
                       const long long* __restrict__ cap_base_nt,
                       const long long* __restrict__ created_ns,
                       unsigned char* __restrict__ out, long long K) {
  __shared__ unsigned long long s_sum[2][kCandidates];
  __shared__ long long s_own[2][kCandidates];

  const int t = threadIdx.x;
  const long long k0 = (long long)blockIdx.x * kCandidates;
  const int live = (int)(K - k0 < kCandidates ? K - k0 : kCandidates);
  const bool own = t < live;  // candidate t's own thread
  const long long k = k0 + t;
  const int c = t / kGroup;   // this thread's lane group's candidate
  const int l = t % kGroup;

  // The probe, coalesced: the own thread loads its candidate's five
  // fields; a lane group loads its candidate's row in the same trip.
  long long now = 0, per = 0, cap = 0, created = 0, el = 0;
  if (own) {
    now = now_ns[k];
    per = per_ns[k];
    cap = cap_base_nt[k];
    created = created_ns[k];
    el = elapsed[gather_row(rows[k], B)];
  }
  const int n_end = c < live ? N : 0;
  const longlong2* lanes = reinterpret_cast<const longlong2*>(
      pn + (c < live ? gather_row(rows[k0 + c], B) : 0) * N * 2);

  // The group's first pass of lane loads goes out, then the own thread's
  // scalar work runs while they (and elapsed) are in flight.
  longlong2 v[kPass];
#pragma unroll
  for (int j = 0; j < kPass; ++j) {
    const int n = l + kGroup * j;
    v[j] = n < n_end ? __ldcs(lanes + n) : make_longlong2(0, 0);
  }
  long long grant = 0;
  if (own) {
    const long long freq = floordiv64(cap, kNano);
    const long long safe_freq = freq == 0 ? 1 : freq;
    const long long interval = floordiv64(per, safe_freq);
    const bool rate_zero = (freq == 0) || (per == 0) || (interval == 0);
    const long long safe_interval = interval == 0 ? 1 : interval;
    const long long c_el = wadd(created, el);
    const long long last = c_el < now ? c_el : now;
    const long long delta = wsub(now, last);
    const double grant_tokens =
        __ddiv_rn(__ll2double_rn(delta), __ll2double_rn(safe_interval));
    double grant_f = rate_zero ? 0.0 : __dmul_rn(grant_tokens, 1e9);
    grant_f = fmax(grant_f, 0.0);
    grant_f = fmin(grant_f, 4611686018427387904.0);  // 2^62
    grant = __double2ll_rz(floor(grant_f));
  }

  unsigned long long sa = 0, st = 0;
  long long own_a = 0, own_t = 0;
  for (int base = l;; base += kGroup * kPass) {
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      sa += (unsigned long long)v[j].x;
      st += (unsigned long long)v[j].y;
      if (base + kGroup * j == node_slot) {
        own_a = v[j].x;
        own_t = v[j].y;
      }
    }
    const int next = base + kGroup * kPass;
    if (next >= n_end) break;
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      const int n = next + kGroup * j;
      v[j] = n < n_end ? __ldcs(lanes + n) : make_longlong2(0, 0);
    }
  }
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    sa += __shfl_xor_sync(kAll, sa, o);
    st += __shfl_xor_sync(kAll, st, o);
  }
  if (c < live) {
    if (l == 0) {
      s_sum[0][c] = sa;
      s_sum[1][c] = st;
    }
    if (l == node_slot % kGroup) {
      s_own[0][c] = own_a;
      s_own[1][c] = own_t;
    }
  }
  __syncthreads();
  if (!own) return;

  const long long tokens =
      wsub(wadd(cap, (long long)s_sum[0][t]), (long long)s_sum[1][t]);
  const long long missing = wsub(cap, tokens);
  const bool full = cap > 0 && grant >= missing;

  long long* o64 = reinterpret_cast<long long*>(out);
  o64[k] = s_own[0][t];
  o64[K + k] = s_own[1][t];
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
  const unsigned blocks = (unsigned)((K + kCandidates - 1) / kCandidates);
  lifecycle_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)pn, (const long long*)elapsed, B, (int)N, (int)node_slot,
      (const long long*)rows, (const long long*)now_ns,
      (const long long*)per_ns, (const long long*)cap_base_nt,
      (const long long*)created_ns, (unsigned char*)out, K);
  return (int)cudaGetLastError();
}
