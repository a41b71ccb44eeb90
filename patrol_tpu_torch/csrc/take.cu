// Take-n on Hopper (sm_90a): one engine take tick.
//
// Replaces patrol_tpu/ops/take.py::take_n_batch (its body is take_batch,
// take.py:176-253). That function is plain XLA in the reference, not
// Pallas, but every take of the serving path goes through it, so the port
// writes it by hand. In: the packed int64[8, K] request matrix
// (rows, now_ns, freq, per_ns, count_nt, nreq, cap_base_nt, created_ns).
// Out: the int64[7, K] result matrix (have, admitted, own_added,
// own_taken, elapsed, sum_added, sum_taken), and the committed own lane
// and elapsed counter of every admitting row.
//
// One thread per packed column does the whole step in one launch: gather
// the N lanes and sum them, refill in fp64, cap at capacity, admit
// greedily (k = clip(have // count, 0, nreq)), apply the forfeit clamp,
// write the seven result values, and commit the own lane and elapsed.
//
// What bounds it on this card: each live column gathers its N x 2 lane
// plane (1 KiB at N = 64) serially from one thread, so a warp's loads
// land 1 KiB apart and a 4096-column tick fills only 32 blocks of 128
// threads on 132 SMs: at the engine's K it is gather-latency bound, not
// bandwidth bound. The gather uses 16-byte loads and the arithmetic stays
// in registers.
//
// Hazards, and what the design does about each:
//  * Padding columns. The engine zeroes the request matrix, so padding
//    columns are (row 0, nreq 0), and row 0 may be live in the same tick.
//    The reference relies on scatter-ADD of zero deltas; a thread that
//    read row 0 while the live thread commits it would race. Here a
//    column with nreq <= 0 reads no state and writes zeros to its result
//    column (the engine reads only its live columns), and a column that
//    admits nothing writes no state, which is exact because all its
//    deltas are 0. Live rows are unique per tick (the engine's
//    _group_tickets), so no thread reads or writes a row that another
//    thread commits. Precondition of the interface: no committing row is
//    read by another column.
//  * Floor division. The reference floors int64 quotients
//    (per_ns // safe_freq, have // safe_count) and `have` can be negative
//    after merges; C's `/` truncates. Every quotient goes through
//    floordiv64.
//  * fp64 refill. floor(clip(delta / interval * 1e9, 0, 2^62)) must match
//    XLA on the CPU bit for bit: the conversions and the division and
//    product use the explicit round-to-nearest intrinsics, so nothing is
//    contracted or reassociated.
//  * Index semantics. Rows arrive as int64 and are cast to int32 as the
//    reference does; a negative row wraps by B (numpy indexing), the
//    gather clamps into [0, B) and the commit drops rows outside it --
//    the reference's gather and scatter defaults.
//  * Read before write. A committing thread reads its whole row before
//    it writes its own lane, so the sums and the result see the pre-tick
//    state, as in the reference.
//
// C interface (ctypes): device pointers of contiguous int64 tensors; the
// function returns the cudaError_t of its launches (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kNano = 1000000000LL;
constexpr int kThreads = 128;

__device__ __forceinline__ long long floordiv64(long long a, long long b) {
  // b != 0 at every call site. b == -1 is negation (wrapping), which also
  // keeps LLONG_MIN / -1 defined.
  if (b == -1) return (long long)(0ULL - (unsigned long long)a);
  long long q = a / b;
  const long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) q -= 1;
  return q;
}

// Wrapping int64 arithmetic, as XLA's.
__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ long long wmul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

__device__ __forceinline__ long long row_index(long long packed_row, long long B,
                                               bool* in_range) {
  long long r = (long long)(int)packed_row;  // packed[0].astype(int32)
  if (r < 0) r += B;                          // numpy-style wrap
  *in_range = (r >= 0 && r < B);
  return r < 0 ? 0 : (r >= B ? B - 1 : r);    // gather clamps
}

__global__ void take_n_kernel(long long* __restrict__ pn,
                              long long* __restrict__ elapsed,
                              long long B, long long N, long long node_slot,
                              const long long* __restrict__ packed,
                              long long* __restrict__ out, long long K) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const long long nreq = packed[5 * K + k];
  if (nreq <= 0) {
    // A column that requests nothing (the engine's padding): it reads no
    // state and writes zeros, so it cannot race the row it aliases.
    for (int r = 0; r < 7; ++r) out[r * K + k] = 0;
    return;
  }
  bool in_range;
  const long long row = row_index(packed[k], B, &in_range);
  const long long now = packed[1 * K + k];
  const long long freq = packed[2 * K + k];
  const long long per = packed[3 * K + k];
  const long long count = packed[4 * K + k];
  const long long cap_base = packed[6 * K + k];
  const long long created = packed[7 * K + k];

  // Gather and sum the row's lanes, 16 bytes (one lane's pair) a load.
  long long* own_lane = pn + (row * N + node_slot) * 2;
  const longlong2* lanes = reinterpret_cast<const longlong2*>(pn + row * N * 2);
  long long sum_added = 0, sum_taken = 0;
  for (long long n = 0; n < N; ++n) {
    const longlong2 v = lanes[n];
    sum_added = wadd(sum_added, v.x);
    sum_taken = wadd(sum_taken, v.y);
  }
  const longlong2 own = lanes[node_slot];
  const long long el = elapsed[row];

  const long long cap_now = wmul(freq, kNano);
  const long long tokens = wsub(wadd(cap_base, sum_added), sum_taken);
  const long long c_el = wadd(created, el);
  const long long last = c_el < now ? c_el : now;
  const long long delta = wsub(now, last);

  const long long safe_freq = freq == 0 ? 1 : freq;
  const long long interval = floordiv64(per, safe_freq);
  const bool rate_zero = (freq == 0) || (per == 0) || (interval == 0);
  const long long safe_interval = interval == 0 ? 1 : interval;
  const double grant_tokens =
      __ddiv_rn(__ll2double_rn(delta), __ll2double_rn(safe_interval));
  double grant_f = rate_zero ? 0.0 : __dmul_rn(grant_tokens, 1e9);
  grant_f = fmax(grant_f, 0.0);
  grant_f = fmin(grant_f, 4611686018427387904.0);  // 2^62
  long long grant = __double2ll_rz(floor(grant_f));
  const long long missing = wsub(cap_now, tokens);
  if (missing < grant) grant = missing;

  const long long have = wadd(tokens, grant);
  const long long safe_count = count <= 0 ? 1 : count;
  long long adm = floordiv64(have, safe_count);
  if (adm < 0) adm = 0;
  if (adm > nreq) adm = nreq;
  if (count <= 0) adm = 0;
  const bool success = adm >= 1;

  long long d_added = 0, d_taken = 0, d_elapsed = 0;
  if (success) {
    const long long forfeit = grant < 0 ? wsub(0, grant) : 0;
    d_added = grant > 0 ? grant : 0;
    d_taken = wadd(wmul(adm, count), forfeit);
    d_elapsed = delta;
  }
  const long long own_added = wadd(own.x, d_added);
  const long long own_taken = wadd(own.y, d_taken);
  const long long new_el = wadd(el, d_elapsed);
  out[0 * K + k] = have;
  out[1 * K + k] = adm;
  out[2 * K + k] = own_added;
  out[3 * K + k] = own_taken;
  out[4 * K + k] = new_el;
  out[5 * K + k] = wadd(sum_added, d_added);
  out[6 * K + k] = wadd(sum_taken, d_taken);
  // Commit only on admission (every delta is 0 otherwise); the
  // reference's scatter drops rows outside [0, B).
  if (success && in_range) {
    own_lane[0] = own_added;
    own_lane[1] = own_taken;
    elapsed[row] = new_el;
  }
}

}  // namespace

extern "C" int patrol_take_n(void* pn, void* elapsed, long long B, long long N,
                             long long node_slot, const void* packed, void* out,
                             long long K, void* stream) {
  if (K <= 0) return 0;
  const unsigned blocks = (unsigned)((K + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  take_n_kernel<<<blocks, kThreads, 0, s>>>(
      (long long*)pn, (long long*)elapsed, B, N, node_slot,
      (const long long*)packed, (long long*)out, K);
  return (int)cudaGetLastError();
}
