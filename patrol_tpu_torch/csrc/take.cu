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
// What bounds it on this card. Bytes, in principle: the packed matrix and
// the result once, each live row's N x 16 B lane plane and elapsed once,
// and 24 B written per admitting row -- about 4.2 MB, 1.26 us of HBM
// time, at K = 4096 x 64 lanes. In practice latency: a column is a chain
// of its request, its row's lanes, the refill arithmetic and the stores.
// A design with one thread per column walks its 1 KiB lane plane in a
// serial loop, with a warp's loads 1 KiB apart, and fills 32 blocks on
// 132 SMs; its time is 64 dependent loads.
//
// Design: one warp per column, 8 columns per block (K = 4096 gives 512
// blocks, about 4 on each SM), no shared memory and no barrier: warps
// never wait for each other.
//  * Lane r < 8 loads packed[r, k]; the warp reads each field by shuffle.
//    A column with nreq <= 0 stops there.
//  * Lane l loads lane pairs n = l, l + 32, ... as 16-byte vectors, all
//    of a pass in flight before any is used, so each load instruction of
//    the warp reads 512 contiguous bytes and a row of 64 lanes is two
//    loads deep; lane 0 loads elapsed[row] beside them. N need not be a
//    multiple of 32: lanes past N load nothing and add 0.
//  * The warp sums added and taken with a __shfl_xor_sync tree on int64
//    with wrapping adds. Addition mod 2^64 is associative and
//    commutative, so any order of the sum is bit-identical to the
//    reference's. The own lane comes from the lane that loaded
//    node_slot, broadcast by shuffle.
//  * Lane 0 does the scalar work after the reduction (which orders every
//    lane's reads before it): floor divisions, the fp64 refill,
//    admission, the forfeit clamp, the seven results and the commit.
//
// Hazards, and what the design does about each:
//  * Padding columns. The engine zeroes the request matrix, so padding
//    columns are (row 0, nreq 0), and row 0 may be live in the same tick.
//    The reference relies on scatter-ADD of zero deltas; a warp that
//    read row 0 while the live warp commits it would race. Here a
//    column with nreq <= 0 reads no state and writes zeros to its result
//    column (the engine reads only its live columns), and a column that
//    admits nothing writes no state, which is exact because all its
//    deltas are 0. Live rows are unique per tick (the engine's
//    _group_tickets), so no warp reads or writes a row that another
//    warp commits. Precondition of the interface: no committing row is
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
//  * Read before write. The commit's lane-0 store comes after the shuffle
//    reduction, which every lane joins only with its loads done, so the
//    sums and the result see the pre-tick state, as in the reference.
//
// C interface (ctypes): device pointers of contiguous int64 tensors; the
// function returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kNano = 1000000000LL;
constexpr int kCols = 8;            // columns (warps) per block
constexpr int kThreads = 32 * kCols;
constexpr int kPass = 2;            // lane-pair loads a lane has in flight
constexpr int kPackRows = 8;
constexpr int kOutRows = 7;
constexpr unsigned kAll = 0xFFFFFFFFu;

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

__device__ __forceinline__ long long floordiv64(long long a, long long b) {
  // b != 0 at every call site. b == -1 is negation (wrapping), which also
  // keeps LLONG_MIN / -1 defined. One division; the remainder by product.
  if (b == -1) return wsub(0, a);
  const long long q = a / b;
  const long long r = wsub(a, wmul(q, b));
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ long long row_index(long long packed_row, long long B,
                                               bool* in_range) {
  long long r = (long long)(int)packed_row;  // packed[0].astype(int32)
  if (r < 0) r += B;                          // numpy-style wrap
  *in_range = (r >= 0 && r < B);
  return r < 0 ? 0 : (r >= B ? B - 1 : r);    // gather clamps
}

__global__ void __launch_bounds__(kThreads)
take_n_kernel(long long* __restrict__ pn, long long* __restrict__ elapsed,
              long long B, long long N, long long node_slot,
              const long long* __restrict__ packed,
              long long* __restrict__ out, long long K) {
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kCols + (threadIdx.x >> 5);
  if (k >= K) return;  // warp-uniform

  // The column's request: lane r < 8 loads packed[r, k]; the warp reads
  // each field by shuffle.
  const long long mine = lane < kPackRows ? packed[lane * K + k] : 0;
  const long long nreq = __shfl_sync(kAll, mine, 5);
  if (nreq <= 0) {
    // A column that requests nothing (the engine's padding) reads no
    // state and gets zeros, so it cannot race the row it aliases.
    if (lane < kOutRows) out[lane * K + k] = 0;
    return;
  }
  bool in_range;
  const long long row = row_index(__shfl_sync(kAll, mine, 0), B, &in_range);

  // Every load of the row goes out before any is used: lane l takes lane
  // pairs n = l, l + 32, ... in passes of kPass loads, and lane 0 the
  // row's elapsed counter.
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

  // The request's fields, and the work that does not need the row,
  // while its loads are in flight.
  const long long now = __shfl_sync(kAll, mine, 1);
  const long long freq = __shfl_sync(kAll, mine, 2);
  const long long per = __shfl_sync(kAll, mine, 3);
  const long long count = __shfl_sync(kAll, mine, 4);
  const long long cap_base = __shfl_sync(kAll, mine, 6);
  const long long created = __shfl_sync(kAll, mine, 7);
  const long long cap_now = wmul(freq, kNano);
  const long long safe_freq = freq == 0 ? 1 : freq;
  const long long interval = floordiv64(per, safe_freq);
  const bool rate_zero = (freq == 0) || (per == 0) || (interval == 0);
  const long long safe_interval = interval == 0 ? 1 : interval;
  const long long safe_count = count <= 0 ? 1 : count;

  // The warp's sums, a xor tree with wrapping adds (any order of a sum
  // mod 2^64 is the same value); every lane ends with the totals. The
  // own lane comes from the lane that loaded it.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sa += __shfl_xor_sync(kAll, sa, o);
    st += __shfl_xor_sync(kAll, st, o);
  }
  const int own_src = (int)(node_slot & 31);
  own_a = __shfl_sync(kAll, own_a, own_src);
  own_t = __shfl_sync(kAll, own_t, own_src);
  if (lane != 0) return;  // the scalar work and the commit: lane 0

  const long long sum_added = (long long)sa, sum_taken = (long long)st;
  const long long tokens = wsub(wadd(cap_base, sum_added), sum_taken);
  const long long c_el = wadd(created, el);
  const long long last = c_el < now ? c_el : now;
  const long long delta = wsub(now, last);
  const double grant_tokens =
      __ddiv_rn(__ll2double_rn(delta), __ll2double_rn(safe_interval));
  double grant_f = rate_zero ? 0.0 : __dmul_rn(grant_tokens, 1e9);
  grant_f = fmax(grant_f, 0.0);
  grant_f = fmin(grant_f, 4611686018427387904.0);  // 2^62
  long long grant = __double2ll_rz(floor(grant_f));
  const long long missing = wsub(cap_now, tokens);
  if (missing < grant) grant = missing;

  const long long have = wadd(tokens, grant);
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
  const long long own_added = wadd(own_a, d_added);
  const long long own_taken = wadd(own_t, d_taken);
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
    long long* own = pn + (row * N + node_slot) * 2;
    own[0] = own_added;
    own[1] = own_taken;
    elapsed[row] = new_el;
  }
}

}  // namespace

extern "C" int patrol_take_n(void* pn, void* elapsed, long long B, long long N,
                             long long node_slot, const void* packed, void* out,
                             long long K, void* stream) {
  if (K <= 0) return 0;
  const unsigned blocks = (unsigned)((K + kCols - 1) / kCols);
  take_n_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (long long*)pn, (long long*)elapsed, B, N, node_slot,
      (const long long*)packed, (long long*)out, K);
  return (int)cudaGetLastError();
}
