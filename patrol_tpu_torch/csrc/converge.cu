// The mesh converge on Hopper (sm_90a): the cross-replica join of one
// dispatch's take rows, and the gather that makes their replica copies.
//
// Replaces patrol_tpu/parallel/topology.py::converge (:182), its tree
// schedule _tree_allreduce_max (:120) and its flat one _allreduce_max
// (:108). Those are XLA collectives in the reference, not Pallas: an
// elementwise signed int64 max of each shard's planes over the R replicas
// of a (replicas x shards) mesh, once per fused dispatch. On one card the
// port keeps one canonical copy of the state and copies only the rows the
// dispatch's takes touch (parallel/topology.py), so the converge becomes
// two passes over a scratch of R copies of T rows:
//  * gather (mode 1): spn[r, t] = pn[rows[t]], sel[r, t] = elapsed[rows[t]]
//    for every replica r, before the dispatch's merges and takes;
//  * converge (mode 0): pn[rows[t]] = max over r of spn[r, t] and
//    elapsed[rows[t]] = max over r of sel[r, t], after them.
// The tree and the flat schedules are one kernel here: max is associative,
// commutative and idempotent, so any order gives the same bits.
//
// What bounds it on this card. Bytes: each pass reads or writes the R
// copies once and the canonical rows once, (R + 1) x T x (16 N + 8) bytes
// plus the T row indices -- 12.7 MB, 3.8 us of HBM time, at T = 4096 take
// rows, N = 64 lanes and R = 2. No arithmetic to speak of: a streaming
// pass. Cold, the DRAM sets the time, not the kernel: canonical rows are
// 1 KiB scattered over the state, and the scratch written by earlier
// dispatches is written back as this one's lines take its place. Warm, a
// launch's fixed costs are much of it.
//
// Design: lanes per take row, loads before use.
//  * gather: a warp a take row, four a block. The lanes read the row index
//    once (one transaction), then the row's 16-byte lane pairs, two a lane
//    (N = 64 in one pass), with lane 0 reading the elapsed word beside
//    them; then each lane stores its pairs' R copies, and lane 0 the R
//    elapsed copies: coalesced 128-bit stores, a chain of two loads.
//  * converge: the R scratch copies of a row do not depend on its index,
//    so every lane issues all its loads -- the index, its pairs' R copies,
//    and at lane 0 the R elapsed copies -- before it uses any, and only
//    the stores wait on the index: one trip to memory, not two. The
//    copies sit in registers, kR of them (a larger R folds the rest in
//    after): R <= 2 takes a warp a row and two pairs a lane; R <= 4 and
//    R <= 8 take two warps a row and one pair a lane, which halves the
//    copies a lane holds.
//  * No lane divides an index by N; no shared memory, no barrier.
// Two designs lost to this one in converge_ab.py's turns (PERF.md): a
// ring of Hopper's 1-D bulk asynchronous copies (TMA) in shared memory,
// one elected thread issuing them, was slower at every shape, its floor by
// 0.7-1 us; warps that take several rows each were slower cold.
//
// Hazards, and what the design does about each:
//  * Signed order. The reference's max is jnp.maximum on int64, which is
//    signed: a lane that a take wrapped past 2^63 loses to another
//    replica's unwrapped copy. The max here is signed too (not the
//    unsigned max of the full-state merge).
//  * Rows. The host passes T distinct rows in [0, B) (the dispatch's take
//    rows); a row outside [0, B) is skipped: nothing is written for it
//    (the converge's loads of its scratch are dropped). Distinct rows mean
//    no two lanes write one word.
//  * Alignment. pn and spn are read as 16-byte vectors: the wrapper checks
//    that both are 16-byte aligned.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // the gather: a warp a take row, four a block

struct ConvergeArgs {
  long long* pn;        // [B, N, 2]
  long long* elapsed;   // [B]
  long long B, N;
  long long* spn;       // [R, T, N, 2]
  long long* sel;       // [R, T]
  long long R, T;
  const long long* rows;  // [T]
};

__device__ __forceinline__ long long smax(long long a, long long b) { return a > b ? a : b; }

// pn's 16-byte lane pair i, as a reference (one 128-bit load or store).
__device__ __forceinline__ longlong2& lanes_at(long long* p, long long i) {
  return reinterpret_cast<longlong2*>(p)[i];
}

__device__ __forceinline__ bool in_state(const ConvergeArgs& a, long long row) {
  return row >= 0 && row < a.B;
}

__global__ void __launch_bounds__(kThreads) gather_kernel(const ConvergeArgs a) {
  const long long t = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (t >= a.T) return;
  const int lane = threadIdx.x & 31;
  const long long row = a.rows[t];
  if (!in_state(a, row)) return;
  long long e = 0;
  if (lane == 0) e = a.elapsed[row];
  const longlong2* __restrict__ src = reinterpret_cast<const longlong2*>(a.pn) + row * a.N;
  longlong2* __restrict__ dst = reinterpret_cast<longlong2*>(a.spn) + t * a.N;
  const long long copy = a.T * a.N;  // lane pairs between two replicas' copies
  for (long long v = lane; v < a.N; v += 64) {
    const bool two = v + 32 < a.N;
    const longlong2 x0 = src[v];
    longlong2 x1 = x0;
    if (two) x1 = src[v + 32];
    for (long long r = 0; r < a.R; ++r) {
      dst[r * copy + v] = x0;
      if (two) dst[r * copy + v + 32] = x1;
    }
  }
  if (lane == 0)
    for (long long r = 0; r < a.R; ++r) a.sel[r * a.T + t] = e;
}

// kLanes lanes a take row (32 or 64), each taking 64 / kLanes of its lane
// pairs a pass; a block holds four take rows. kR: the replica copies a
// lane holds in registers at once (R <= kR; a larger R folds the rest in
// after).
template <int kR, int kLanes>
__global__ void __launch_bounds__(4 * kLanes) converge_kernel(const ConvergeArgs a) {
  constexpr int kPairs = 64 / kLanes;
  const long long t = (static_cast<long long>(blockIdx.x) * 4 * kLanes + threadIdx.x) / kLanes;
  if (t >= a.T) return;
  const int lane = threadIdx.x % kLanes;
  // Every load goes out before any is used: the row index, lane 0's
  // elapsed copies, and each lane's R copies of its lane pairs (none of
  // them waits on the index).
  const long long row = a.rows[t];
  long long e[kR];
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (r < a.R) e[r] = a.sel[r * a.T + t];
  }
  const longlong2* __restrict__ src = reinterpret_cast<const longlong2*>(a.spn) + t * a.N;
  const long long copy = a.T * a.N;  // lane pairs between two replicas' copies
  for (long long base = lane; base < a.N; base += 64) {
    longlong2 x[kPairs][kR];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const long long v = base + p * kLanes;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (r < a.R && v < a.N) x[p][r] = src[r * copy + v];
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const long long v = base + p * kLanes;
      if (v >= a.N) continue;
      longlong2 m = x[p][0];
#pragma unroll
      for (int r = 1; r < kR; ++r) {
        if (r < a.R) {
          m.x = smax(m.x, x[p][r].x);
          m.y = smax(m.y, x[p][r].y);
        }
      }
      for (long long r = kR; r < a.R; ++r) {
        const longlong2 y = src[r * copy + v];
        m.x = smax(m.x, y.x);
        m.y = smax(m.y, y.y);
      }
      if (in_state(a, row)) lanes_at(a.pn, row * a.N + v) = m;
    }
  }
  if (lane == 0 && in_state(a, row)) {
    long long m = e[0];
#pragma unroll
    for (int r = 1; r < kR; ++r)
      if (r < a.R) m = smax(m, e[r]);
    for (long long r = kR; r < a.R; ++r) m = smax(m, a.sel[r * a.T + t]);
    a.elapsed[row] = m;
  }
}

}  // namespace

// gather != 0: fill the scratch from the canonical rows; else converge
// the scratch into them. Launches on `stream`, does not synchronise;
// returns cudaGetLastError() after the launch (0 when T, R or N is 0 and
// nothing is launched).
extern "C" int patrol_converge(int gather, void* pn, void* elapsed, long long B, long long N,
                               void* spn, void* sel, long long R, long long T, const void* rows,
                               void* stream) {
  if (T <= 0 || R <= 0 || N <= 0) return 0;
  ConvergeArgs a{static_cast<long long*>(pn), static_cast<long long*>(elapsed), B, N,
                 static_cast<long long*>(spn), static_cast<long long*>(sel), R, T,
                 static_cast<const long long*>(rows)};
  const unsigned blocks = static_cast<unsigned>((T + 3) / 4);  // four take rows a block
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The converge's lanes a take row by R (see converge_kernel's note).
  if (gather)
    gather_kernel<<<blocks, kThreads, 0, s>>>(a);
  else if (R <= 2)
    converge_kernel<2, 32><<<blocks, 4 * 32, 0, s>>>(a);
  else if (R <= 4)
    converge_kernel<4, 64><<<blocks, 4 * 64, 0, s>>>(a);
  else
    converge_kernel<8, 64><<<blocks, 4 * 64, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
