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
// -- 12.7 MB, 3.8 us of HBM time, at T = 4096 take rows, N = 64 lanes and
// R = 2. No arithmetic to speak of: a streaming pass.
//
// Design: one thread per 16-byte lane pair (added, taken) of a take row,
// T x N of them, then one thread per take row's elapsed word; 256 threads
// a block, a grid-stride loop. Consecutive threads take consecutive lanes
// of one row, so a warp's loads and stores are 512 contiguous bytes of a
// row and of each replica copy (128-bit vectors, coalesced). A converge
// thread issues its R loads before it takes the max.
//
// Hazards, and what the design does about each:
//  * Signed order. The reference's max is jnp.maximum on int64, which is
//    signed: a lane that a take wrapped past 2^63 loses to another
//    replica's unwrapped copy. The max here is signed too (not the
//    unsigned max of the full-state merge).
//  * Rows. The host passes T distinct rows in [0, B) (the dispatch's take
//    rows); a row outside [0, B) is skipped, so no thread writes outside
//    the state. Distinct rows mean no two threads write one word.
//  * Alignment. pn and spn are read as 16-byte vectors: the wrapper checks
//    that both are 16-byte aligned.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

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

__global__ void __launch_bounds__(kThreads) gather_kernel(const ConvergeArgs a) {
  const long long pairs = a.T * a.N;
  const long long total = pairs + a.T;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    if (i < pairs) {
      const long long t = i / a.N;
      const long long row = a.rows[t];
      if (row < 0 || row >= a.B) continue;
      const longlong2 v = reinterpret_cast<const longlong2*>(a.pn)[row * a.N + (i - t * a.N)];
      longlong2* dst = reinterpret_cast<longlong2*>(a.spn) + i;
      for (long long r = 0; r < a.R; ++r) dst[r * pairs] = v;
    } else {
      const long long t = i - pairs;
      const long long row = a.rows[t];
      if (row < 0 || row >= a.B) continue;
      const long long v = a.elapsed[row];
      for (long long r = 0; r < a.R; ++r) a.sel[r * a.T + t] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads) converge_kernel(const ConvergeArgs a) {
  const long long pairs = a.T * a.N;
  const long long total = pairs + a.T;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    if (i < pairs) {
      const long long t = i / a.N;
      const long long row = a.rows[t];
      if (row < 0 || row >= a.B) continue;
      const longlong2* src = reinterpret_cast<const longlong2*>(a.spn) + i;
      longlong2 m = src[0];
#pragma unroll 4
      for (long long r = 1; r < a.R; ++r) {
        const longlong2 v = src[r * pairs];
        m.x = smax(m.x, v.x);
        m.y = smax(m.y, v.y);
      }
      reinterpret_cast<longlong2*>(a.pn)[row * a.N + (i - t * a.N)] = m;
    } else {
      const long long t = i - pairs;
      const long long row = a.rows[t];
      if (row < 0 || row >= a.B) continue;
      long long m = a.sel[t];
#pragma unroll 4
      for (long long r = 1; r < a.R; ++r) m = smax(m, a.sel[r * a.T + t]);
      a.elapsed[row] = m;
    }
  }
}

}  // namespace

// gather != 0: fill the scratch from the canonical rows; else converge
// the scratch into them. Launches on `stream`, does not synchronise;
// returns cudaGetLastError() after the launch (0 when T or R is 0 and
// nothing is launched).
extern "C" int patrol_converge(int gather, void* pn, void* elapsed, long long B, long long N,
                               void* spn, void* sel, long long R, long long T, const void* rows,
                               void* stream) {
  if (T <= 0 || R <= 0 || N <= 0) return 0;
  ConvergeArgs a{static_cast<long long*>(pn), static_cast<long long*>(elapsed), B, N,
                 static_cast<long long*>(spn), static_cast<long long*>(sel), R, T,
                 static_cast<const long long*>(rows)};
  long long blocks = (T * N + T + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gather)
    gather_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a);
  else
    converge_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
