// The scatter-max CRDT join on Hopper (sm_90a): one kernel, one launch per
// merge tick.
//
// Replaces patrol_tpu/ops/pallas_merge.py::_kernel (:86), launched by
// _merge_pallas_device (pallas_call at :270): for each pair
//   pn[row, slot, ADDED] = max(., added)
//   pn[row, slot, TAKEN] = max(., taken)
// for each elapsed entry
//   elapsed[row]         = max(., value)
// and, for the dense half of a tick (the fold's hot rows, merge_rows_dense
// in the reference), the same max over a whole row's N x 2 lane plane and
// its elapsed word.
//
// What bounds it on this card. The work per call is small: 8,192 pairs
// touch ~0.4 MB of state, a commit ring of J = 8 blocks ~11 MB counted in
// 32-byte sectors (each touched pair and elapsed word costs one sector
// read and one written). A tick is bound by the launch (~2.3 us back to
// back) and by one dependent chain: load an entry, then update the state.
// Past that, scattered 64-bit updates cost one L2 transaction per sector a
// warp instruction touches, issued by the SM one after another, so what an
// SM issues sets the time. What the design does about each:
//  * One launch per tick. The dense rows and the pairs of a tick ride one
//    grid: blocks [0, D) serve dense rows, the blocks after them pair
//    words, then elapsed entries. A hybrid tick pays one launch, not two.
//  * Live entries only. The grid is sized from the live counts the host
//    passes, so the FOLD_PAD_ROW tail of a padded batch is never loaded.
//  * Few transactions per SM. Blocks are 4 warps, so a tick's 8,192 pairs
//    spread over every SM. A pair's two words go to two neighbouring
//    lanes, so one warp instruction updates both in one sector
//    transaction. (Two entries a thread with 16-byte loads of each stream,
//    in 8-warp blocks, was tried first and was slower: it doubles what
//    each SM issues; PERF.md has the numbers.)
//  * Wide loads for dense rows. A dense row goes to one warp: each lane
//    loads its (added, taken) pairs as 16-byte vectors, so one warp
//    instruction reads 512 contiguous bytes, all issued before any
//    update; the row's elapsed word goes by lane 0.
//  * Fire-and-forget updates. A 64-bit atomicMax whose result is unused
//    compiles to a reduction (RED.E.MAX.S64, no return trip to the
//    thread) and is exact for duplicate keys in any order: merge_batch
//    and delta_fold send unfolded keys. For the fold's keys, unique by
//    construction, a load, max and store of each pair was tried instead
//    and was slower at every shape the engine ships (each thread waits
//    for its load).
//
// Why not the TPU's sorted block walk: the TPU kernel ran its grid in
// order on one core, so the host sorted deltas by row and the grid
// visited each touched 512-row block once, with int64 split into (lo, hi)
// int32 pairs because Mosaic had no 64-bit vector max. Hopper has a
// native 64-bit signed max reduction, exact over the whole int64 domain,
// and blocks run in no order on 132 SMs, so no sort, no split and no
// block plan. Rows outside [0, B) and slots outside [0, N) are dropped,
// never clamped: that is mode="drop" in the reference and the
// FOLD_PAD_ROW sentinel padding of the folded and commit-ring layouts.
//
// C interface (loaded with ctypes): pointers are device pointers of
// contiguous int64 tensors, `stream` a cudaStream_t. patrol_join returns
// the cudaError_t of its launch (0 on success); a call with nothing live
// launches nothing and returns 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per dense row
constexpr int kRowChunk = 4;                  // 16-byte vectors in flight per lane

struct JoinArgs {
  long long* pn;
  long long* elapsed;
  long long B, N;
  // Dense half: R rows, updates[R, N, 2], evals[R].
  const long long* drows;
  const long long* dupd;
  const long long* devals;
  long long R;
  // Pair half: K (row, slot, added, taken) and Ke (erow, eval) entries.
  const long long* rows;
  const long long* slots;
  const long long* added;
  const long long* taken;
  long long K;
  const long long* erows;
  const long long* evals;
  long long Ke;
  long long dense_blocks;  // blocks [0, dense_blocks) serve dense rows,
                           // then 2K pair-word threads, then Ke elapsed
};

// One warp per dense row. Each lane loads its (added, taken) pairs as
// 16-byte vectors (a warp instruction reads 512 contiguous bytes), all
// before any update; lane 0 takes the row's elapsed word. (Handing the
// words round with shuffles, so that one warp reduction covers 8
// contiguous sectors instead of 16, was tried and was no faster.)
__device__ __forceinline__ void dense_row(const JoinArgs& a) {
  const long long u = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (u >= a.R) return;  // warp-uniform
  const longlong2* src = reinterpret_cast<const longlong2*>(a.dupd) + u * a.N;
  const long long r = __ldg(a.drows + u);
  const long long ev = lane == 0 ? __ldg(a.devals + u) : 0;
  for (long long p0 = 0; p0 < a.N; p0 += kRowChunk * 32) {
    longlong2 v[kRowChunk];
#pragma unroll
    for (int j = 0; j < kRowChunk; ++j) {
      const long long p = p0 + j * 32 + lane;
      if (p < a.N) v[j] = __ldg(src + p);
    }
    if (r < 0 || r >= a.B) return;  // warp-uniform
    long long* dst = a.pn + r * a.N * 2;
#pragma unroll
    for (int j = 0; j < kRowChunk; ++j) {
      const long long p = p0 + j * 32 + lane;
      if (p < a.N) {
        atomicMax(dst + 2 * p, v[j].x);
        atomicMax(dst + 2 * p + 1, v[j].y);
      }
    }
  }
  if (lane == 0 && r >= 0 && r < a.B) atomicMax(a.elapsed + r, ev);
}

// Word t of the pair half: component (t & 1) of pair t >> 1, so the two
// lanes of a pair update its two words in one warp instruction, one
// 32-byte sector between them.
__device__ __forceinline__ void pair_word(const JoinArgs& a, long long t) {
  const long long i = t >> 1;
  const long long r = __ldg(a.rows + i);
  const long long s = __ldg(a.slots + i);
  const long long v = __ldg(((t & 1) ? a.taken : a.added) + i);
  if (r < 0 || r >= a.B || s < 0 || s >= a.N) return;
  atomicMax(a.pn + (r * a.N + s) * 2 + (t & 1), v);
}

__device__ __forceinline__ void elapsed_entry(const JoinArgs& a, long long e) {
  const long long r = __ldg(a.erows + e);
  const long long v = __ldg(a.evals + e);
  if (r >= 0 && r < a.B) atomicMax(a.elapsed + r, v);
}

__global__ void __launch_bounds__(kThreads) join_kernel(const JoinArgs a) {
  if (blockIdx.x < a.dense_blocks) {
    dense_row(a);
    return;
  }
  const long long t = ((long long)blockIdx.x - a.dense_blocks) * kThreads + threadIdx.x;
  if (t < 2 * a.K) pair_word(a, t);
  else if (t < 2 * a.K + a.Ke) elapsed_entry(a, t - 2 * a.K);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int patrol_join(void* pn, void* elapsed, long long B, long long N,
                           const void* drows, const void* dupd, const void* devals, long long R,
                           const void* rows, const void* slots, const void* added,
                           const void* taken, long long K, const void* erows,
                           const void* evals, long long Ke, void* stream) {
  if (R < 0 || K < 0 || Ke < 0) return (int)cudaErrorInvalidValue;
  JoinArgs a;
  a.pn = (long long*)pn;
  a.elapsed = (long long*)elapsed;
  a.B = B;
  a.N = N;
  a.drows = (const long long*)drows;
  a.dupd = (const long long*)dupd;
  a.devals = (const long long*)devals;
  a.R = R;
  a.rows = (const long long*)rows;
  a.slots = (const long long*)slots;
  a.added = (const long long*)added;
  a.taken = (const long long*)taken;
  a.K = K;
  a.erows = (const long long*)erows;
  a.evals = (const long long*)evals;
  a.Ke = Ke;
  a.dense_blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = a.dense_blocks + (2 * K + Ke + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  // The dense half loads 16-byte vectors of its updates.
  if (R > 0 && !aligned16(dupd)) return (int)cudaErrorMisalignedAddress;
  join_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
