// The scatter-max CRDT join on Hopper (sm_90a).
//
// Replaces patrol_tpu/ops/pallas_merge.py::_kernel (launched by
// _merge_pallas_device, entry merge_batch_pallas): for each delta
//   pn[row, slot, ADDED] = max(., added)
//   pn[row, slot, TAKEN] = max(., taken)
//   elapsed[row]         = max(., elapsed)
// and, for the dense half (merge_rows_dense), the same max over a whole
// row's N x 2 lane plane.
//
// What bounds it on this card: bytes moved, and at the engine's batch
// sizes (K <= 8192 pairs per block, a few blocks per commit ring) not even
// that -- 8192 pairs touch ~400 KB, a fraction of a microsecond of HBM
// time, so a launch is bound by launch latency. The design therefore
// keeps one launch per call and does no host planning at all.
//
// Why atomics instead of the TPU's sorted block walk: the TPU kernel ran
// its grid in order on one core, so the host sorted deltas by row and the
// grid visited each touched 512-row block once, with int64 split into
// (lo, hi) int32 pairs because Mosaic had no 64-bit vector max. Hopper has
// a native 64-bit atomicMax on signed long long, exact over the whole
// int64 domain, and blocks run in no order on 132 SMs. One thread per
// pair doing two atomicMax ops makes duplicate keys inside one batch exact
// (merge_batch receives unfolded deltas) with no sort, no int32 split and
// no block planning. Rows outside [0, B) and slots outside [0, N) are
// dropped, never clamped: that is mode="drop" in the reference and the
// FOLD_PAD_ROW sentinel padding of the folded and commit-ring layouts.
//
// C interface (loaded with ctypes): pointers are device pointers of
// contiguous int64 tensors; `stream` is a cudaStream_t. Each function
// returns the cudaError_t of its launch (0 on success); a call with no
// work launches nothing and returns 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPairThreads = 256;

__global__ void pair_join_kernel(long long* __restrict__ pn,
                                 long long* __restrict__ elapsed,
                                 long long B, long long N,
                                 const long long* __restrict__ rows,
                                 const long long* __restrict__ slots,
                                 const long long* __restrict__ added,
                                 const long long* __restrict__ taken,
                                 long long K,
                                 const long long* __restrict__ erows,
                                 const long long* __restrict__ evals,
                                 long long Ke) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < K) {
    const long long r = rows[i];
    const long long s = slots[i];
    if (r >= 0 && r < B && s >= 0 && s < N) {
      long long* p = pn + (r * N + s) * 2;
      atomicMax(p, added[i]);
      atomicMax(p + 1, taken[i]);
    }
  } else if (i < K + Ke) {
    const long long j = i - K;
    const long long r = erows[j];
    if (r >= 0 && r < B) atomicMax(elapsed + r, evals[j]);
  }
}

// One block per update row, its threads striding over the row's 2N
// (lane, plane) values. Rows are unique in the engine's dense batches, but
// the atomics keep duplicates exact too.
__global__ void row_join_kernel(long long* __restrict__ pn,
                                long long* __restrict__ elapsed,
                                long long B, long long N,
                                const long long* __restrict__ rows,
                                const long long* __restrict__ updates,
                                const long long* __restrict__ evals) {
  const long long u = blockIdx.x;
  const long long r = rows[u];
  if (r < 0 || r >= B) return;
  const long long w = 2 * N;
  long long* dst = pn + r * w;
  const long long* src = updates + u * w;
  for (long long l = threadIdx.x; l < w; l += blockDim.x) atomicMax(dst + l, src[l]);
  if (threadIdx.x == 0) atomicMax(elapsed + r, evals[u]);
}

}  // namespace

extern "C" int patrol_pair_join(void* pn, void* elapsed, long long B, long long N,
                                const void* rows, const void* slots,
                                const void* added, const void* taken, long long K,
                                const void* erows, const void* evals, long long Ke,
                                void* stream) {
  const long long total = K + Ke;
  if (total <= 0) return 0;
  const long long blocks = (total + kPairThreads - 1) / kPairThreads;
  pair_join_kernel<<<(unsigned)blocks, kPairThreads, 0, (cudaStream_t)stream>>>(
      (long long*)pn, (long long*)elapsed, B, N, (const long long*)rows,
      (const long long*)slots, (const long long*)added, (const long long*)taken, K,
      (const long long*)erows, (const long long*)evals, Ke);
  return (int)cudaGetLastError();
}

extern "C" int patrol_row_join(void* pn, void* elapsed, long long B, long long N,
                               const void* rows, const void* updates, const void* evals,
                               long long R, void* stream) {
  if (R <= 0) return 0;
  long long threads = 2 * N;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  row_join_kernel<<<(unsigned)R, (unsigned)threads, 0, (cudaStream_t)stream>>>(
      (long long*)pn, (long long*)elapsed, B, N, (const long long*)rows,
      (const long long*)updates, (const long long*)evals);
  return (int)cudaGetLastError();
}
