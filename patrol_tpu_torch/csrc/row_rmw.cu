// Per-row read-modify-write scatter on Hopper (sm_90a).
//
// Replaces scripts/probe_dma_scatter.py::mk_kern (pallas_call in build,
// :86): K update rows of an int32[B, 8, 128] state, each row 4 KiB -- 512
// int64 values with (lo, hi) int32 halves interleaved, which is bit for
// bit the limiter's pn int64[B, 256, 2] viewed as int32 on a
// little-endian card. Two inner functions, selected by `inner`:
//
//   0  bcast    state[row, :] = max(state[row, :], lo[j])  per int32, signed
//   1  pairmax  row64[p] = max(row64[p], upd64[p])  over the row's 512 int64
//               pairs, signed, with upd64 = (int64(hi[j]) << 32) | uint32(lo[j])
//               at pair w0[j] / 2 (arithmetic shift) and 0 at every other pair.
//
// The TPU kernel's lexicographic compare (signed on hi, unsigned on lo via
// the sign-flip trick) is exactly the signed int64 order, so pairmax is a
// plain 64-bit max. Its zero update raises every negative pair of a touched
// row to 0; that is the reference's function and is kept. w0 is even in the
// contract (values = 0 mod 4 land on the ADDED plane of lane w0 / 4, = 2
// mod 4 on the TAKEN plane); an even w0 outside [0, 1024) touches no pair
// in either kernel.
//
// Rows outside [0, B) are dropped, as in join.cu. Update rows must be
// unique: duplicates are outside the contract, as for the TPU kernel,
// whose reads ran D rows ahead of its writes; here two blocks on one row
// race and one write is lost.
//
// What bounds it on this card: bytes. Each update reads and writes one
// 4 KiB row (K = 8192 rows: 64 MiB, ~20 us at the H100 SXM data sheet's
// 3.35 TB/s); the arithmetic is one max per value. The TPU needed a
// D-deep DMA pipeline through VMEM because Mosaic accepts no other
// dynamic-row RMW; on Hopper many blocks in flight hide the load latency
// instead. This first version is one
// 256-thread block per update row, one 16-byte vector per thread (the
// row in one coalesced pass). A TMA ring with several rows per block is
// later work.
//
// C interface (loaded with ctypes): `state` is the device pointer of a
// contiguous int32[B, 1024] tensor, `rows`, `w0`, `lo`, `hi` of contiguous
// int32[K] tensors on the same device; `stream` is a cudaStream_t.
// Returns the cudaError_t of the launch (0 on success; K <= 0 launches
// nothing, an unknown `inner` returns cudaErrorInvalidValue).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowInts = 1024;              // 8 x 128 int32 = 4 KiB
constexpr int kThreads = kRowInts / 4;      // one int4 per thread

__device__ __forceinline__ long long max64(long long a, long long b) { return a > b ? a : b; }

template <int kInner>
__global__ void __launch_bounds__(kThreads)
row_rmw_kernel(int* __restrict__ state, long long B, const int* __restrict__ rows,
               const int* __restrict__ w0, const int* __restrict__ lo,
               const int* __restrict__ hi) {
  const int j = blockIdx.x;
  const long long r = rows[j];
  if (r < 0 || r >= B) return;
  int* row = state + r * kRowInts;
  const int l = lo[j];
  if (kInner == 0) {
    int4* p = reinterpret_cast<int4*>(row) + threadIdx.x;
    int4 v = *p;
    v.x = max(v.x, l);
    v.y = max(v.y, l);
    v.z = max(v.z, l);
    v.w = max(v.w, l);
    *p = v;
  } else {
    // This thread's 16 bytes hold pairs 2t and 2t + 1.
    longlong2* p = reinterpret_cast<longlong2*>(row) + threadIdx.x;
    const int pair = w0[j] >> 1;
    const long long u = (static_cast<long long>(hi[j]) << 32) |
                        static_cast<long long>(static_cast<unsigned int>(l));
    const int first = 2 * static_cast<int>(threadIdx.x);
    longlong2 q = *p;
    q.x = max64(q.x, pair == first ? u : 0LL);
    q.y = max64(q.y, pair == first + 1 ? u : 0LL);
    *p = q;
  }
}

}  // namespace

extern "C" int patrol_row_rmw(void* state, long long B, const void* rows, const void* w0,
                              const void* lo, const void* hi, long long K, int inner,
                              void* stream) {
  if (K <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  int* st = (int*)state;
  const int* r = (const int*)rows;
  const int* w = (const int*)w0;
  const int* l = (const int*)lo;
  const int* h = (const int*)hi;
  if (inner == 0) {
    row_rmw_kernel<0><<<(unsigned)K, kThreads, 0, s>>>(st, B, r, w, l, h);
  } else if (inner == 1) {
    row_rmw_kernel<1><<<(unsigned)K, kThreads, 0, s>>>(st, B, r, w, l, h);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
