// The certified families on Hopper (sm_90a): GCRA, concurrency and
// hierarchical quota, each an admit kernel, and one own-lane commit.
//
// Replaces three functions that are plain XLA in the reference, not
// Pallas, and are the device work behind the engine's gcra_take,
// conc_acquire and quota_take:
//   patrol_tpu/ops/gcra.py:69         gcra_take_batch
//   patrol_tpu/ops/concurrency.py:73  conc_acquire_batch
//   patrol_tpu/ops/hierquota.py:79    quota_take_batch
// Each is one gather of rows' lane planes, a reduction over lanes, int64
// scalar arithmetic and one scatter into this node's own lane. In: one
// packed int64[P, K] request matrix (P = 5, 5, 8), rows already cast to
// int32 and wrapped ([-B, 0) -> +B) by the wrapper. Out: one int64[R, K]
// result matrix (R = 4, 6, 5), and the committed own lanes.
//
// What bounds it on this card. Bytes: each distinct gathered row's N x
// 16 B lane plane once (the TAKEN lanes interleave with ADDED, so a plane
// is read whole at the 32 B sector), the request and result matrices
// once, 8 B written per updated lane: about 8.9 MB, 2.7 us of HBM time,
// at K = 8192 x 64 lanes for GCRA and concurrency, three times the rows
// for quota. In practice a column is a chain of its request, its rows'
// lanes, a reduction and a scalar tail, as in take.cu.
//
// Design: two launches on one stream.
//  * The admit kernel, one warp per column, 8 columns per block (take.cu's
//    first design). Lane r < P loads packed[r, k]; the warp reads each
//    field by shuffle. Lane l loads lane pairs n = l, l + 32, ... of the
//    column's row (quota: of all three rows in one pass) as 16-byte
//    vectors, all in flight before any is used; the warp reduces with a
//    __shfl_xor_sync tree (wrapping int64 sums: any order of a sum mod
//    2^64 is the same value; GCRA's max is a signed max). Lane 0 does the
//    scalar tail, writes the result column and the column's commit
//    entries: a flat pn offset (or -1) and a value each.
//  * own_lane_commit, one thread per entry: atomicMax on signed int64
//    (GCRA) or atomicAdd on unsigned long long (concurrency, quota: it
//    wraps mod 2^64 as XLA's int64 add does).
//
// Hazards, and what the design does about each:
//  * Every read sees the pre-batch state. Unlike take-n's, these inputs
//    may read a committing row from another column: quota paths share
//    tenant and global rows (and a row may be a tenant in one path and a
//    user in another), GCRA and concurrency columns may repeat a row, a
//    padding column may alias a live one, and a clamped row aliases
//    row B - 1. So the admit kernel writes no state at all and the
//    commit is a second launch, ordered after it on the stream.
//  * Index semantics (ROADMAP C1): the gather clamps into [0, B), the
//    commit drops a row outside it (the wrap is the wrapper's).
//  * int64 wrap: every sum, difference and product uses unsigned
//    arithmetic (signed overflow is undefined in C++), as XLA wraps.
//  * Floor division: the reference floors every quotient, a negative
//    headroom included; floordiv64 as in take.cu. Divisors are >= 1.
//  * clip(x, 0, nreq) is min(max(x, 0), nreq): a negative nreq admits
//    (and debits) that negative count, as the reference does.
//  * A commit entry with nothing to change is skipped: an add of 0, or
//    GCRA's max of the pre-batch own lane when nothing is admitted (within
//    one call the lane only grows, so that max is a no-op).
//
// C interface (ctypes): device pointers of contiguous int64 tensors; each
// function returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;            // columns (warps) per admit block
constexpr int kThreads = 32 * kCols;
constexpr int kPass = 2;            // lane-pair loads a lane has in flight per row
constexpr int kCommitThreads = 256;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kAdded = 0;
constexpr int kTaken = 1;

__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ long long wmul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}
__device__ __forceinline__ long long lmax(long long a, long long b) { return a > b ? a : b; }
__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }

__device__ __forceinline__ long long floordiv64(long long a, long long b) {
  if (b == -1) return wsub(0, a);
  const long long q = a / b;
  const long long r = wsub(a, wmul(q, b));
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// clip(x, 0, hi) as jnp.clip computes it: min(max(x, 0), hi).
__device__ __forceinline__ long long clip0(long long x, long long hi) {
  return lmin(lmax(x, 0), hi);
}

__device__ __forceinline__ long long gather_row(long long r, long long B) {
  return r < 0 ? 0 : (r >= B ? B - 1 : r);
}

// Flat pn offset of row r's own lane of one kind, or -1: nothing to write,
// or r outside [0, B) (the reference's scatter drops it).
__device__ __forceinline__ long long commit_off(long long r, long long B, long long N,
                                                long long slot, int kind, bool write) {
  return (write && r >= 0 && r < B) ? (r * N + slot) * 2 + kind : -1;
}

// One row's lanes, read by a whole warp and reduced: wrapping sums of
// ADDED and TAKEN, the signed max of TAKEN, and the own pair (every lane
// ends with all of them).
struct RowView {
  unsigned long long sa, st;
  long long max_t, own_a, own_t;
};

__device__ __forceinline__ RowView read_row(const long long* __restrict__ pn, long long row,
                                            long long N, long long slot, int lane) {
  const longlong2* lanes = reinterpret_cast<const longlong2*>(pn + row * N * 2);
  RowView v{0, 0, LLONG_MIN, 0, 0};
  for (long long base = lane; base < N; base += 32 * kPass) {
    longlong2 x[kPass];
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      const long long n = base + 32 * j;
      x[j] = n < N ? lanes[n] : make_longlong2(0, 0);
    }
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      const long long n = base + 32 * j;
      if (n < N) {
        v.sa += (unsigned long long)x[j].x;
        v.st += (unsigned long long)x[j].y;
        v.max_t = lmax(v.max_t, x[j].y);
        if (n == slot) {
          v.own_a = x[j].x;
          v.own_t = x[j].y;
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.sa += __shfl_xor_sync(kAll, v.sa, o);
    v.st += __shfl_xor_sync(kAll, v.st, o);
    v.max_t = lmax(v.max_t, __shfl_xor_sync(kAll, v.max_t, o));
  }
  const int own_src = (int)(slot & 31);  // lane n is loaded by lane n % 32
  v.own_a = __shfl_sync(kAll, v.own_a, own_src);
  v.own_t = __shfl_sync(kAll, v.own_t, own_src);
  return v;
}

// GCRA: packed (rows, now, T, tol, nreq) -> out (admitted, tat, own_tat,
// allow_at); one commit entry a column (scatter-max of the own TAKEN lane).
__global__ void __launch_bounds__(kThreads)
gcra_admit_kernel(const long long* __restrict__ pn, long long B, long long N,
                  long long slot, const long long* __restrict__ packed,
                  long long* __restrict__ out, long long* __restrict__ commit,
                  long long K) {
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kCols + (threadIdx.x >> 5);
  if (k >= K) return;  // warp-uniform
  const long long mine = lane < 5 ? packed[lane * K + k] : 0;
  const long long row = __shfl_sync(kAll, mine, 0);
  const RowView v = read_row(pn, gather_row(row, B), N, slot, lane);
  const long long now = __shfl_sync(kAll, mine, 1);
  const long long t = __shfl_sync(kAll, mine, 2);
  const long long tol = __shfl_sync(kAll, mine, 3);
  const long long nreq = __shfl_sync(kAll, mine, 4);
  if (lane != 0) return;

  const long long tat = v.max_t, own_tat = v.own_t;
  const long long base = lmax(tat, now);
  const long long deadline = wadd(now, tol);
  const bool conforms = tat <= deadline;
  const long long safe_t = t <= 0 ? 1 : t;
  const long long extras = floordiv64(lmax(wsub(deadline, base), 0), safe_t);
  long long adm = conforms ? wadd(1, extras) : 0;
  if (t <= 0) adm = 0;
  adm = clip0(adm, nreq);
  const long long new_own = adm >= 1 ? wadd(base, wmul(adm, t)) : own_tat;
  const long long tat_out = lmax(tat, new_own);
  out[0 * K + k] = adm;
  out[1 * K + k] = tat_out;
  out[2 * K + k] = lmax(own_tat, new_own);
  out[3 * K + k] = wsub(tat_out, tol);
  commit[k] = commit_off(row, B, N, slot, kTaken, adm >= 1);
  commit[K + k] = new_own;
}

// Concurrency: packed (rows, limit, count, nreq, releases) -> out
// (admitted, released, inflight, own_acquired, own_released, clamped); two
// commit entries a column (the own ADDED and TAKEN lanes, added).
__global__ void __launch_bounds__(kThreads)
conc_admit_kernel(const long long* __restrict__ pn, long long B, long long N,
                  long long slot, const long long* __restrict__ packed,
                  long long* __restrict__ out, long long* __restrict__ commit,
                  long long K) {
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kCols + (threadIdx.x >> 5);
  if (k >= K) return;
  const long long mine = lane < 5 ? packed[lane * K + k] : 0;
  const long long row = __shfl_sync(kAll, mine, 0);
  const RowView v = read_row(pn, gather_row(row, B), N, slot, lane);
  const long long limit = __shfl_sync(kAll, mine, 1);
  const long long count = __shfl_sync(kAll, mine, 2);
  const long long nreq = __shfl_sync(kAll, mine, 3);
  const long long releases = __shfl_sync(kAll, mine, 4);
  if (lane != 0) return;

  const long long sum_added = (long long)v.sa, sum_taken = (long long)v.st;
  const long long want_rel = wmul(lmax(releases, 0), lmax(count, 0));
  const long long held_own = lmax(wsub(v.own_t, v.own_a), 0);
  const long long d_rel = lmin(want_rel, held_own);
  const long long inflight = wsub(sum_taken, wadd(sum_added, d_rel));
  const long long headroom = wsub(limit, inflight);
  const long long safe_count = count <= 0 ? 1 : count;
  long long adm = clip0(floordiv64(headroom, safe_count), nreq);
  if (count <= 0) adm = 0;
  const long long d_acq = wmul(adm, count);
  out[0 * K + k] = adm;
  out[1 * K + k] = d_rel;
  out[2 * K + k] = wadd(inflight, d_acq);
  out[3 * K + k] = wadd(v.own_t, d_acq);
  out[4 * K + k] = wadd(v.own_a, d_rel);
  out[5 * K + k] = wsub(want_rel, d_rel);
  const long long M = 2 * K;
  commit[2 * k] = commit_off(row, B, N, slot, kAdded, d_rel != 0);
  commit[2 * k + 1] = commit_off(row, B, N, slot, kTaken, d_acq != 0);
  commit[M + 2 * k] = d_rel;
  commit[M + 2 * k + 1] = d_acq;
}

// Hierarchical quota: packed (rows_global, rows_tenant, rows_user,
// limit_global, limit_tenant, limit_user, count, nreq) -> out (admitted,
// three headrooms, own_taken_user); three commit entries a column (the own
// TAKEN lane of each level's row, added).
__global__ void __launch_bounds__(kThreads)
quota_admit_kernel(const long long* __restrict__ pn, long long B, long long N,
                   long long slot, const long long* __restrict__ packed,
                   long long* __restrict__ out, long long* __restrict__ commit,
                   long long K) {
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kCols + (threadIdx.x >> 5);
  if (k >= K) return;
  const long long mine = lane < 8 ? packed[lane * K + k] : 0;
  long long rows[3];
  const longlong2* planes[3];
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    rows[l] = __shfl_sync(kAll, mine, l);
    planes[l] = reinterpret_cast<const longlong2*>(pn + gather_row(rows[l], B) * N * 2);
  }
  // The three rows' lanes in one pass: every load of the path in flight
  // before any is used. Only TAKEN is summed; the user row's own TAKEN
  // lane is kept.
  unsigned long long spend[3] = {0, 0, 0};
  long long own_u = 0;
  for (long long base = lane; base < N; base += 32 * kPass) {
    longlong2 x[3][kPass];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const long long n = base + 32 * j;
        x[l][j] = n < N ? planes[l][n] : make_longlong2(0, 0);
      }
    }
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
#pragma unroll
      for (int l = 0; l < 3; ++l) spend[l] += (unsigned long long)x[l][j].y;
      if (base + 32 * j == slot) own_u = x[2][j].y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int l = 0; l < 3; ++l) spend[l] += __shfl_xor_sync(kAll, spend[l], o);
  }
  own_u = __shfl_sync(kAll, own_u, (int)(slot & 31));
  const long long lim_g = __shfl_sync(kAll, mine, 3);
  const long long lim_t = __shfl_sync(kAll, mine, 4);
  const long long lim_u = __shfl_sync(kAll, mine, 5);
  const long long count = __shfl_sync(kAll, mine, 6);
  const long long nreq = __shfl_sync(kAll, mine, 7);
  if (lane != 0) return;

  const long long head_g = wsub(lim_g, (long long)spend[0]);
  const long long head_t = wsub(lim_t, (long long)spend[1]);
  const long long head_u = wsub(lim_u, (long long)spend[2]);
  const long long head_min = lmin(lmin(head_g, head_t), head_u);
  const long long safe_count = count <= 0 ? 1 : count;
  long long adm = clip0(floordiv64(head_min, safe_count), nreq);
  if (count <= 0) adm = 0;
  const long long d = wmul(adm, count);
  out[0 * K + k] = adm;
  out[1 * K + k] = wsub(head_g, d);
  out[2 * K + k] = wsub(head_t, d);
  out[3 * K + k] = wsub(head_u, d);
  out[4 * K + k] = wadd(own_u, d);
  const long long M = 3 * K;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    commit[l * K + k] = commit_off(rows[l], B, N, slot, kTaken, d != 0);
    commit[M + l * K + k] = d;
  }
}

// commit: int64[2, M], flat pn offsets (-1: none) then values. op 0: a
// signed max; op 1: a wrapping add.
__global__ void __launch_bounds__(kCommitThreads)
own_lane_commit_kernel(long long* __restrict__ pn, long long numel,
                       const long long* __restrict__ commit, long long M, int op) {
  const long long i = (long long)blockIdx.x * kCommitThreads + threadIdx.x;
  if (i >= M) return;
  const long long off = commit[i];
  if (off < 0 || off >= numel) return;
  const long long val = commit[M + i];
  if (op == 0) {
    atomicMax(pn + off, val);
  } else {
    atomicAdd(reinterpret_cast<unsigned long long*>(pn + off), (unsigned long long)val);
  }
}

}  // namespace

extern "C" int patrol_cert_admit(int family, const void* pn, long long B, long long N,
                                 long long slot, const void* packed, void* out,
                                 void* commit, long long K, void* stream) {
  if (K <= 0) return 0;
  const unsigned blocks = (unsigned)((K + kCols - 1) / kCols);
  const long long* p = (const long long*)pn;
  const long long* q = (const long long*)packed;
  long long* o = (long long*)out;
  long long* c = (long long*)commit;
  cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case 0: gcra_admit_kernel<<<blocks, kThreads, 0, s>>>(p, B, N, slot, q, o, c, K); break;
    case 1: conc_admit_kernel<<<blocks, kThreads, 0, s>>>(p, B, N, slot, q, o, c, K); break;
    case 2: quota_admit_kernel<<<blocks, kThreads, 0, s>>>(p, B, N, slot, q, o, c, K); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int patrol_own_lane_commit(void* pn, long long numel, const void* commit,
                                      long long M, int op, void* stream) {
  if (M <= 0) return 0;
  const unsigned blocks = (unsigned)((M + kCommitThreads - 1) / kCommitThreads);
  own_lane_commit_kernel<<<blocks, kCommitThreads, 0, (cudaStream_t)stream>>>(
      (long long*)pn, numel, (const long long*)commit, M, op);
  return (int)cudaGetLastError();
}
