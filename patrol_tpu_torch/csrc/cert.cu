// The certified families on Hopper (sm_90a): GCRA, concurrency and
// hierarchical quota.
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
// once, 8 B written per updated lane: about 4-5 MB, 1.3-1.5 us of HBM
// time, at K = 8192 x 64 lanes on phase 2's corpus, whose rows repeat.
// A launch that does little costs 2.2-2.8 us back to back, and a column
// is a chain of its request, its rows' lanes, a reduction and a scalar
// tail, so the launches and the chain's latency set the time, not the
// bytes.
//
// Every family: one launch a call (gcra_admit_kernel, conc_admit_kernel,
// quota_admit_kernel), the admit and the own-lane commit fused.
//  * Reads before commits. A commit may land on a row another column
//    reads (below), so every block finishes its reads, the grid meets at
//    one barrier (arrive, wait), and only then does any block commit. A
//    block arrives as soon as its last tile's lanes are reduced and runs
//    its tails while the others arrive. The grid is persistent so that the
//    barrier can be met: launched cooperatively, with no more blocks than
//    the card holds resident (the occupancy call's blocks an SM x the SMs,
//    patrol_cert_occupancy) and no more than K needs (K <= 32 is one block,
//    which needs no grid barrier); a block walks tiles b, b + grid, ... .
//  * One wave at K = 8192: 32 columns a block of 256 threads gives 256
//    blocks, resident at two blocks an SM (__launch_bounds__ caps the
//    registers at 128 a thread for that), so every column's chain is in
//    flight at once (the first design ran 1,024 blocks of one warp a
//    column, and quota's and concurrency's registers made that two waves).
//  * Eight lanes a column (lifecycle.cu's layout). Thread t < 32 is column
//    t's own thread and loads its fields, so each row of the request is
//    read as the block's 32 contiguous values; the 8 threads 8c .. 8c + 7
//    are column c's lane group, which loads the column's row(s) itself in
//    the same trip. Lane l of a group loads lanes l, l + 8, ..., a pass of
//    8 in flight before any is used (GCRA: the TAKEN word of its row;
//    quota: the TAKEN word of all three rows, 24 loads; concurrency:
//    16-byte pairs). Groups reduce by a 3-step __shfl_xor_sync tree and
//    hand the reductions and the own lane to the own threads through
//    shared memory: wrapping int64 sums (any order of a sum mod 2^64 is
//    the same value), and for GCRA the signed max of TAKEN, whose identity
//    is LLONG_MIN (a TAT or a preset remote lane may be negative, so a
//    lane past N or an idle group must not contribute 0).
//  * The scalar tail one column a thread: warp 0 runs 32 tails at once
//    (the first design ran one a warp, on lane 0), writes the result
//    columns coalesced, and appends the column's commit entries (a flat pn
//    offset and a value) only where there is something to commit, in
//    column order by ballot: a column that admits and releases nothing
//    writes none (the first design wrote and re-read 1 to 3 a column).
//    The block keeps its entries in shared memory, one tile's worth, and
//    the rest in its own stretch of a global spill buffer the wrapper
//    sizes for the tiles the block walks (any K).
//  * After the barrier the block's 256 threads apply its entries: atomicAdd
//    on unsigned long long (wrapping, as XLA's int64 add) for concurrency
//    and quota, atomicMax on signed long long for GCRA (the reference's
//    scatter-max; max is commutative and idempotent, so repeated rows
//    combine the same in any order).
// Tried for quota and not kept: lane groups of 4 and 16, and loads marked
// L2-only (__ldcg), read-only (__ldg) or streaming (__ldcs), none faster
// warm at K = 8192; the streaming loads were faster on cold rows, as the
// probe's are (lifecycle.cu), and slower warm, where quota's shared
// global and tenant rows are read again and again. Tried for GCRA and
// not kept: 16-byte lane pairs in place of the TAKEN word alone (PERF.md,
// cert_ab.py).
//
// Hazards, and what the design does about each:
//  * Every read sees the pre-batch state. Unlike take-n's, these inputs
//    may read a committing row from another column: quota paths share
//    tenant and global rows (and a row may be a tenant in one path and a
//    user in another), GCRA and concurrency columns may repeat a row, a
//    padding column may alias a live one, and a clamped row aliases
//    row B - 1. So no write reaches pn before every read of the call is
//    done: the grid barrier.
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
//  * Any N >= 1: a group's lanes past N load nothing and contribute the
//    identity (0 to a sum, LLONG_MIN to GCRA's max); a plane of more than
//    64 lanes takes more passes.
//
// C interface (ctypes): device pointers of contiguous int64 tensors; each
// launch returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kAdded = 0;
constexpr int kTaken = 1;

// The kernels' shape.
constexpr int kTile = 32;                  // columns a block takes at a time
constexpr int kGroup = 8;                  // a column's lane group
constexpr int kThreads = kTile * kGroup;
constexpr int kPass = 8;                   // lane loads a lane has in flight per row
constexpr int kMinBlocks = 2;              // blocks an SM: K = 8192 in one wave

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

// The grid barrier between reads and commits, split so that a block
// arrives as soon as its last tile's reads are done and runs its tails
// while the others arrive. One 32-bit word a stream, zero at first use
// (the wrapper's): block 0 adds 2^31 - (blocks - 1), every other block 1,
// so the arrivals together flip bit 31 and leave the low bits as they were
// (cooperative groups' scheme), and each block waits until bit 31 differs
// from what it saw when it arrived. A grid of one block needs only its
// __syncthreads. The atomic and the polling load are relaxed: the barrier
// orders reads before writes and carries no data (a block's spill entries
// are its own, ordered by __syncthreads), and every load of a block has
// returned its value before it arrives (its shuffles and the block barrier
// consume them), so no read can see a commit. At K = 8192 a release
// arrival with an acquiring poll measured 0.2-0.5 us slower a call,
// cooperative groups' grid sync 0.6-0.8 us, and a second launch for the
// commits in place of the barrier 1.5-1.7 us (PERF.md, cert_ab.py).
__device__ __forceinline__ void grid_arrive(unsigned* bar, unsigned& arrival) {
  if (gridDim.x > 1 && threadIdx.x == 0) {
    arrival = atomicAdd(bar, blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u);
  }
}

__device__ __forceinline__ void grid_wait(const unsigned* bar, unsigned arrival) {
  if (gridDim.x > 1 && threadIdx.x == 0) {
    unsigned now;
    do {
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(now) : "l"(bar) : "memory");
    } while (((now ^ arrival) & 0x80000000u) == 0);
  }
  __syncthreads();
}

// A block's commit entries: the first kCap in shared memory, the rest in
// the block's stretch of the global spill buffer. Warp 0 appends (in
// column order, by ballot); after the grid barrier the whole block applies
// them.
template <int kCap>
struct Entries {
  longlong2 smem[kCap];
  long long n;
};

// Warp 0: append each lane's entry (off >= 0) in lane order; n is the
// block's running count, the same in every lane of the warp.
template <int kCap>
__device__ __forceinline__ void append(Entries<kCap>& e, long long& n,
                                       longlong2* __restrict__ spill, long long off,
                                       long long val, int lane) {
  const unsigned live = __ballot_sync(kAll, off >= 0);
  if (off >= 0) {
    const long long pos = n + __popc(live & ((1u << lane) - 1u));
    const longlong2 ent = make_longlong2(off, val);
    if (pos < kCap) {
      e.smem[pos] = ent;
    } else {
      spill[pos - kCap] = ent;
    }
  }
  n += __popc(live);
}

// After every block's reads: the block's entries as wrapping adds, or
// (kMax, GCRA) as signed maxima.
template <bool kMax, int kCap>
__device__ __forceinline__ void commit(long long* pn, const Entries<kCap>& e,
                                       const longlong2* __restrict__ spill) {
  const long long n = e.n;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const longlong2 ent = i < kCap ? e.smem[i] : spill[i - kCap];
    if constexpr (kMax) {
      atomicMax(pn + ent.x, ent.y);
    } else {
      atomicAdd(reinterpret_cast<unsigned long long*>(pn + ent.x),
                (unsigned long long)ent.y);
    }
  }
}

// GCRA: packed (rows, now, T, tol, nreq) -> out (admitted, tat, own_tat,
// allow_at); the own TAKEN lane max-committed, in one cooperative launch.
constexpr int kGcraCap = kTile;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
gcra_admit_kernel(long long* pn, unsigned* bar, long long B, long long N,
                  long long slot,
                  const long long* __restrict__ packed, long long* __restrict__ out,
                  longlong2* __restrict__ spill, long long spill_len, long long K) {
  __shared__ long long s_max[kTile];
  __shared__ long long s_own[kTile];
  __shared__ Entries<kGcraCap> ents;

  const int t = threadIdx.x;
  const int c = t / kGroup;
  const int l = t % kGroup;
  const long long tiles = (K + kTile - 1) / kTile;
  longlong2* my_spill = spill + (long long)blockIdx.x * spill_len;
  long long n_ent = 0;  // warp 0's running count
  unsigned arrival = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long k0 = tile * kTile;
    const int live = (int)(K - k0 < kTile ? K - k0 : kTile);
    const bool own = t < live;  // column t's own thread
    const long long k = k0 + t;
    long long row = 0, now = 0, em = 0, tol = 0, nreq = 0;
    if (own) {
      row = packed[k];
      now = packed[K + k];
      em = packed[2 * K + k];
      tol = packed[3 * K + k];
      nreq = packed[4 * K + k];
    }
    // The group's row; only its TAKEN words are read. A lane past N
    // contributes LLONG_MIN, the identity of the max.
    const long long n_end = c < live ? N : 0;
    const long long* taken =
        pn + (c < live ? gather_row(packed[k0 + c], B) : 0) * N * 2 + kTaken;
    long long mx = LLONG_MIN, own_t = 0;
    for (long long base = l; base < n_end; base += kGroup * kPass) {
      long long x[kPass];
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const long long n = base + kGroup * j;
        x[j] = n < n_end ? taken[2 * n] : LLONG_MIN;
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        mx = lmax(mx, x[j]);
        if (base + kGroup * j == slot) own_t = x[j];
      }
    }
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) mx = lmax(mx, __shfl_xor_sync(kAll, mx, o));
    if (c < live) {
      if (l == 0) s_max[c] = mx;
      if (l == slot % kGroup) s_own[c] = own_t;
    }
    __syncthreads();
    if (tile + gridDim.x >= tiles) grid_arrive(bar, arrival);  // the block's reads are done
    if (t < 32) {  // warp 0: the tails
      long long adm = 0, new_own = 0;
      if (own) {
        const long long tat = s_max[t], own_tat = s_own[t];
        const long long base = lmax(tat, now);
        const long long deadline = wadd(now, tol);
        const bool conforms = tat <= deadline;
        const long long safe_t = em <= 0 ? 1 : em;
        const long long extras = floordiv64(lmax(wsub(deadline, base), 0), safe_t);
        adm = conforms ? wadd(1, extras) : 0;
        if (em <= 0) adm = 0;
        adm = clip0(adm, nreq);
        new_own = adm >= 1 ? wadd(base, wmul(adm, em)) : own_tat;
        const long long tat_out = lmax(tat, new_own);
        out[0 * K + k] = adm;
        out[1 * K + k] = tat_out;
        out[2 * K + k] = lmax(own_tat, new_own);
        out[3 * K + k] = wsub(tat_out, tol);
      }
      append(ents, n_ent, my_spill,
             own ? commit_off(row, B, N, slot, kTaken, adm >= 1) : -1, new_own, t);
    }
    __syncthreads();  // the reductions' shared memory is the next tile's
  }
  if (t == 0) ents.n = n_ent;
  grid_wait(bar, arrival);  // every read of the call is done
  commit<true>(pn, ents, my_spill);
}

// Concurrency: packed (rows, limit, count, nreq, releases) -> out
// (admitted, released, inflight, own_acquired, own_released, clamped); the
// own ADDED and TAKEN lanes added, in one cooperative launch.
constexpr int kConcCap = 2 * kTile;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
conc_admit_kernel(long long* pn, unsigned* bar, long long B, long long N,
                  long long slot,
                  const long long* __restrict__ packed, long long* __restrict__ out,
                  longlong2* __restrict__ spill, long long spill_len, long long K) {
  __shared__ unsigned long long s_sum[2][kTile];
  __shared__ long long s_own[2][kTile];
  __shared__ Entries<kConcCap> ents;

  const int t = threadIdx.x;
  const int c = t / kGroup;
  const int l = t % kGroup;
  const long long tiles = (K + kTile - 1) / kTile;
  longlong2* my_spill = spill + (long long)blockIdx.x * spill_len;
  long long n_ent = 0;  // warp 0's running count
  unsigned arrival = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long k0 = tile * kTile;
    const int live = (int)(K - k0 < kTile ? K - k0 : kTile);
    const bool own = t < live;  // column t's own thread
    const long long k = k0 + t;
    long long row = 0, limit = 0, count = 0, nreq = 0, releases = 0;
    if (own) {
      row = packed[k];
      limit = packed[K + k];
      count = packed[2 * K + k];
      nreq = packed[3 * K + k];
      releases = packed[4 * K + k];
    }
    // The lane group's row, loaded by the group itself in the same trip.
    const long long n_end = c < live ? N : 0;
    const longlong2* lanes = reinterpret_cast<const longlong2*>(
        pn + (c < live ? gather_row(packed[k0 + c], B) : 0) * N * 2);
    unsigned long long sa = 0, st = 0;
    long long own_a = 0, own_t = 0;
    for (long long base = l; base < n_end; base += kGroup * kPass) {
      longlong2 x[kPass];
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const long long n = base + kGroup * j;
        x[j] = n < n_end ? lanes[n] : make_longlong2(0, 0);
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        sa += (unsigned long long)x[j].x;
        st += (unsigned long long)x[j].y;
        if (base + kGroup * j == slot) {
          own_a = x[j].x;
          own_t = x[j].y;
        }
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
      if (l == slot % kGroup) {
        s_own[0][c] = own_a;
        s_own[1][c] = own_t;
      }
    }
    __syncthreads();
    if (tile + gridDim.x >= tiles) grid_arrive(bar, arrival);  // the block's reads are done
    if (t < 32) {  // warp 0: the tails
      long long d_rel = 0, d_acq = 0;
      if (own) {
        const long long sum_added = (long long)s_sum[0][t], sum_taken = (long long)s_sum[1][t];
        const long long own_added = s_own[0][t], own_taken = s_own[1][t];
        const long long want_rel = wmul(lmax(releases, 0), lmax(count, 0));
        const long long held_own = lmax(wsub(own_taken, own_added), 0);
        d_rel = lmin(want_rel, held_own);
        const long long inflight = wsub(sum_taken, wadd(sum_added, d_rel));
        const long long headroom = wsub(limit, inflight);
        const long long safe_count = count <= 0 ? 1 : count;
        long long adm = clip0(floordiv64(headroom, safe_count), nreq);
        if (count <= 0) adm = 0;
        d_acq = wmul(adm, count);
        out[0 * K + k] = adm;
        out[1 * K + k] = d_rel;
        out[2 * K + k] = wadd(inflight, d_acq);
        out[3 * K + k] = wadd(own_taken, d_acq);
        out[4 * K + k] = wadd(own_added, d_rel);
        out[5 * K + k] = wsub(want_rel, d_rel);
      }
      append(ents, n_ent, my_spill,
             own ? commit_off(row, B, N, slot, kAdded, d_rel != 0) : -1, d_rel, t);
      append(ents, n_ent, my_spill,
             own ? commit_off(row, B, N, slot, kTaken, d_acq != 0) : -1, d_acq, t);
    }
    __syncthreads();  // the sums' shared memory is the next tile's
  }
  if (t == 0) ents.n = n_ent;
  grid_wait(bar, arrival);  // every read of the call is done
  commit<false>(pn, ents, my_spill);
}

// Hierarchical quota: packed (rows_global, rows_tenant, rows_user,
// limit_global, limit_tenant, limit_user, count, nreq) -> out (admitted,
// three headrooms, own_taken_user); the own TAKEN lane of each level's row
// added, in one cooperative launch.
constexpr int kQuotaCap = 3 * kTile;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
quota_admit_kernel(long long* pn, unsigned* bar, long long B, long long N,
                   long long slot,
                   const long long* __restrict__ packed, long long* __restrict__ out,
                   longlong2* __restrict__ spill, long long spill_len, long long K) {
  __shared__ unsigned long long s_spend[3][kTile];
  __shared__ long long s_own[kTile];
  __shared__ Entries<kQuotaCap> ents;

  const int t = threadIdx.x;
  const int c = t / kGroup;
  const int l = t % kGroup;
  const long long tiles = (K + kTile - 1) / kTile;
  longlong2* my_spill = spill + (long long)blockIdx.x * spill_len;
  long long n_ent = 0;  // warp 0's running count
  unsigned arrival = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long k0 = tile * kTile;
    const int live = (int)(K - k0 < kTile ? K - k0 : kTile);
    const bool own = t < live;  // column t's own thread
    const long long k = k0 + t;
    long long rows[3] = {0, 0, 0}, lim[3] = {0, 0, 0}, count = 0, nreq = 0;
    if (own) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        rows[v] = packed[v * K + k];
        lim[v] = packed[(3 + v) * K + k];
      }
      count = packed[6 * K + k];
      nreq = packed[7 * K + k];
    }
    // The group's three rows; only their TAKEN words are read.
    const long long n_end = c < live ? N : 0;
    const long long* taken[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const long long r = c < live ? gather_row(packed[v * K + k0 + c], B) : 0;
      taken[v] = pn + r * N * 2 + kTaken;
    }
    unsigned long long spend[3] = {0, 0, 0};
    long long own_u = 0;
    for (long long base = l; base < n_end; base += kGroup * kPass) {
      long long x[3][kPass];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
#pragma unroll
        for (int j = 0; j < kPass; ++j) {
          const long long n = base + kGroup * j;
          x[v][j] = n < n_end ? taken[v][2 * n] : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
#pragma unroll
        for (int v = 0; v < 3; ++v) spend[v] += (unsigned long long)x[v][j];
        if (base + kGroup * j == slot) own_u = x[2][j];
      }
    }
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int v = 0; v < 3; ++v) spend[v] += __shfl_xor_sync(kAll, spend[v], o);
    }
    if (c < live) {
      if (l == 0) {
#pragma unroll
        for (int v = 0; v < 3; ++v) s_spend[v][c] = spend[v];
      }
      if (l == slot % kGroup) s_own[c] = own_u;
    }
    __syncthreads();
    if (tile + gridDim.x >= tiles) grid_arrive(bar, arrival);  // the block's reads are done
    if (t < 32) {  // warp 0: the tails
      long long d = 0;
      if (own) {
        const long long head_g = wsub(lim[0], (long long)s_spend[0][t]);
        const long long head_t = wsub(lim[1], (long long)s_spend[1][t]);
        const long long head_u = wsub(lim[2], (long long)s_spend[2][t]);
        const long long head_min = lmin(lmin(head_g, head_t), head_u);
        const long long safe_count = count <= 0 ? 1 : count;
        long long adm = clip0(floordiv64(head_min, safe_count), nreq);
        if (count <= 0) adm = 0;
        d = wmul(adm, count);
        out[0 * K + k] = adm;
        out[1 * K + k] = wsub(head_g, d);
        out[2 * K + k] = wsub(head_t, d);
        out[3 * K + k] = wsub(head_u, d);
        out[4 * K + k] = wadd(s_own[t], d);
      }
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        append(ents, n_ent, my_spill,
               own ? commit_off(rows[v], B, N, slot, kTaken, d != 0) : -1, d, t);
      }
    }
    __syncthreads();  // the sums' shared memory is the next tile's
  }
  if (t == 0) ents.n = n_ent;
  grid_wait(bar, arrival);  // every read of the call is done
  commit<false>(pn, ents, my_spill);
}

const void* fused_kernel(int family) {
  switch (family) {
    case 0: return reinterpret_cast<const void*>(gcra_admit_kernel);
    case 1: return reinterpret_cast<const void*>(conc_admit_kernel);
    case 2: return reinterpret_cast<const void*>(quota_admit_kernel);
    default: return nullptr;
  }
}

}  // namespace

// A family's kernel's residency: blocks an SM (the occupancy call, at its
// block size and static shared memory) and the SMs of the current device.
extern "C" int patrol_cert_occupancy(int family, int* blocks_per_sm, int* sms) {
  const void* fn = fused_kernel(family);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads, 0);
  }
  return (int)rc;
}

// One call (family 0: GCRA, 1: concurrency, 2: quota) as one cooperative
// launch of `blocks` blocks (cooperative: the runtime refuses a grid the
// card cannot hold resident, which the barrier needs); bar is the stream's
// barrier word; spill holds blocks x spill_len entries (int64 pairs).
extern "C" int patrol_cert_fused(int family, void* pn, void* bar, long long B, long long N,
                                 long long slot, const void* packed, void* out, void* spill,
                                 long long spill_len, long long K, int blocks, void* stream) {
  if (K <= 0) return 0;
  const void* fn = fused_kernel(family);
  if (fn == nullptr || blocks <= 0) return (int)cudaErrorInvalidValue;
  long long* p = (long long*)pn;
  unsigned* w = (unsigned*)bar;
  const long long* q = (const long long*)packed;
  long long* o = (long long*)out;
  longlong2* s = (longlong2*)spill;
  void* args[] = {&p, &w, &B, &N, &slot, &q, &o, &s, &spill_len, &K};
  const cudaError_t rc = cudaLaunchCooperativeKernel(fn, dim3((unsigned)blocks),
                                                     dim3(kThreads), args, 0,
                                                     (cudaStream_t)stream);
  return (int)(rc != cudaSuccess ? rc : cudaGetLastError());
}
