// The idle-reactivation recurrence of the dense ingest (kernel K3).
//
// Replaces no TPU kernel: the JAX package applies an op batch with a
// lax.scan over its rows (dmclock_tpu/engine/kernels.py ingest), one
// row a scan step, which XLA keeps on the TPU.  The port applies the
// batch in one fixed-shape pass of dense tensor ops
// (dmclock_tpu_torch/engine/kernels.py _ingest_dense); the one part of
// the scan that is a true recurrence along the rows is left to this
// kernel.  An ADD to an idle client (reference dmclock_server.h:937-985)
// shifts its proportion tags by (lowest - t), where lowest is the least
// effective proportion tag among the clients scheduling at that moment,
// and once it is in, the client's own tag joins that set for the rows
// after it.  The pass computes, for each reactivating row k (in row
// order), every input that does not depend on an earlier reactivation:
//
//   rows[0][k]  m     least tag of the clients whose status is fixed
//                     without the recurrence (KEY_INF if none)
//   rows[1][k]  any0  1 if there is at least one such client
//   rows[2][k]  base  the row's new head proportion tag
//   rows[3][k]  pd0   its prop_delta if it does not shift
//   rows[4][k]  act   1 if the client is active (it then joins the set)
//   rows[5][k]  t     the arrival time
//   rows[6][k]  end   the first reactivating row at which the client
//                     has left the set again (a CREATE of its slot later
//                     in the batch), count if never
//
// and the recurrence over the rows k < count, in order, is
//
//   low  = min(m, the joined tags live at k);  any = any0 || one is live
//   pd   = (any && low < LOWEST_PROP_TAG_TRIGGER) ? low - t : pd0
//   out[k] = pd;  if act: join base + pd, live for k < k' < end
//
// in int64 arithmetic that wraps as it does on the device and in the
// JAX package (low - t and base + pd in unsigned long long, cast back;
// the minimum is signed).
//
// Design: a block-parallel scan, each row checked, a serial remainder.
// Which tags are live at a row does not depend on any value: after j0
// (the first row whose tag joins for good, end >= count) any holds at
// every row, and before L (the first row at which a tag that leaves
// again is live: one row past the first act row with k + 1 < end <
// count) the live tags fold into one running minimum P.  Each row's
// step of P is then a min-plus map x -> min(x + a, b): a row whose tag
// joins for good and shifts (c = base - t) maps P to
// min(P + min(0, c), m + c), one that joins and does not shift to
// min(P, base + pd0), every other row is the identity.  Such maps
// compose associatively ((a1, b1) then (a2, b2) is (a1 + a2,
// min(b1 + a2, b2))), so P is a prefix scan.  P never rises, so a row
// shifts when any && m < TRIGGER until P first drops below the trigger
// (row kt) and when any from there on: each tile is scanned with the
// maps of the regime before the crossing, and the one tile in which P
// crosses is scanned again with kt known.  The scan runs in __int128,
// which cannot wrap at these magnitudes, so it agrees with the int64
// recurrence only where that does not wrap either; every row is
// therefore checked in parallel: its step recomputed in the int64
// arithmetic above from the scanned P_k must give the scanned P_{k+1}.
// F is the first row that fails.  By induction every row before
// min(F, L) is exact, and so is P at min(F, L); from there one thread
// walks the remaining rows in order, as the recurrence reads.
//
// On the card: one block of kThreads threads (no cross-block handshake;
// a batch holds at most the 16,384 slots of a queue, 0.9 MB of input,
// which one SM reads in a few microseconds), tiles of kTile rows in
// order.  Each thread loads its kRows consecutive rows' seven fields
// into registers at once (28 independent loads in flight, one memory
// latency a tile), finds with the block the tile's first rows of j0 and
// L, composes its rows' maps, and a warp scans its lanes' maps with
// __shfl_up_sync (each __int128 as two 64-bit halves), the first warp
// the warps' totals through shared memory; the rescan and the check
// reuse the rows in registers.  The walk stages kChunk rows at a time
// into shared memory, coalesced, loads the next row's fields into
// registers while the current row's chain runs, and keeps the live
// tags that leave again in shared memory where they fit (kListCap;
// else in the workspace), with their least tag and earliest end cached,
// so a row scans the list only when a tag has left.
//
// Bounds at the two real inputs (H100 SXM, 3.35 TB/s): the cluster wave
// (10,000 rows, every one reactivating) reads 56 bytes and writes 8 a
// row, 0.64 MB or 0.19 us; the queue flush (124 reactivating rows of
// 1,024) 0.002 us; below both lies the launch floor of about 1 us.  The
// serial chain (6 dependent int64 steps a row, about 24 ns) now bounds
// only the remainder: none of the cluster wave's rows, 113 of the queue
// flush's (its first tag that leaves is live at row 11).
//
// Plain C interface, loaded with ctypes (dmclock_tpu_torch/engine/_ext.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef __int128 i128;

constexpr long long kKeyInf = 0x7fffffffffffffffLL;
// LOWEST_PROP_TAG_TRIGGER = MAX_TAG // 2, MAX_TAG = 2^62
constexpr long long kTrigger = 1LL << 61;
constexpr int kFields = 7;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // consecutive rows a thread of a tile
constexpr int kTile = kThreads * kRows;
constexpr int kChunk = 256;              // rows the walk stages at a time
constexpr int kListCap = 1536;           // leaving tags kept in shared memory

__device__ __forceinline__ long long wrap_sub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

// x -> min(x + a, b); the identity's b lies past any value the scan
// reaches (|a| < 2^76 within a tile, |b| < 2^66)
struct Map {
  i128 a, b;
};

__device__ __forceinline__ Map ident() {
  return {0, static_cast<i128>(1) << 120};
}

// f, then g
__device__ __forceinline__ Map compose(const Map& f, const Map& g) {
  const i128 t = f.b + g.a;
  return {f.a + g.a, t < g.b ? t : g.b};
}

__device__ __forceinline__ i128 apply(const Map& f, i128 x) {
  const i128 t = x + f.a;
  return t < f.b ? t : f.b;
}

__device__ __forceinline__ i128 shfl_up(i128 x, int d) {
  const unsigned long long lo = __shfl_up_sync(
      0xffffffffu, static_cast<unsigned long long>(x), d);
  const unsigned long long hi = __shfl_up_sync(
      0xffffffffu, static_cast<unsigned long long>(x >> 64), d);
  return static_cast<i128>((static_cast<unsigned __int128>(hi) << 64) | lo);
}

// a row as the scan reads it: perm, its tag joins for good (act, end >=
// count); leave, its tag joins and leaves again (act, k + 1 < end <
// count)
struct Row {
  long long m, base, pd0, t;
  bool a0, perm, leave;
};

__device__ __forceinline__ Row load_row(const long long* __restrict__ rows,
                                        int b, int k, int n) {
  Row r;
  r.m = rows[k];
  r.a0 = rows[b + k] != 0;
  r.base = rows[2LL * b + k];
  r.pd0 = rows[3LL * b + k];
  const bool act = rows[4LL * b + k] != 0;
  r.t = rows[5LL * b + k];
  const long long e = rows[6LL * b + k];
  r.perm = act && e >= n;
  r.leave = act && e < n && e > k + 1;
  return r;
}

// row k's step of P as a map (regime: P below the trigger from row kt)
__device__ __forceinline__ Map row_map(const Row& r, int k, int j0, int kt) {
  if (!r.perm) return ident();
  if ((r.a0 || k > j0) && (r.m < kTrigger || k >= kt)) {
    const i128 c = static_cast<i128>(r.base) - r.t;
    return {c < 0 ? c : 0, r.m + c};
  }
  return {0, wrap_add(r.base, r.pd0)};
}

// row k in the recurrence's int64 from P = p: its pd, and P after it
__device__ __forceinline__ long long real_step(const Row& r, int k, int j0,
                                               long long p,
                                               long long* pd_out) {
  const long long low = r.m < p ? r.m : p;
  const long long pd =
      ((r.a0 || k > j0) && low < kTrigger) ? wrap_sub(low, r.t) : r.pd0;
  *pd_out = pd;
  if (r.perm) {
    const long long v = wrap_add(r.base, pd);
    return v < p ? v : p;
  }
  return p;
}

// the least u and the least v over the block (every thread calls it)
__device__ __forceinline__ void block_min2(int& u, int& v, int (*red)[kWarps]) {
  u = __reduce_min_sync(0xffffffffu, u);
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = u;
    red[1][threadIdx.x >> 5] = v;
  }
  __syncthreads();
  u = red[0][0];
  v = red[1][0];
  for (int w = 1; w < kWarps; ++w) {
    u = red[0][w] < u ? red[0][w] : u;
    v = red[1][w] < v ? red[1][w] : v;
  }
  __syncthreads();
}

// each thread's exclusive prefix of the block's maps, in thread order,
// and their total (every thread calls it)
__device__ __forceinline__ Map block_scan(Map v, Map* total, i128* sa,
                                          i128* sb) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const Map o = {shfl_up(v.a, d), shfl_up(v.b, d)};
    if (lane >= d) v = compose(o, v);
  }
  Map ex = {shfl_up(v.a, 1), shfl_up(v.b, 1)};
  if (lane == 0) ex = ident();
  if (lane == 31) {
    sa[w] = v.a;
    sb[w] = v.b;
  }
  __syncthreads();
  if (w == 0) {
    Map s = lane < kWarps ? Map{sa[lane], sb[lane]} : ident();
    for (int d = 1; d < 32; d <<= 1) {
      const Map o = {shfl_up(s.a, d), shfl_up(s.b, d)};
      if (lane >= d) s = compose(o, s);
    }
    if (lane < kWarps) {
      sa[lane] = s.a;
      sb[lane] = s.b;
    }
  }
  __syncthreads();
  *total = {sa[kWarps - 1], sb[kWarps - 1]};
  return w == 0 ? ex : compose(Map{sa[w - 1], sb[w - 1]}, ex);
}

__global__ void __launch_bounds__(kThreads)
ingest_scan_kernel(const long long* __restrict__ rows,
                   const long long* __restrict__ count,
                   long long* __restrict__ out, long long* __restrict__ ws,
                   long long* __restrict__ info, int b) {
  __shared__ i128 sa[kWarps], sb[kWarps], p_fail;
  __shared__ int red[2][kWarps];
  __shared__ long long in[kFields][kChunk];
  __shared__ long long list_v[kListCap], list_e[kListCap];
  long long cnt = *count;
  cnt = cnt > b ? b : cnt;
  const int n = static_cast<int>(cnt < 0 ? 0 : cnt);

  // the scan, a tile at a time: carry = P at the tile's first row; j0
  // and jl (the first act row whose tag leaves again) n until a tile
  // holds them, lim = L; kt = n + 1 until P crosses the trigger; s =
  // min(F, L)
  int j0 = n, jl = n, lim = n, kt = n + 1, s = n;
  i128 carry = kKeyInf;
  for (int t0 = 0; t0 < lim; t0 += kTile) {
    const int r0 = t0 + threadIdx.x * kRows;
    Row rw[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      rw[j] = load_row(rows, b, r0 + j < n ? r0 + j : n - 1, n);
    int p0 = n, pl = n;
#pragma unroll
    for (int j = kRows - 1; j >= 0; --j) {
      if (r0 + j < n && rw[j].perm) p0 = r0 + j;
      if (r0 + j < n && rw[j].leave) pl = r0 + j;
    }
    block_min2(p0, pl, red);
    j0 = j0 < p0 ? j0 : p0;
    if (pl < n) {
      jl = pl;
      lim = pl + 1;
    }
    Map ex, tot;
    for (int pass = 0; pass < 2; ++pass) {
      Map loc = ident();
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < lim) loc = compose(loc, row_map(rw[j], r0 + j, j0, kt));
      ex = block_scan(loc, &tot, sa, sb);
      if (kt <= n || apply(tot, carry) >= kTrigger) break;
      // P crosses the trigger in this tile: find the row, scan again
      i128 x = apply(ex, carry);
      int cand = n, unused = n;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (r0 + j >= lim || cand < n) continue;
        x = apply(row_map(rw[j], r0 + j, j0, kt), x);
        if (x < kTrigger) cand = r0 + j + 1;
      }
      block_min2(cand, unused, red);
      kt = cand;
    }
    // each row: its pd from the scanned P_k, and the check of P_{k+1}
    i128 x = apply(ex, carry);
    int fail = n, unused = n;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int k = r0 + j;
      if (k >= lim || fail < n) continue;
      const i128 xn = apply(row_map(rw[j], k, j0, kt), x);
      long long pd;
      const long long p1 =
          real_step(rw[j], k, j0, static_cast<long long>(x), &pd);
      out[k] = pd;
      if (static_cast<i128>(p1) != xn) {
        fail = k;
      } else {
        x = xn;
      }
    }
    const int mine = fail;
    block_min2(fail, unused, red);
    if (fail < n) {
      if (mine == fail) p_fail = x;
      __syncthreads();
      carry = p_fail;
      s = fail;
      break;
    }
    carry = apply(tot, carry);
  }
  s = s < lim ? s : lim;
  if (info != nullptr && threadIdx.x == 0) {
    info[0] = s;
    info[1] = s == lim ? lim : n;
    info[2] = kt <= s ? kt : n;
  }
  if (s >= n) return;

  // the serial remainder from row s: thread 0 walks, the block stages.
  // The carry: P, whether a tag joined for good, and the live tags that
  // leave again (the first act row's, when the scan stopped at L), with
  // their least tag and earliest end
  long long low_p = static_cast<long long>(carry);
  bool any_p = j0 < s;
  const bool in_shared = n - s + 1 <= kListCap;
  long long* lv = in_shared ? list_v : ws;
  long long* le = in_shared ? list_e : ws + b;
  int nf = 0;
  long long lmin = kKeyInf, lnext = kKeyInf;
  if (threadIdx.x == 0 && s == lim) {
    lmin = lv[0] = wrap_add(rows[2LL * b + jl], out[jl]);
    lnext = le[0] = rows[6LL * b + jl];
    nf = 1;
  }
  for (int c0 = s; c0 < n; c0 += kChunk) {
    const int len = n - c0 < kChunk ? n - c0 : kChunk;
    for (int f = 0; f < kFields; ++f)
      for (int i = threadIdx.x; i < len; i += kThreads)
        in[f][i] = rows[static_cast<long long>(f) * b + c0 + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      long long m = in[0][0], a0 = in[1][0], base = in[2][0],
                pd0 = in[3][0], act = in[4][0], t = in[5][0],
                e = in[6][0];
      for (int i = 0; i < len; ++i) {
        // the next row's fields, loaded while this row's chain runs
        const int nx = i + 1 < len ? i + 1 : i;
        const long long m2 = in[0][nx], a02 = in[1][nx], base2 = in[2][nx],
                        pd02 = in[3][nx], act2 = in[4][nx], t2 = in[5][nx],
                        e2 = in[6][nx];
        const long long k = c0 + i;
        if (k >= lnext) {
          // a tag has left: keep the live ones
          int kept = 0;
          lmin = lnext = kKeyInf;
          for (int j = 0; j < nf; ++j) {
            const long long ej = le[j];
            if (ej > k) {
              const long long v = lv[j];
              lv[kept] = v;
              le[kept] = ej;
              ++kept;
              lmin = v < lmin ? v : lmin;
              lnext = ej < lnext ? ej : lnext;
            }
          }
          nf = kept;
        }
        long long low = m < low_p ? m : low_p;
        low = lmin < low ? lmin : low;
        long long pd = pd0;
        if ((a0 != 0 || any_p || nf > 0) && low < kTrigger)
          pd = wrap_sub(low, t);
        out[k] = pd;
        if (act != 0) {
          const long long v = wrap_add(base, pd);
          if (e >= n) {
            low_p = v < low_p ? v : low_p;
            any_p = true;
          } else if (e > k + 1) {
            lv[nf] = v;
            le[nf] = e;
            ++nf;
            lmin = v < lmin ? v : lmin;
            lnext = e < lnext ? e : lnext;
          }
        }
        m = m2, a0 = a02, base = base2, pd0 = pd02, act = act2, t = t2;
        e = e2;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// rows: int64[7, b]; count: int64[] (the rows to scan, read on the
// device); out: int64[b] (rows past count untouched); ws: int64[2, b]
// (the leaving tags where they outgrow shared memory); info: NULL or
// int64[3], which receives min(F, L), L if the scan stopped there, and
// the row at which P crossed the trigger if it did by min(F, L) (each
// count otherwise).
extern "C" int ingest_scan_launch(const void* rows, const void* count,
                                  void* out, void* ws, void* info, int b,
                                  void* stream) {
  if (b < 0) return static_cast<int>(cudaErrorInvalidValue);
  ingest_scan_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(rows),
      static_cast<const long long*>(count), static_cast<long long*>(out),
      static_cast<long long*>(ws), static_cast<long long*>(info), b);
  return static_cast<int>(cudaGetLastError());
}
