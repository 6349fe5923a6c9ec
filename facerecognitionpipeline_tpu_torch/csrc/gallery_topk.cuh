// Streaming cosine top-k against a large gallery: the body shared by kernel
// K3 on bf16 rows (gallery_topk.cu), K3 on float32 rows (gallery_topk_f32.cu)
// and kernel K4 (int8 codes, gallery_topk_int8.cu), the kernels that merge
// their partial results, and the long lists' pool route with its selects.
//
// What is computed: for each of Q query rows, the `k` best of G gallery rows
// by (score descending, row index ascending), where a row's score is its dot
// product with the query and rows whose `valid` byte is 0 never compete.
// Slots that no valid row fills hold the sentinel (-1e9, index 0). The [Q, G]
// score matrix is never written to device memory, and the gallery is read
// from device memory once per query tile (once in all for K4 at Q <= 128).
//
// What bounds it on an H100: the gallery's bytes for bf16 and int8 rows (one
// read of 1 GB in bf16 or 0.5 GB in int8 at a million rows), float32
// operations on the CUDA cores for float32 rows (2 * Q * G * D FMAs: 2.05 ms
// at 128 x 1 048 576 x 512 against 0.64 ms of bytes). So, per block (one
// per SM, persistent, 384 threads):
//   * block (x, y) owns query tile y and every gridDim.x-th gallery tile of
//     TM = 64 rows starting at tile x. Its queries are written once into
//     shared memory in the 128-byte swizzled, K-major layout of the gallery
//     stages: K4 query rows 0-63 and 64-127 (int8 codes) as two wgmma A
//     blocks; K3 the hi and the lo bf16 part of its 64 queries as two A
//     blocks; float32 rows their 64 float32 queries, 32 floats per panel;
//   * one producer warp keeps two rings of 8 KB stages full, one per consumer
//     warpgroup, feeding whichever has a free stage (a warpgroup that is
//     folding holds back only its own ring). A stage is one K-panel (64
//     gallery rows x 128 bytes of depth: 64 bf16, 128 int8 or 32 float32
//     values) brought by one TMA tensor copy that completes on the stage's
//     `full` mbarrier; a tile is D*sizeof(T)/128 consecutive stages of the
//     ring of the warpgroup that takes it. The tile's valid bytes and row
//     scales ride on its first stage's barrier as plain bulk copies (a
//     ragged last tile: ordinary loads). Depth and rows past the gallery's
//     edge arrive as zeros from the tensor map;
//   * two consumer warpgroups take the block's tiles in turn. For bf16 and
//     int8 each starts wgmma.mma_async m64n64 per 32 bytes of depth with a
//     block of 64 query rows as A and the 64 gallery rows as B (K4: two
//     query blocks into two accumulators; K3: hi then lo into one, so the
//     sum of the two parts is the accumulator's own) and hands a stage back
//     through its `empty` mbarrier as soon as the products that read it
//     have completed. For float32 rows a thread computes 32 scores (4
//     queries x 8 rows) with float32 FMAs read straight from the stage, 4
//     depths per 16-byte load, hands the stage back when its warp is done
//     with it, and after the tile trades half its scores with another lane
//     so that it holds what the wgmma accumulator would (F32Traits). Then
//     the warpgroup folds its accumulators while the other one multiplies;
//   * the fold never leaves registers. With the queries as A, a query row
//     belongs to one quad of lanes of one warp: a thread holds 16 of the
//     tile's 64 scores for each of its queries. It applies the row scale,
//     compares with the query's threshold in shared memory (the best k-th
//     score either warpgroup has so far) and masks with valid: 16 bits per
//     query, no branch, one ballot per tile. Only a score at or above the
//     threshold is offered to the warpgroup's top-k list of that query. The
//     threshold is a filter only: every list comparison is the strict total
//     order below, so a stale or lost threshold update lets more through
//     and changes no result;
//   * where the list lives depends on its length (`list_length`, and
//     ops/gallery_kernel.py with the same rule). Up to 8 entries it is read
//     into registers and every candidate put in place by straight-line
//     code; 16 entries live in shared memory (a binary search for the
//     place, a shift behind it), offered to by the four lanes of the quad in
//     turn. Longer lists (KL == DEVICE_LISTS: any k up to KMAX) live in
//     device memory (below the pool route's first k, and its unresolved
//     queries), one sorted list of k entries per query and warpgroup,
//     owned by the one warp that folds that query. The fold appends what
//     passes the threshold to a buffer of BUF entries per query in shared
//     memory; when a buffer fills, and once at the end, the owning warp
//     sorts it (a bitonic sort over its 32 lanes), merges it into the list
//     from the top down in chunks of 32 x FLUSH_U entries (each entry moves
//     by the number of candidates that precede it, each candidate lands
//     between the two entries that bracket it; all 32 lanes at once, and
//     the merge stops at the first entry nothing precedes), and raises the
//     threshold to the list's k-th value. No lane ever shifts a list entry
//     by entry;
//   * at the end, short lists: a block merges the two warpgroups' sorted
//     lists per query (two cursors) and writes one list to scratch [Q,
//     gridDim.x, list length]; `merge_topk_kernel` folds a query's
//     gridDim.x sorted lists with one block (a thread holds the head of one
//     list; the block picks the best head k times). Lists in device memory
//     are already in scratch [Q, 2 gridDim.x, k] (one per block and
//     warpgroup, padded with sentinels); `merge_lists_kernel` merges a
//     query's lists pairwise in a fixed tree, one warp per pair, each pair
//     by merge path (a lane finds where its outputs start by a binary
//     search on the diagonal, then takes them in order).
// Every comparison uses the same strict total order (value descending, then
// index ascending; gallery indices are unique), so the result does not
// depend on the order blocks, warpgroups or warps ran in, and ties go to the
// lower index.
//
// Long lists, from k = ops/gallery_kernel.py's POOL_MIN_K (the pool route,
// `launch_pool_topk`; the wrapper owns its rule and passes the sample, rank,
// pool capacity and query blocks as launch arguments). A
// list per (query, block, warpgroup) sees 1/132 or 1/264 of the gallery and
// filters nothing until it holds k entries, and every candidate costs O(k)
// list moves, so the device lists lose to a stored product from k ~ 256. The
// pool route makes the threshold per query and valid across the whole
// gallery before the full pass, in four stages, and no step depends on k per
// candidate:
//   1. sample: the stream kernel (SAMPLE) scores `walk` whole tiles spread
//      evenly over the gallery (tile lt * n_tiles / walk: galleries are
//      stored in enrolment order, so never a prefix) and writes every score
//      (-inf for an invalid row) to [Q, walk * TM]; `sample_threshold_kernel`
//      takes T_q, the rank-th best of them (rank about twice the sampled rows
//      expected above the k-th score, so about 2k rows pass), and zeroes the
//      query's cursor. The sample is scored by the same instructions as the
//      gather pass, so both see the same bits;
//   2. gather: the stream kernel (GATHER) starts each query's threshold at
//      T_q and never raises it; what passes goes through the 32-entry
//      buffers of the device lists and, when one fills, into the query's pool
//      [Q, cap] in device memory at places one atomicAdd on its cursor
//      reserves. The cursor counts what lies past the capacity too; nothing
//      is sorted or merged;
//   3. select (`select_pool_kernel`, a block per query): with n_q pooled and
//      k <= n_q <= cap (or n_q <= cap and T_q = -inf: the pool holds every
//      valid row), the k best of the pool by the 64-bit key (the score's
//      order-preserving bits, then the inverted index): a radix select for
//      the k-th value (and, where ties straddle it, for the cut among their
//      indices), the k chosen sorted bitonically in shared memory, written
//      in order with `q_scale` as the merges do. The pool's order depends on
//      which block appended first; the result does not: the atomics only
//      reserve places, every comparison is the strict total order;
//   4. unresolved queries (n_q < k with T_q above -inf: the sample's
//      threshold was too high; n_q > cap: too low) take the device lists,
//      masked per query: the select kernel leaves them a starting threshold
//      (T_q when n_q >= k, which is then at or below the k-th score; else
//      -1e9) and +inf to the resolved ones, a block whose query tile holds
//      none leaves before it streams, and the merge skips resolved queries.
//      That route runs on a quarter of the gather's blocks so its lists
//      take a quarter of the device-list route's scratch. The decision is read on the device: no
//      host synchronisation, so a search inside a captured CUDA graph stays
//      capturable. Unresolved queries are added to a counter in device
//      memory.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace frp {

constexpr int SMEM_LIMIT = 232448;    // shared memory one block may use (H100)
// longest top-k the kernels answer: the merge of lists in device memory
// keeps a pair of lists of k (16 k bytes) in one warp's shared memory, so k
// is at most SMEM_LIMIT / 16, rounded down to whole 32-entry lane chunks
// (14 528; ops/gallery_kernel.py::MAX_TOP_K, the same rule)
constexpr int KMAX = SMEM_LIMIT / 16 / 32 * 32;
constexpr int KREG = 8;               // longest list offered to in registers
constexpr int KSHARED = 16;           // longest list kept in shared memory
constexpr int DEVICE_LISTS = 0;       // list length that means: device memory
// the stream kernel's two modes of the pool route (in place of a length)
constexpr int SAMPLE = -1;            // every score of the walked tiles, out
constexpr int GATHER = -2;            // what passes T_q, into the query's pool
constexpr int SELECT_THREADS = 1024;  // a select block
constexpr int RADIX_BINS = 2048;      // digits of 11, 11 and 10 bits
constexpr int SAMPLE_CANDS = 4096;    // sampled keys T_q's select sorts, at most
constexpr int BUF = 32;               // candidates buffered per query (device lists)
constexpr int FLUSH_U = 4;            // list entries per lane per merge chunk
constexpr int TM = 64;                // gallery rows per tile (wgmma N)
constexpr int PANEL_BYTES = 128;      // depth bytes per stage: one swizzle row
constexpr int STAGE_BYTES = TM * PANEL_BYTES;    // 8 KB of gallery
constexpr int QBLOCK_BYTES = 64 * PANEL_BYTES;      // one A block of a panel
constexpr int SIDE_BYTES = TM + TM * 4;  // a tile's valid bytes, then scales
constexpr int CONSUMER_WGS = 2;       // consumer warpgroups
constexpr int THREADS = 384;          // and the producer's warpgroup
constexpr int MIN_STAGES = 4;         // in all: an even count, half per ring
constexpr int MAX_STAGES = 16;
constexpr float NEG = -1e9f;          // score of a masked row, and the sentinel
constexpr float INF = __builtin_huge_valf();
constexpr int ENCODE_FAILED = 100000; // + CUresult: the tensor map was refused

__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// v[t] of a thread's 16 scores by a tree of selects (a register array takes
// no run-time index).
__device__ __forceinline__ float pick16(const float (&v)[16], int t) {
  float a8[8], a4[4];
#pragma unroll
  for (int u = 0; u < 8; ++u) a8[u] = (t & 1) ? v[2 * u + 1] : v[2 * u];
#pragma unroll
  for (int u = 0; u < 4; ++u) a4[u] = (t & 2) ? a8[2 * u + 1] : a8[2 * u];
  const float b0 = (t & 4) ? a4[1] : a4[0];
  const float b1 = (t & 4) ? a4[3] : a4[2];
  return (t & 8) ? b1 : b0;
}

// Offer a thread's candidates for one query (bit t of `pm`: score v[t], row
// i0 + 8 (t / 2) + t % 2) to a warpgroup's list of that query in shared
// memory (KL entries, best first), then raise the query's threshold to the
// list's last value. The other warpgroup may write the threshold at the same
// time: either value is a KL-th best of real rows, so either is a sound
// filter. Up to KREG entries the list is read into registers once, every
// candidate put in its place there, and the list written back; longer lists
// stay in shared memory (only this lane touches them in its turn).
template <int KL>
__device__ __forceinline__ void list_offer(float* lv, int* li,
                                           volatile float* thr, unsigned pm,
                                           const float (&v)[16], int i0) {
  const float seen = *thr;
  if constexpr (KL <= KREG) {
    float tv[KL];
    int ti[KL];
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      tv[j] = lv[j];
      ti[j] = li[j];
    }
    while (pm != 0) {
      const int t = __ffs(pm) - 1;
      pm &= pm - 1;
      const float cv = pick16(v, t);
      const int ci = i0 + 8 * (t >> 1) + (t & 1);
      if (!before(cv, ci, tv[KL - 1], ti[KL - 1])) continue;  // behind the last
      // its place: behind the entries that precede it (the list is sorted)
      int pos = 0;
#pragma unroll
      for (int j = 0; j < KL; ++j) pos += before(tv[j], ti[j], cv, ci) ? 1 : 0;
#pragma unroll
      for (int j = KL - 1; j > 0; --j) {
        tv[j] = j < pos ? tv[j] : (j == pos ? cv : tv[j - 1]);
        ti[j] = j < pos ? ti[j] : (j == pos ? ci : ti[j - 1]);
      }
      tv[0] = pos > 0 ? tv[0] : cv;
      ti[0] = pos > 0 ? ti[0] : ci;
    }
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      lv[j] = tv[j];
      li[j] = ti[j];
    }
    if (tv[KL - 1] > seen) *thr = tv[KL - 1];
  } else {
    while (pm != 0) {
      const int t = __ffs(pm) - 1;
      pm &= pm - 1;
      const float cv = pick16(v, t);
      const int ci = i0 + 8 * (t >> 1) + (t & 1);
      if (!before(cv, ci, lv[KL - 1], li[KL - 1])) continue;
      // the first entry it precedes (the list is sorted, so the test is
      // false up to that entry and true from it on)
      int lo = 0, hi = KL - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(cv, ci, lv[mid], li[mid])) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      for (int j = KL - 1; j > lo; --j) {
        lv[j] = lv[j - 1];
        li[j] = li[j - 1];
      }
      lv[lo] = cv;
      li[lo] = ci;
    }
    const float last = lv[KL - 1];
    if (last > seen) *thr = last;
  }
}

// The fold of one tile out of a warpgroup's accumulators: register 4 j + e
// + 2 h of accumulator a is query row 64 a + qrow + 8 h against gallery row
// i0 + 8 j + e (the wgmma m64n64 layout; the float32 kernel computes its
// scores in the same places). First every query of the thread (slot 2 a + h)
// against its threshold: 16 bits each, no branch. Rare: some score passed.
// The four lanes of a quad share their queries' lists, so they take turns;
// in its turn a lane offers what it has for each of its queries, while the
// other quads do the same for theirs.
template <typename Tr, int KL>
__device__ __forceinline__ void fold_tile(
    const typename Tr::Acc (&d)[Tr::ACCS][32], const float (&sc)[16],
    unsigned vmask, float* thr, float* my_v, int* my_i, int qrow, int i0,
    int lane) {
  constexpr int ACCS = Tr::ACCS;
  unsigned pm[2 * ACCS];
  unsigned any = 0;
#pragma unroll
  for (int a = 0; a < ACCS; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float bar =
          *reinterpret_cast<volatile float*>(thr + 64 * a + qrow + 8 * h);
      unsigned bits = 0;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float v = Tr::score(d[a][4 * (t >> 1) + (t & 1) + 2 * h], sc[t]);
        bits |= (v >= bar ? 1u : 0u) << t;
      }
      pm[2 * a + h] = bits & vmask;
      any |= pm[2 * a + h];
    }
  }
  const unsigned m = __ballot_sync(0xffffffffu, any != 0);
  if (m == 0) return;
  unsigned turns = m | (m >> 16);  // bit t: lane t of some quad
  turns |= turns >> 8;
  turns = (turns | (turns >> 4)) & 0xFu;
  while (turns != 0) {  // the whole warp
    const int turn = __ffs(turns) - 1;
    turns &= turns - 1;
    if ((lane & 3) == turn) {
#pragma unroll
      for (int a = 0; a < ACCS; ++a) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (pm[2 * a + h] == 0) continue;
          const int q = 64 * a + qrow + 8 * h;
          float v[16];
#pragma unroll
          for (int t = 0; t < 16; ++t)
            v[t] = Tr::score(d[a][4 * (t >> 1) + (t & 1) + 2 * h], sc[t]);
          list_offer<KL>(my_v + q * KL, my_i + q * KL, thr + q, pm[2 * a + h],
                         v, i0);
        }
      }
    }
    __syncwarp();
  }
}

// The two warpgroups' sorted lists of query row r ([2][qt][KL] in shared
// memory) -> the block's KL best, in order, at part_v / part_i + at.
template <int KL>
__device__ __forceinline__ void write_block_list(const float* lv, const int* li,
                                                 int qt, int r, float* part_v,
                                                 int* part_i, long long at) {
  const float* av = lv + r * KL;
  const int* ai = li + r * KL;
  const float* bv = lv + (qt + r) * KL;
  const int* bi = li + (qt + r) * KL;
  int a = 0, b = 0;  // a + b = j < KL, so neither runs past its list
  for (int j = 0; j < KL; ++j) {
    const bool take_b = before(bv[b], bi[b], av[a], ai[a]);
    part_v[at + j] = take_b ? bv[b] : av[a];
    part_i[at + j] = take_b ? bi[b] : ai[a];
    if (take_b) {
      ++b;
    } else {
      ++a;
    }
  }
}

// ---- lists in device memory ------------------------------------------------

// What the warps of one warpgroup need to reach their lists in device memory:
// the candidate buffers [QT][BUF] (values, indices), their fill counts [QT]
// and the lists' real entries [QT] in shared memory; the list of query row r
// (of the block's tile) at lv / li + r * stride, k entries, sorted.
struct DevLists {
  float* bv;
  int* bi;
  int* count;
  int* fill;
  float* lv;
  int* li;
  long long stride;
  int k;
};

// Number of the first n sorted candidates (sv, si) that precede (v, i).
__device__ __forceinline__ int count_before(const float* sv, const int* si,
                                            int n, float v, int i) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(sv[mid], si[mid], v, i)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Merge query row r's buffered candidates into its list in device memory;
// the whole warp, r the same in every lane. The buffer is sorted across the
// 32 lanes (bitonic), written back in order, and the list rewritten from the
// top down in chunks of 32 x FLUSH_U entries: entry i (a sentinel from the
// list's fill on) moves to i + c_i, c_i the number of candidates that
// precede it, and candidates c_{i-1} .. c_i - 1 land at i + j. A chunk is
// read whole before any lane writes (the lanes trade c by shuffles, which
// wait for every lane's reads), and writes only at or above its own lowest
// position, which every chunk above it has read already; the merge stops
// below the first entry no candidate precedes. Then the threshold of
// the query rises to the list's k-th value once the list is full.
__device__ __forceinline__ void flush_list(int r, const DevLists& L, float* thr,
                                        int lane) {
  const int n = L.count[r];
  if (n == 0) return;
  float* sv = L.bv + r * BUF;
  int* si = L.bi + r * BUF;
  const int k = L.k;
  const int f = L.fill[r];
  float* gv = L.lv + r * L.stride;
  int* gi = L.li + r * L.stride;
  // the list's lines are most likely out of L2 (the gallery streams
  // through it): ask for all of them now, while the buffer is sorted, so
  // that the chunks below wait on L2 and not on device memory
  for (int at = 32 * lane; at < min(k, f + n); at += 32 * 32) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(gv + at));
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(gi + at));
  }
  float cv = lane < n ? sv[lane] : __int_as_float(0xff800000);
  int ci = lane < n ? si[lane] : 0x7fffffff;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, cv, stride);
      const int oi = __shfl_xor_sync(0xffffffffu, ci, stride);
      // in a block sorted best first the lower lane keeps the better entry
      const bool keep_better = ((lane & stride) == 0) == ((lane & size) == 0);
      if (keep_better == before(ov, oi, cv, ci)) {
        cv = ov;
        ci = oi;
      }
    }
  }
  __syncwarp();
  if (lane < n) {
    sv[lane] = cv;
    si[lane] = ci;
  }
  __syncwarp();
  int hi = min(k, f + n) - 1;
  while (hi >= 0) {
    const int lo = max(0, hi - 32 * FLUSH_U + 1);
    float v[FLUSH_U];
    int ix[FLUSH_U], c[FLUSH_U], cp[FLUSH_U];
#pragma unroll
    for (int u = 0; u < FLUSH_U; ++u) {
      const int i = lo + 32 * u + lane;
      const bool real = i <= hi && i < f;
      v[u] = real ? gv[i] : NEG;
      ix[u] = real ? gi[i] : 0;
      c[u] = real ? count_before(sv, si, n, v[u], ix[u]) : n;
    }
    // c of the entry just below lane 0's first one
    int below = 0;
    if (lane == 0 && lo > 0)
      below = lo - 1 < f ? count_before(sv, si, n, gv[lo - 1], gi[lo - 1]) : n;
#pragma unroll
    for (int u = 0; u < FLUSH_U; ++u) {
      const int up = __shfl_up_sync(0xffffffffu, c[u], 1);
      const int last = __shfl_sync(0xffffffffu, u > 0 ? c[u > 0 ? u - 1 : 0] : 0, 31);
      cp[u] = lane > 0 ? up : (u > 0 ? last : below);
    }
    // every lane's reads of the chunk have returned: the shuffles above
    // took values computed from them, so the writes below need no warp
    // barrier, only one that keeps the compiler from moving them up (and
    // the next chunk's reads lie below this chunk's writes)
    const int stop = __shfl_sync(0xffffffffu, cp[0], 0) == 0;
    asm volatile("" ::: "memory");
#pragma unroll
    for (int u = 0; u < FLUSH_U; ++u) {
      const int i = lo + 32 * u + lane;
      if (i > hi) continue;
      if (i < f && c[u] > 0 && i + c[u] < k) {
        gv[i + c[u]] = v[u];
        gi[i + c[u]] = ix[u];
      }
      for (int j = cp[u]; j < c[u] && i + j < k; ++j) {
        gv[i + j] = sv[j];
        gi[i + j] = si[j];
      }
    }
    if (stop) break;
    hi = lo - 1;
  }
  __syncwarp();  // the list's entries, for lane 0 and for the next flush
  const int nf = min(k, f + n);
  if (lane == 0) {
    L.count[r] = 0;
    L.fill[r] = nf;
    if (nf == k) {
      const float last = gv[k - 1];
      volatile float* t = thr + r;
      if (last > *t) *t = last;
    }
  }
  __syncwarp();
}

// Where the pool route's gather pass appends: the pools [Q, cap] (values,
// indices) and the per-query cursors.
struct Pool {
  float* v;
  int* i;
  int* cursor;
  int cap;
};

// Append query row r's buffered candidates (query q of the call) to its
// pool; the whole warp. One atomicAdd on the query's cursor reserves their
// places; what lies past the capacity is counted by the cursor and not
// written.
__device__ __forceinline__ void flush_pool(int r, int q, const DevLists& L,
                                           const Pool& P, int lane) {
  const int n = L.count[r];
  if (n == 0) return;
  int at = 0;
  if (lane == 0) at = atomicAdd(P.cursor + q, n);
  at = __shfl_sync(0xffffffffu, at, 0) + lane;
  if (lane < n && at < P.cap) {
    const long long o = static_cast<long long>(q) * P.cap + at;
    P.v[o] = L.bv[r * BUF + lane];
    P.i[o] = L.bi[r * BUF + lane];
  }
  __syncwarp();
  if (lane == 0) L.count[r] = 0;
  __syncwarp();
}

// The sample pass's fold: every score of the thread's queries (-inf for an
// invalid row) to their sample rows, two adjacent gallery rows per 8-byte
// store; `out` is query row 0 of the call at the tile's first column.
template <typename Tr>
__device__ __forceinline__ void sample_tile(
    const typename Tr::Acc (&d)[Tr::ACCS][32], const float (&sc)[16],
    unsigned vmask, float* out, long long stride, int q0, int Q, int qrow,
    int cq) {
#pragma unroll
  for (int a = 0; a < Tr::ACCS; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + 64 * a + qrow + 8 * h;
      if (q >= Q) continue;
      float* o = out + static_cast<long long>(q) * stride + cq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2 w;
        w.x = (vmask >> (2 * j)) & 1u ? Tr::score(d[a][4 * j + 2 * h], sc[2 * j])
                                      : -INF;
        w.y = (vmask >> (2 * j + 1)) & 1u
                  ? Tr::score(d[a][4 * j + 1 + 2 * h], sc[2 * j + 1])
                  : -INF;
        *reinterpret_cast<float2*>(o + 8 * j) = w;
      }
    }
  }
}

// The fold of one tile through the candidate buffers (see fold_tile for the
// thresholds and the score layout): device lists, or the pool route's
// gather pass. For each query slot of the thread, the four lanes of a quad
// append what passed to their query's buffer (a prefix sum over the quad
// gives each its place); whatever does not fit waits while the warp hands
// each full buffer to `flush(r)` (merged into the list, or appended to the
// pool), and is appended after.
template <typename Tr, typename Flush>
__device__ __forceinline__ void fold_tile_buffered(
    const typename Tr::Acc (&d)[Tr::ACCS][32], const float (&sc)[16],
    unsigned vmask, float* thr, const DevLists& L, int qrow, int i0,
    int lane, Flush flush) {
  constexpr int ACCS = Tr::ACCS;
  unsigned pm[2 * ACCS];
  unsigned any = 0;
#pragma unroll
  for (int a = 0; a < ACCS; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float bar =
          *reinterpret_cast<volatile float*>(thr + 64 * a + qrow + 8 * h);
      unsigned bits = 0;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float v = Tr::score(d[a][4 * (t >> 1) + (t & 1) + 2 * h], sc[t]);
        bits |= (v >= bar ? 1u : 0u) << t;
      }
      pm[2 * a + h] = bits & vmask;
      any |= pm[2 * a + h];
    }
  }
  if (__ballot_sync(0xffffffffu, any != 0) == 0) return;
  const int ql = lane & 3;
#pragma unroll
  for (int a = 0; a < ACCS; ++a) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned bits = pm[2 * a + h];
      const int r = 64 * a + qrow + 8 * h;
      float v[16];
#pragma unroll
      for (int t = 0; t < 16; ++t)
        v[t] = Tr::score(d[a][4 * (t >> 1) + (t & 1) + 2 * h], sc[t]);
      while (__ballot_sync(0xffffffffu, bits != 0) != 0) {
        const int n = __popc(bits);
        int pre = n;
        int x = __shfl_up_sync(0xffffffffu, pre, 1, 4);
        if (ql >= 1) pre += x;
        x = __shfl_up_sync(0xffffffffu, pre, 2, 4);
        if (ql >= 2) pre += x;
        const int tot = __shfl_sync(0xffffffffu, pre, 3, 4);
        pre -= n;
        const int cnt = L.count[r];
        int take = min(n, max(0, BUF - cnt - pre));
        int at = r * BUF + cnt + pre;
        while (take-- > 0) {
          const int t = __ffs(bits) - 1;
          bits &= bits - 1;
          L.bv[at] = pick16(v, t);
          L.bi[at] = i0 + 8 * (t >> 1) + (t & 1);
          ++at;
        }
        __syncwarp();
        if (ql == 0) L.count[r] = min(BUF, cnt + tot);
        __syncwarp();
        unsigned full = __ballot_sync(0xffffffffu, ql == 0 && cnt + tot >= BUF);
        while (full != 0) {
          const int src = __ffs(full) - 1;
          full &= full - 1;
          flush(__shfl_sync(0xffffffffu, r, src));
        }
      }
    }
  }
}

// ---- PTX: shared addresses, mbarriers, bulk copies, wgmma -----------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Whether the phase of parity `parity` has completed; never blocks.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// One TMA copy of the tensor map's box at (col, row) into shared memory.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) to shared memory.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzled layout:
// rows of 128 bytes, groups of 8 rows 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>(16 >> 4) << 16;    // leading offset: unused here
  d |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride between 8-row groups
  d |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define FRP_L8(M, b) \
  M(b), M(b + 1), M(b + 2), M(b + 3), M(b + 4), M(b + 5), M(b + 6), M(b + 7)
#define FRP_L32(M) FRP_L8(M, 0), FRP_L8(M, 8), FRP_L8(M, 16), FRP_L8(M, 24)
#define FRP_ACC_REGS                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "        \
  "%8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define FRP_F(i) "+f"(d[i])
#define FRP_R(i) "+r"(d[i])

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
__device__ __forceinline__ void acc_fence(float (&d)[32]) {
  asm volatile("" : FRP_L32(FRP_F)::"memory");
}
__device__ __forceinline__ void acc_fence(int (&d)[32]) {
  asm volatile("" : FRP_L32(FRP_R)::"memory");
}

// The bf16 and int8 traits stage 128 operand rows per K-panel, two A blocks
// of 64 rows, the float32 traits 64 rows; `stage_chunk` writes 16 bytes of
// depth of query row r at the swizzled place of chunk c16 of its 128-byte
// row, where the gallery's own row r of a stage keeps it too.

// Traits of kernel K3: float32 unit queries against bf16 rows. The query is
// split as q = hi + lo + r with hi = bf16(q), lo = bf16(q - hi), |r| <=
// 2^-17 |q|; hi is A block 0 and lo A block 1, both multiplied into the same
// accumulator, whose float32 sum is the float32 query's score to ~1e-6 (a
// bf16 x bf16 product is exact in float32).
struct Bf16Traits {
  using Acc = float;
  using QIn = float;  // query type in device memory
  static constexpr int QT = 64;    // queries per block
  static constexpr int ACCS = 1;   // accumulators: the two A blocks share one
  static constexpr int ELEM = 2;   // bytes per gallery value
  static constexpr int QPANEL_BYTES = 128 * PANEL_BYTES;  // hi and lo blocks
  static constexpr bool WGMMA = true;
  static constexpr CUtensorMapDataType MAP_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

  static __device__ __forceinline__ void stage_chunk(const QIn* src,
                                                     unsigned char* qpanel,
                                                     int r, int c16) {
    __align__(16) __nv_bfloat16 hi[8];
    __align__(16) __nv_bfloat16 lo[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float q = src ? src[e] : 0.0f;
      hi[e] = __float2bfloat16_rn(q);
      lo[e] = __float2bfloat16_rn(q - __bfloat162float(hi[e]));
    }
    const int at = r * PANEL_BYTES + ((c16 ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(qpanel + at) = *reinterpret_cast<uint4*>(hi);
    *reinterpret_cast<uint4*>(qpanel + at + QBLOCK_BYTES) =
        *reinterpret_cast<uint4*>(lo);
  }

  // d (+)= A[64 x 16] * B[64 x 16]^T, both K-major bf16 in shared memory
  static __device__ __forceinline__ void mma(Acc (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FRP_ACC_REGS
        ", %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : FRP_L32(FRP_F)
        : "l"(da), "l"(db), "r"(accumulate));
  }

  static __device__ __forceinline__ float score(Acc s, float) { return s; }
};

// Traits of kernel K4: int8 query codes against int8 row codes. The dot is
// an exact s8 x s8 -> s32 tensor-core product (|dot| <= 512 * 127^2 < 2^24,
// so its float32 conversion is exact too) and is multiplied by the row's
// dequantisation scale: one rounding in all. A block 0 holds query rows
// 0-63 and A block 1 rows 64-127, each with its own accumulator.
struct Int8Traits {
  using Acc = int;
  using QIn = signed char;
  static constexpr int QT = 128;
  static constexpr int ACCS = 2;
  static constexpr int ELEM = 1;
  static constexpr int QPANEL_BYTES = 128 * PANEL_BYTES;  // rows 0-63, 64-127
  static constexpr bool WGMMA = true;
  static constexpr CUtensorMapDataType MAP_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;

  static __device__ __forceinline__ void stage_chunk(const QIn* src,
                                                     unsigned char* qpanel,
                                                     int r, int c16) {
    const uint4 v = src ? *reinterpret_cast<const uint4*>(src)
                        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(qpanel + r * PANEL_BYTES +
                              ((c16 ^ (r & 7)) << 4)) = v;
  }

  // d (+)= A[64 x 32] * B[64 x 32]^T, both K-major int8 in shared memory
  static __device__ __forceinline__ void mma(Acc (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " FRP_ACC_REGS
        ", %32, %33, p;\n"
        "}\n"
        : FRP_L32(FRP_R)
        : "l"(da), "l"(db), "r"(accumulate));
  }

  static __device__ __forceinline__ float score(Acc s, float scale) {
    return __fmul_rn(__int2float_rn(s), scale);
  }
};

// Traits of K3 on float32 rows: float32 unit queries against float32 rows,
// multiplied in float32 on the CUDA cores (a tensor-core product would round
// the rows to TF32). A panel is 32 floats of depth: 64 query rows of it, and
// a stage of 64 gallery rows, both in the 128-byte swizzle.
//
// The register tile. A warp owns 16 query rows x 64 gallery rows of a tile,
// 32 scores a thread. Shared memory hands out 128 bytes per cycle, and a
// 16-byte load of a warp takes four of those wavefronts (quarter-warps) how
// many lanes share an address, so a thread costs one wavefront per float it
// loads a depth. The wgmma layout (2 queries x 16 rows) would load 18 floats
// per 32 FMAs: 0.56 wavefronts per warp-wide FMA where the SM issues 4 FMAs
// per wavefront, 2.25x the FMA time. Here lane (g = lane / 4, t = lane % 4)
// multiplies 4 queries (g, g + 8, g ^ 1, (g ^ 1) + 8 of the warp's 16) by 8
// rows (8 j + 2 t + (g & 1)): 12 floats per 32 FMAs, 0.375 wavefronts per
// FMA, 1.5x. Every quarter-warp reads distinct swizzled 16-byte columns (no
// bank conflict). After the tile's last panel one exchange with lane ^ 4
// (16 shuffles) puts the scores where the wgmma accumulator keeps them
// (query g + 8 h, row 8 j + 2 t + e at 4 j + e + 2 h), which is what the
// fold reads. Sums run over depth in order as fused multiply-adds: exact
// float32 products, one rounding per step, as the reference's float32 dot.
struct F32Traits {
  using Acc = float;
  using QIn = float;
  static constexpr int QT = 64;
  static constexpr int ACCS = 1;
  static constexpr int ELEM = 4;
  static constexpr int QPANEL_BYTES = 64 * PANEL_BYTES;
  static constexpr bool WGMMA = false;
  static constexpr CUtensorMapDataType MAP_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

  static __device__ __forceinline__ void stage_chunk(const QIn* src,
                                                     unsigned char* qpanel,
                                                     int r, int c16) {
    const float4 v = src ? *reinterpret_cast<const float4*>(src)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(qpanel + r * PANEL_BYTES +
                               ((c16 ^ (r & 7)) << 4)) = v;
  }

  // d += the panel's products in the compute layout: d[2 j + h] query g +
  // 8 h, d[16 + 2 j + h] query (g ^ 1) + 8 h, both against row 8 j + 2 t +
  // (g & 1); qp: the 64 query rows, st: the 64 gallery rows of the stage.
  static __device__ __forceinline__ void fma_panel(float (&d)[32],
                                                   const unsigned char* qp,
                                                   const unsigned char* st,
                                                   int warp, int lane) {
    const int g = lane >> 2, t = lane & 3, e0 = g & 1;
    const unsigned char* q0 = qp + (16 * (warp & 3) + g) * PANEL_BYTES;
    const unsigned char* q1 = qp + (16 * (warp & 3) + (g ^ 1)) * PANEL_BYTES;
    const unsigned char* rows = st + (2 * t + e0) * PANEL_BYTES;
    const int rsw = 2 * t + e0;  // row & 7 of every row of the thread
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int qc = (c ^ g) << 4, oc = (c ^ (g ^ 1)) << 4;
      float4 q[4];
      q[0] = *reinterpret_cast<const float4*>(q0 + qc);
      q[1] = *reinterpret_cast<const float4*>(q0 + 8 * PANEL_BYTES + qc);
      q[2] = *reinterpret_cast<const float4*>(q1 + oc);
      q[3] = *reinterpret_cast<const float4*>(q1 + 8 * PANEL_BYTES + oc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 r = *reinterpret_cast<const float4*>(
            rows + 8 * j * PANEL_BYTES + ((c ^ rsw) << 4));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float& s = d[16 * (u >> 1) + 2 * j + (u & 1)];
          s = __fmaf_rn(q[u].x, r.x, s);
          s = __fmaf_rn(q[u].y, r.y, s);
          s = __fmaf_rn(q[u].z, r.z, s);
          s = __fmaf_rn(q[u].w, r.w, s);
        }
      }
    }
  }

  // The compute layout -> the wgmma accumulator layout (the whole warp).
  static __device__ __forceinline__ void to_wgmma_layout(float (&d)[32],
                                                         int lane) {
    const bool e0 = ((lane >> 2) & 1) != 0;
    float out[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float own = d[2 * j + h];
        const float got = __shfl_xor_sync(0xffffffffu, d[16 + 2 * j + h], 4);
        out[4 * j + 2 * h] = e0 ? got : own;
        out[4 * j + 1 + 2 * h] = e0 ? own : got;
      }
    }
#pragma unroll
    for (int u = 0; u < 32; ++u) d[u] = out[u];
  }

  static __device__ __forceinline__ float score(Acc s, float) { return s; }
};

// Shared memory of a block, from a 1024-byte aligned base: the queries
// [panels][Tr::QPANEL_BYTES], the two rings [stages][TM rows x 128 bytes]
// (the first half of the stages is warpgroup 0's), a tile's valid bytes and
// scales per stage, then either the two warpgroups' lists [2][QT][kl]
// (values, then indices; kl the list length the kernel was built for) or,
// for lists in device memory, their candidate buffers [2][QT][BUF] (values,
// then indices), the buffers' counts [2][QT] and the lists' fills [2][QT];
// the thresholds [QT], the barriers (full then empty, per stage). The pool
// route's launches keep the device lists' layout (kl = DEVICE_LISTS).
// ops/gallery_kernel.py::gallery_launch_geometry computes the same sum.
template <typename Tr>
struct Layout {
  static __host__ __device__ int panels(int D) {
    return (D * Tr::ELEM + PANEL_BYTES - 1) / PANEL_BYTES;
  }
  static __host__ __device__ size_t lists(int kl) {
    return static_cast<size_t>(CONSUMER_WGS) * Tr::QT *
           (kl == DEVICE_LISTS ? BUF * 8 + 8 : kl * 8);
  }
  static __host__ __device__ size_t bytes(int D, int kl, int stages) {
    return 1024 + static_cast<size_t>(panels(D)) * Tr::QPANEL_BYTES +
           static_cast<size_t>(stages) * (STAGE_BYTES + SIDE_BYTES + 16) +
           lists(kl) + Tr::QT * 4;
  }
};

// What a launch walks and where the pool route's modes write: `thr0` [Q]
// the queries' starting thresholds (null: -1e9; +inf: a query this launch
// leaves alone), `sample` [Q, walk * TM] (SAMPLE), the pools (GATHER), and
// `walk` the tiles walked: n_tiles, or the sample's, tile lt being gallery
// tile lt * n_tiles / walk.
struct Walk {
  const float* thr0;
  float* sample;
  Pool pool;
  long long walk;
};

// queries [Q, D] (Tr::QIn), the gallery [G, D] through `gmap` (box TM rows x
// 128 bytes, 128-byte swizzle, zeros outside), scales [G] or null, valid [G]
// bytes -> part_v / part_i: with lists of KL entries [Q, gridDim.x, KL], the
// KL best per query and block; with KL == DEVICE_LISTS [Q, 2 gridDim.x, k],
// the k best per query, block and warpgroup (the lists themselves); with
// KL == SAMPLE or GATHER the pool route's stages 1 and 2 (`Walk`). D % 32
// == 0; queries, scales and valid 16-byte aligned; `stages` even. KL is a
// template parameter because the list code is unrolled: its length decides
// what an insertion costs and where the list is kept.
template <typename Tr, int KL>
__global__ void __launch_bounds__(THREADS, 1)
    stream_topk_kernel(const __grid_constant__ CUtensorMap gmap,
                       const typename Tr::QIn* __restrict__ queries,
                       const float* __restrict__ scales,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ part_v, int* __restrict__ part_i,
                       const Walk wk, int Q, int G, int D, int k, int stages) {
  using Acc = typename Tr::Acc;
  constexpr bool DEV = KL == DEVICE_LISTS;
  constexpr bool BUFFERED = KL <= 0;  // device lists' layout: all but short lists
  constexpr int kl = BUFFERED ? BUF : KL;  // entries per query in shared memory
  constexpr int QT = Tr::QT;
  constexpr int ACCS = Tr::ACCS;
  const int q0 = blockIdx.y * QT;

  // a block whose queries this launch leaves alone (the unresolved route's
  // resolved queries) returns before it stages anything
  if (wk.thr0 != nullptr &&
      !__syncthreads_or(threadIdx.x < QT && q0 + threadIdx.x < Q &&
                        wk.thr0[q0 + threadIdx.x] != INF))
    return;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int panels = Layout<Tr>::panels(D);
  const int half = stages / 2;  // stages of one warpgroup's ring
  unsigned char* qs = sm;
  unsigned char* ring = qs + panels * Tr::QPANEL_BYTES;
  unsigned char* side = ring + stages * STAGE_BYTES;
  float* lv = reinterpret_cast<float*>(side + stages * SIDE_BYTES);
  int* li = reinterpret_cast<int*>(lv + CONSUMER_WGS * QT * kl);
  int* counts = li + CONSUMER_WGS * QT * kl;  // buffers' counts, lists' fills
  float* thr = reinterpret_cast<float*>(counts + (BUFFERED ? 2 * CONSUMER_WGS * QT : 0));
  const uint32_t bars = smem_u32(thr + QT);  // full[stages], empty[stages]

  const long long n_tiles = (static_cast<long long>(G) + TM - 1) / TM;
  // the gallery tile of walked tile lt: itself, or the sample's spread
  const long long walk = wk.walk;
  auto tile_of = [&](long long lt) {
    return walk == n_tiles ? lt : lt * n_tiles / walk;
  };
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;

  // the queries, swizzled as the products read them; rows past Q and depth
  // past D are zeros
  {
    const int chunks = panels * 8;                // 16-byte chunks per row
    const int filled = D * Tr::ELEM / 16;         // of which hold data
    constexpr int PER = 16 / Tr::ELEM;            // values per chunk
    for (int p = threadIdx.x; p < QT * chunks; p += THREADS) {
      const int r = p / chunks, ch = p % chunks;
      const typename Tr::QIn* src =
          (q0 + r < Q && ch < filled)
              ? queries + static_cast<long long>(q0 + r) * D + ch * PER
              : nullptr;
      Tr::stage_chunk(src, qs + (ch / 8) * Tr::QPANEL_BYTES, r, ch % 8);
    }
  }
  if constexpr (BUFFERED) {
    for (int p = threadIdx.x; p < 2 * CONSUMER_WGS * QT; p += THREADS) counts[p] = 0;
  } else {
    for (int p = threadIdx.x; p < CONSUMER_WGS * QT * kl; p += THREADS) {
      lv[p] = NEG;
      li[p] = 0;
    }
  }
  // a query row past Q is never offered anything; the pool route's launches
  // start from their per-query thresholds
  if (threadIdx.x < QT)
    thr[threadIdx.x] = q0 + threadIdx.x >= Q ? INF
                       : wk.thr0 != nullptr  ? wk.thr0[q0 + threadIdx.x]
                                             : NEG;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);             // the producer
      mbar_init(bars + 8 * (stages + s), 4);  // the four warps of a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the staged queries are read by the tensor cores (the asynchronous proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (wg == CONSUMER_WGS) {
    // ---- producer: one warp keeps both rings full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 4 * CONSUMER_WGS) return;
    // One panel into ring w if its next stage is free. Each ring has its
    // own cursor (tile, panel, stage, phase), so a warpgroup that is busy
    // folding holds back only its own ring.
    auto feed = [&](const int w, long long& tile, int& p, int& s,
                    uint32_t& ph) {
      if (tile >= walk) return;
      const int at = w * half + s;
      const uint32_t empty = bars + 8 * (stages + at);
      if (!__any_sync(0xffffffffu, mbar_test(empty, ph ^ 1))) return;
      mbar_wait(empty, ph ^ 1);  // every lane has seen the stage free
      const uint32_t full = bars + 8 * at;
      const int row0 = static_cast<int>(tile_of(tile) * TM);
      const bool whole = row0 + TM <= G;
      unsigned char* sd = side + at * SIDE_BYTES;
      uint32_t bytes = STAGE_BYTES;
      if (p == 0) {
        if (whole) {
          bytes += TM + (scales != nullptr ? TM * 4 : 0);
        } else {  // the ragged last tile: rows past G are invalid
          for (int r = lane; r < TM; r += 32) {
            const bool in = row0 + r < G;
            sd[r] = in ? valid[row0 + r] : static_cast<unsigned char>(0);
            if (scales != nullptr)
              reinterpret_cast<float*>(sd + TM)[r] =
                  in ? scales[row0 + r] : 0.0f;
          }
          __syncwarp();
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full, bytes);
        tma_load_2d(smem_u32(ring + at * STAGE_BYTES), &gmap, full,
                    p * (PANEL_BYTES / Tr::ELEM), row0);
        if (p == 0 && whole) {
          bulk_copy(smem_u32(sd), valid + row0, TM, full);
          if (scales != nullptr)
            bulk_copy(smem_u32(sd + TM), scales + row0, TM * 4, full);
        }
      }
      if (++s == half) {
        s = 0;
        ph ^= 1;
      }
      if (++p == panels) {
        p = 0;
        tile += 2 * gridDim.x;
      }
    };
    long long t0 = blockIdx.x, t1 = t0 + gridDim.x;
    int p0 = 0, p1 = 0, s0 = 0, s1 = 0;
    uint32_t ph0 = 0, ph1 = 0;
    while (t0 < walk || t1 < walk) {
      feed(0, t0, p0, s0, ph0);
      feed(1, t1, p1, s1, ph1);
    }
  } else {
    // ---- consumers: two warpgroups, every other tile each -----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    Acc d[ACCS][32];
#pragma unroll
    for (int a = 0; a < ACCS; ++a)
#pragma unroll
      for (int j = 0; j < 32; ++j) d[a][j] = 0;
    float* my_v = lv + wg * QT * kl;
    int* my_i = li + wg * QT * kl;
    // lists in device memory: this warpgroup's list of query row r of the
    // tile is number 2 blockIdx.x + wg of row q0 + r
    const int n_lists = 2 * gridDim.x;
    const DevLists dl{my_v, my_i, counts + wg * QT, counts + (CONSUMER_WGS + wg) * QT,
                      part_v + (static_cast<long long>(q0) * n_lists + 2 * blockIdx.x + wg) * k,
                      part_i + (static_cast<long long>(q0) * n_lists + 2 * blockIdx.x + wg) * k,
                      static_cast<long long>(n_lists) * k, k};
    const int qrow = 16 * (warp & 3) + (lane >> 2);  // its query row of an A block
    const int cq = 2 * (lane & 3);  // its gallery rows of a tile: 8 j + cq + e
    const uint32_t ring_a = smem_u32(ring + wg * half * STAGE_BYTES);
    const uint32_t qs_a = smem_u32(qs);
    const uint32_t full0 = bars + 8 * (wg * half);
    const uint32_t empty0 = bars + 8 * (stages + wg * half);
    int s = 0;
    uint32_t ph = 0;
    for (long long tile = blockIdx.x + static_cast<long long>(wg) * gridDim.x;
         tile < walk; tile += 2 * gridDim.x) {
      unsigned vmask = 0;  // bit 2 j + e: gallery row 8 j + cq + e is valid
      float sc[16];        // and its scale
#pragma unroll
      for (int t = 0; t < 16; ++t) sc[t] = 1.0f;
      int prev = 0;
#pragma unroll
      for (int a = 0; a < ACCS; ++a) acc_fence(d[a]);
      if constexpr (!Tr::WGMMA) {
#pragma unroll
        for (int j = 0; j < 32; ++j) d[0][j] = 0;
      }
      for (int p = 0; p < panels; ++p) {
        mbar_wait(full0 + 8 * s, ph);  // the panel has landed
        if (p == 0) {
          const unsigned char* sd = side + (wg * half + s) * SIDE_BYTES;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const unsigned w =
                *reinterpret_cast<const unsigned short*>(sd + 8 * j + cq);
            vmask |= ((w & 0xffu) != 0 ? 1u : 0u) << (2 * j);
            vmask |= ((w >> 8) != 0 ? 1u : 0u) << (2 * j + 1);
            if (scales != nullptr) {
              const float2 s2 = *reinterpret_cast<const float2*>(
                  sd + TM + 4 * (8 * j + cq));
              sc[2 * j] = s2.x;
              sc[2 * j + 1] = s2.y;
            }
          }
        }
        if constexpr (Tr::WGMMA) {
          wgmma_fence();
          const uint64_t dq = wgmma_desc(qs_a + p * Tr::QPANEL_BYTES);
          const uint64_t dg = wgmma_desc(ring_a + s * STAGE_BYTES);
#pragma unroll
          for (int kk = 0; kk < PANEL_BYTES / 32; ++kk) {  // 32 bytes of depth
#pragma unroll
            for (int blk = 0; blk < 2; ++blk)  // the two A blocks of the panel
              Tr::mma(d[ACCS == 2 ? blk : 0],
                      dq + blk * (QBLOCK_BYTES >> 4) + 2 * kk, dg + 2 * kk,
                      ACCS == 2 ? (p | kk) != 0 : (p | kk | blk) != 0);
          }
          wgmma_commit();
          if (p > 0) {  // the panel before this one has been multiplied
            wgmma_wait<1>();
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * prev);
          }
        } else {
          Tr::fma_panel(d[0], qs + p * Tr::QPANEL_BYTES,
                        ring + (wg * half + s) * STAGE_BYTES, warp, lane);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
        prev = s;
        if (++s == half) {
          s = 0;
          ph ^= 1;
        }
      }
      if constexpr (Tr::WGMMA) {
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      } else {
        Tr::to_wgmma_layout(d[0], lane);
      }
#pragma unroll
      for (int a = 0; a < ACCS; ++a) acc_fence(d[a]);

      const int i0 = static_cast<int>(tile_of(tile) * TM) + cq;
      if constexpr (DEV) {
        fold_tile_buffered<Tr>(d, sc, vmask, thr, dl, qrow, i0, lane,
                               [&](int r) { flush_list(r, dl, thr, lane); });
      } else if constexpr (KL == GATHER) {
        fold_tile_buffered<Tr>(
            d, sc, vmask, thr, dl, qrow, i0, lane,
            [&](int r) { flush_pool(r, q0 + r, dl, wk.pool, lane); });
      } else if constexpr (KL == SAMPLE) {
        sample_tile<Tr>(d, sc, vmask, wk.sample + tile * TM, walk * TM, q0, Q,
                        qrow, cq);
      } else {
        fold_tile<Tr, KL>(d, sc, vmask, thr, my_v, my_i, qrow, i0, lane);
      }
    }

    if constexpr (KL == GATHER) {
      // the warp's last appends (row r of an A block as below)
#pragma unroll
      for (int a = 0; a < ACCS; ++a) {
        for (int slot = 0; slot < 16; ++slot) {
          const int r = 64 * a + 16 * (warp & 3) + (slot & 7) + 8 * (slot >> 3);
          if (q0 + r < Q) flush_pool(r, q0 + r, dl, wk.pool, lane);
        }
      }
    } else if constexpr (DEV) {
      // the warp's last flushes, then sentinels behind each list's entries
      // (row r of an A block: 64 a + 16 (warp & 3) + quad + 8 h); a query
      // this launch leaves alone keeps no list
#pragma unroll
      for (int a = 0; a < ACCS; ++a) {
        for (int slot = 0; slot < 16; ++slot) {
          const int r = 64 * a + 16 * (warp & 3) + (slot & 7) + 8 * (slot >> 3);
          if (q0 + r >= Q || (wk.thr0 != nullptr && wk.thr0[q0 + r] == INF)) continue;
          flush_list(r, dl, thr, lane);
          float* gv = dl.lv + r * dl.stride;
          int* gi = dl.li + r * dl.stride;
          for (int i = dl.fill[r] + lane; i < k; i += 32) {
            gv[i] = NEG;
            gi[i] = 0;
          }
        }
      }
    } else if constexpr (KL > 0) {
      // the two warpgroups' lists of a query -> the block's list, in scratch
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      const int r = threadIdx.x;
      if (r < QT && q0 + r < Q)
        write_block_list<KL>(
            lv, li, QT, r, part_v, part_i,
            (static_cast<long long>(q0 + r) * gridDim.x + blockIdx.x) * KL);
    }
  }
}

// part_v / part_i [Q, n_parts, kl] (each list sorted, best first) -> out_v
// [Q, k], out_i [Q, k] (int64), k <= kl; one block per query, one thread per
// list (n_parts <= blockDim.x). A thread holds its list's head; k times the
// block picks the best head by (value descending, index ascending, list
// ascending) and that list's head moves on. With `q_scale` [Q] (K4: the
// queries' own dequantisation scales) a finished score is multiplied by its
// query's scale, one more rounding; the sentinel stays exact.
__global__ void merge_topk_kernel(const float* __restrict__ part_v,
                                  const int* __restrict__ part_i,
                                  float* __restrict__ out_v,
                                  long long* __restrict__ out_i,
                                  const float* __restrict__ q_scale,
                                  int n_parts, int kl, int Q, int k) {
  constexpr int NONE = 0x7fffffff;  // an exhausted list, or no list
  const float none_v = __int_as_float(0xff800000);  // -inf
  __shared__ float wv[32];
  __shared__ int wi[32], wp[32];
  __shared__ int winner;
  const int q = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p % 32, warp = p / 32;
  const long long base = (static_cast<long long>(q) * n_parts + p) * kl;
  int head = 0;
  float hv = none_v;
  int hi = NONE;
  if (p < n_parts) {
    hv = part_v[base];
    hi = part_i[base];
  }
  // a before b by (value desc, index asc, list asc): a strict total order
  auto better = [](float av, int ai, int ap, float bv, int bi, int bp) {
    return av > bv || (av == bv && (ai < bi || (ai == bi && ap < bp)));
  };
  const float qs = q_scale != nullptr ? q_scale[q] : 1.0f;
  for (int j = 0; j < k; ++j) {
    float bv = hv;
    int bi = hi, bp = hi == NONE ? NONE : p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (better(ov, oi, op, bv, bi, bp)) {
        bv = ov;
        bi = oi;
        bp = op;
      }
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
      wp[warp] = bp;
    }
    __syncthreads();
    if (warp == 0) {
      const bool in = lane < static_cast<int>(blockDim.x / 32);
      bv = in ? wv[lane] : none_v;
      bi = in ? wi[lane] : NONE;
      bp = in ? wp[lane] : NONE;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        const int op = __shfl_xor_sync(0xffffffffu, bp, off);
        if (better(ov, oi, op, bv, bi, bp)) {
          bv = ov;
          bi = oi;
          bp = op;
        }
      }
      if (lane == 0) {
        const bool found = bp != NONE;  // always, as n_parts * kl >= k
        const float v = found ? bv : NEG;
        out_v[static_cast<long long>(q) * k + j] =
            (q_scale != nullptr && v > NEG) ? __fmul_rn(v, qs) : v;
        out_i[static_cast<long long>(q) * k + j] = found ? bi : 0;
        winner = bp;
      }
    }
    __syncthreads();
    if (p == winner) {
      if (++head < kl) {
        hv = part_v[base + head];
        hi = part_i[base + head];
      } else {
        hv = none_v;
        hi = NONE;
      }
    }
  }
}

// Lists in device memory: part_v / part_i [Q, P, k] (each list sorted,
// padded with sentinels) -> out_v / out_i [Q, k]; one block per query, one
// warp per pair of lists. Level s merges list m + s into list m for m = 0,
// 2 s, 4 s, ... (a fixed tree, so the result does not depend on which warp
// ran when); a warp copies both lists into its part of shared memory, and
// lane l writes outputs l E .. l E + E - 1 (E = ceil(k / 32)) back over list
// m: it finds how many of its first output's predecessors come from list m
// by a binary search along the merge path's diagonal, then takes its
// outputs in order. List m keeps the ties (only sentinels tie), and
// a + b = o < k keeps both cursors inside their lists. The last level's
// list 0 is the answer; `q_scale` as in merge_topk_kernel. With `skip` [Q]
// (the pool route's unresolved route) a query whose entry is +inf was
// answered by the select kernel and its block leaves at once.
__global__ void merge_lists_kernel(float* __restrict__ part_v,
                                   int* __restrict__ part_i,
                                   float* __restrict__ out_v,
                                   long long* __restrict__ out_i,
                                   const float* __restrict__ q_scale,
                                   const float* __restrict__ skip, int P,
                                   int k) {
  if (skip != nullptr && skip[blockIdx.x] == INF) return;
  extern __shared__ float4 merge_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int W = blockDim.x / 32;
  float* av = reinterpret_cast<float*>(merge_smem) + static_cast<size_t>(warp) * 4 * k;
  int* ai = reinterpret_cast<int*>(av + k);
  float* bv = av + 2 * k;
  int* bi = reinterpret_cast<int*>(av + 3 * k);
  const int q = blockIdx.x;
  const long long base = static_cast<long long>(q) * P * k;
  const int per = (k + 31) / 32;
  for (int s = 1; s < P; s *= 2) {
    for (int m = 2 * s * warp; m + s < P; m += 2 * s * W) {
      float* gav = part_v + base + static_cast<long long>(m) * k;
      int* gai = part_i + base + static_cast<long long>(m) * k;
      const float* gbv = part_v + base + static_cast<long long>(m + s) * k;
      const int* gbi = part_i + base + static_cast<long long>(m + s) * k;
      for (int t = lane; t < k; t += 32) {
        av[t] = gav[t];
        ai[t] = gai[t];
        bv[t] = gbv[t];
        bi[t] = gbi[t];
      }
      __syncwarp();
      const int o0 = min(k, lane * per), o1 = min(k, o0 + per);
      int lo = max(0, o0 - k), hi = min(o0, k);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!before(bv[o0 - 1 - mid], bi[o0 - 1 - mid], av[mid], ai[mid])) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      int a = lo, b = o0 - lo;
      for (int o = o0; o < o1; ++o) {
        const bool take_b = before(bv[b], bi[b], av[a], ai[a]);
        gav[o] = take_b ? bv[b] : av[a];
        gai[o] = take_b ? bi[b] : ai[a];
        if (take_b) {
          ++b;
        } else {
          ++a;
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
  const float qs = q_scale != nullptr ? q_scale[q] : 1.0f;
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const float v = part_v[base + t];
    out_v[static_cast<long long>(q) * k + t] =
        (q_scale != nullptr && v > NEG) ? __fmul_rn(v, qs) : v;
    out_i[static_cast<long long>(q) * k + t] = part_i[base + t];
  }
}

// ---- the pool route's selects ---------------------------------------------

// A float's order-preserving key (-0 taken as +0, which compares equal to
// it), and back.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(uint32_t e) {
  return __uint_as_float((e & 0x80000000u) ? (e & 0x7fffffffu) : ~e);
}

struct SelectShared {
  int hist[RADIX_BINS];
  uint32_t digit;
  int above;
  int equal;
};

// The rank-th largest (1 <= rank <= the number of eligible keys) of the
// 32-bit keys that get(i, key) marks eligible, i < n; the whole block. Three
// passes of 11, 11 and 10 bits, each a histogram of the eligible keys that
// share the digits found so far (lanes with the same digit add once, by
// __match_any_sync; the keys of a pass crowd into few bins); one warp finds
// the digit that holds the rank. Returns the key; *above counts the
// eligible keys larger than it, *equal those equal to it.
template <typename Get>
__device__ uint32_t radix_select(Get get, int n, int rank, SelectShared& sh,
                                 int* above, int* equal) {
  const int lane = threadIdx.x % 32;
  uint32_t prefix = 0, mask = 0;
  int above_all = 0;
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
    const uint32_t dmask = pass == 2 ? 0x3ffu : 0x7ffu;
    for (int b = threadIdx.x; b < RADIX_BINS; b += blockDim.x) sh.hist[b] = 0;
    __syncthreads();
    for (int base = threadIdx.x - lane; base < n; base += blockDim.x) {
      const int i = base + lane;
      uint32_t key = 0;
      const bool ok = i < n && get(i, key) && (key & mask) == prefix;
      const uint32_t digit = ok ? (key >> shift) & dmask : 0xffffffffu;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(&sh.hist[digit], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      constexpr int PER = RADIX_BINS / 32;  // bins of a lane; lane 31 the top
      int sum = 0;
      for (int b = 0; b < PER; ++b) sum += sh.hist[lane * PER + b];
      int incl = sum;  // keys in the bins of this lane and the lanes above
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      if (incl - sum < rank && rank <= incl) {  // the rank lies in this lane's bins
        int acc = incl - sum;
        int b = PER - 1;
        for (; b > 0; --b) {
          const int c = sh.hist[lane * PER + b];
          if (acc + c >= rank) break;
          acc += c;
        }
        sh.digit = lane * PER + b;
        sh.above = acc;
        sh.equal = sh.hist[lane * PER + b];
      }
    }
    __syncthreads();
    prefix |= sh.digit << shift;
    mask |= dmask << shift;
    rank -= sh.above;
    above_all += sh.above;
    *equal = sh.equal;
    __syncthreads();  // every thread has read sh before the next pass
  }
  *above = above_all;
  return prefix;
}

// keys[0, n) sorted descending in shared memory, n a power of two; the
// whole block.
template <typename K>
__device__ void bitonic_desc(K* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int u = threadIdx.x; u < n / 2; u += blockDim.x) {
        const int a = 2 * u - (u & (stride - 1));
        const int b = a + stride;
        const K x = keys[a], y = keys[b];
        if ((x < y) == ((a & size) == 0)) {  // descending where a & size == 0
          keys[a] = y;
          keys[b] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ uint32_t max_key(const float4& v) {
  return max(max(order_key(v.x), order_key(v.y)), max(order_key(v.z), order_key(v.w)));
}

// Stage 1's select: T_q = the rank-th best of query q's sample row
// sample[q, 0:S] (-inf where fewer than rank are valid; S a multiple of 4),
// one block per query; the query's pool cursor is zeroed for stage 2. First
// each thread's largest key over its 16-byte chunks t, t + T, ... (four
// loads in flight): at least rank keys reach L, the rank-th largest of
// those maxima (rank <= the block's T threads), and only about rank more do
// on a random gallery, so the keys at or above L are gathered into shared
// memory and sorted. Where more than SAMPLE_CANDS reach L (ties, a sample
// of mostly invalid rows) the radix select over the whole row answers
// instead.
__global__ void __launch_bounds__(SELECT_THREADS)
    sample_threshold_kernel(const float* __restrict__ sample, int S, int rank,
                            float* __restrict__ thr, int* __restrict__ cursor) {
  __shared__ SelectShared sh;
  __shared__ uint32_t cand[SAMPLE_CANDS];
  __shared__ int n_cand;
  const int q = blockIdx.x;
  const float* row = sample + static_cast<long long>(q) * S;
  const float4* row4 = reinterpret_cast<const float4*>(row);
  const int S4 = S / 4;
  const int T = blockDim.x;
  float t = -INF;
  if (rank <= S) {
    uint32_t best = 0;  // below every float's key
    int c = threadIdx.x;
    for (; c + 3 * T < S4; c += 4 * T) {
      const float4 a = row4[c], b = row4[c + T], d = row4[c + 2 * T], e = row4[c + 3 * T];
      best = max(best, max(max(max_key(a), max_key(b)), max(max_key(d), max_key(e))));
    }
    for (; c < S4; c += T) best = max(best, max_key(row4[c]));
    cand[threadIdx.x] = best;
    if (threadIdx.x == 0) n_cand = 0;
    __syncthreads();
    bitonic_desc(cand, SELECT_THREADS);
    const uint32_t low = cand[rank - 1];
    __syncthreads();
    const int lane = threadIdx.x % 32;
    for (int base = threadIdx.x - lane; base < S4; base += T) {
      const int c4 = base + lane;
      float4 v = make_float4(-INF, -INF, -INF, -INF);
      if (c4 < S4) v = row4[c4];
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t key = order_key(x[u]);
        const bool ok = c4 < S4 && key >= low;
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        if (m == 0) continue;
        int at = 0;
        if (lane == 0) at = atomicAdd(&n_cand, __popc(m));
        at = __shfl_sync(0xffffffffu, at, 0) + __popc(m & ((1u << lane) - 1u));
        if (ok && at < SAMPLE_CANDS) cand[at] = key;
      }
    }
    __syncthreads();
    const int n = n_cand;
    if (n <= SAMPLE_CANDS) {
      int pad = 32;
      while (pad < n) pad <<= 1;
      for (int j = n + threadIdx.x; j < pad; j += blockDim.x) cand[j] = 0u;
      __syncthreads();
      bitonic_desc(cand, pad);
      t = key_value(cand[rank - 1]);
    } else {
      int above, equal;
      t = key_value(radix_select(
          [&](int i, uint32_t& key) {
            key = order_key(row[i]);
            return true;
          },
          S, rank, sh, &above, &equal));
    }
  }
  if (threadIdx.x == 0) {
    thr[q] = t;
    cursor[q] = 0;
  }
}

// Stage 3: query q's pool (n_q = cursor[q] appended, the first min(n_q, cap)
// at pool_v / pool_i [Q, cap]) -> out_v / out_i [Q, k], one block per query.
// The query is resolved when n_q <= cap and either n_q >= k or T_q = -inf
// (then the pool holds every valid row, and slots past n_q get sentinels);
// `force` sends every query to the unresolved route. An unresolved query
// gets its starting threshold for that route in thr_unres (T_q when n_q >= k:
// then more than k rows reach T_q, so it is at or below the k-th score;
// else -1e9) and one count in *unresolved; a resolved one gets +inf. The k
// best by (value descending, index ascending): the k-th value by a radix
// select of the order-preserving keys; where its ties straddle the cut, the
// cut among their indices by a second select of the inverted indices; the k
// chosen gathered into shared memory as 64-bit keys (value key, inverted
// index) and sorted bitonically over `sort_n` (a power of two >= k),
// descending; `q_scale` as in merge_topk_kernel.
__global__ void __launch_bounds__(SELECT_THREADS)
    select_pool_kernel(const float* __restrict__ pool_v,
                       const int* __restrict__ pool_i,
                       const int* __restrict__ cursor,
                       const float* __restrict__ thr, int cap, int k, int sort_n,
                       const float* __restrict__ q_scale, float* __restrict__ out_v,
                       long long* __restrict__ out_i, float* __restrict__ thr_unres,
                       unsigned long long* __restrict__ unresolved, int force) {
  extern __shared__ unsigned long long sel_keys[];  // [sort_n]
  __shared__ SelectShared sh;
  __shared__ int taken;
  const int q = blockIdx.x;
  const int n = cursor[q];
  const float t = thr[q];
  const bool complete = t == -INF;
  if (force != 0 || n > cap || (n < k && !complete)) {
    if (threadIdx.x == 0) {
      thr_unres[q] = n >= k ? t : NEG;
      atomicAdd(unresolved, 1ull);
    }
    return;
  }
  if (threadIdx.x == 0) {
    thr_unres[q] = INF;
    taken = 0;
  }
  const float* pv = pool_v + static_cast<long long>(q) * cap;
  const int* pi = pool_i + static_cast<long long>(q) * cap;
  uint32_t vcut = 0, icut = 0;  // chosen: key > vcut, or == vcut and ~index >= icut
  if (n > k) {
    int above, equal;
    vcut = radix_select(
        [&](int i, uint32_t& key) {
          key = order_key(pv[i]);
          return true;
        },
        n, k, sh, &above, &equal);
    const int need = k - above;  // of the ties at the k-th value
    if (equal > need) {
      int a2, e2;
      icut = radix_select(
          [&](int i, uint32_t& key) {
            key = ~static_cast<uint32_t>(pi[i]);
            return order_key(pv[i]) == vcut;
          },
          n, need, sh, &a2, &e2);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int base = threadIdx.x - lane; base < n; base += blockDim.x) {
    const int i = base + lane;
    uint32_t key = 0, inv = 0;
    if (i < n) {
      key = order_key(pv[i]);
      inv = ~static_cast<uint32_t>(pi[i]);
    }
    const bool ok = i < n && (key > vcut || (key == vcut && inv >= icut));
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    int at = 0;
    if (lane == 0 && m != 0) at = atomicAdd(&taken, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(m & ((1u << lane) - 1u));
    if (ok) sel_keys[at] = (static_cast<unsigned long long>(key) << 32) | inv;
  }
  __syncthreads();
  const int m = taken;  // min(n, k)
  for (int j = m + threadIdx.x; j < sort_n; j += blockDim.x) sel_keys[j] = 0ull;
  __syncthreads();
  bitonic_desc(sel_keys, sort_n);
  const float qs = q_scale != nullptr ? q_scale[q] : 1.0f;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float v = NEG;
    long long ix = 0;
    if (j < m) {
      const unsigned long long key = sel_keys[j];
      v = key_value(static_cast<uint32_t>(key >> 32));
      ix = static_cast<long long>(~static_cast<uint32_t>(key));
    }
    out_v[static_cast<long long>(q) * k + j] =
        (q_scale != nullptr && v > NEG) ? __fmul_rn(v, qs) : v;
    out_i[static_cast<long long>(q) * k + j] = ix;
  }
}

// Warps of merge_lists_kernel for lists of k: as many as shared memory holds
// (16 k bytes each), at most 32.
inline int merge_lists_warps(int k) {
  const int w = SMEM_LIMIT / (16 * k);
  return w < 32 ? w : 32;
}

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
// (no link against libcuda).
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline int tensor_map_encoder(EncodeTiledFn* out) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    cached = reinterpret_cast<EncodeTiledFn>(fn);
  }
  *out = cached;
  return 0;
}

// The list length the stream kernels are built with for a call's k: 1, 2,
// 3, 4, 8 and 16 entries in registers or shared memory, and past KSHARED
// lists in device memory (DEVICE_LISTS). On an H100 the device lists beat
// lists of 32 and 64 in shared memory at k = 33 and 64, and lose to the
// list of 16 at k = 16 (PERF.md); ops/gallery_kernel.py holds the same rule.
// The pool route (`launch_pool_topk`) keeps the device lists' layout.
inline int list_length(int k) {
  if (k > KSHARED) return DEVICE_LISTS;
  if (k <= 4) return k;
  int kl = KREG;
  while (kl < k) kl *= 2;
  return kl;
}

// The merge kernel after a stream kernel. Short lists: one block per query,
// one thread per block list, rounded up to whole warps. Lists in device
// memory: one block per query, merge_lists_warps(k) warps (`skip` as in
// merge_lists_kernel).
inline cudaError_t launch_merge(float* part_v, int* part_i, float* out_v,
                                long long* out_i, const float* q_scale,
                                const float* skip, int grid_x, int kl, int Q,
                                int k, cudaStream_t st) {
  if (kl == DEVICE_LISTS) {
    const int warps = merge_lists_warps(k);
    const int smem = warps * 16 * k;
    const cudaError_t err = cudaFuncSetAttribute(
        merge_lists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    merge_lists_kernel<<<Q, 32 * warps, smem, st>>>(part_v, part_i, out_v,
                                                    out_i, q_scale, skip,
                                                    2 * grid_x, k);
    return cudaGetLastError();
  }
  if (grid_x > 1024) return cudaErrorInvalidValue;
  const int threads = 32 * ((grid_x + 31) / 32);
  merge_topk_kernel<<<Q, threads, 0, st>>>(part_v, part_i, out_v, out_i,
                                           q_scale, grid_x, kl, Q, k);
  return cudaGetLastError();
}

template <typename Tr, int KL>
cudaError_t launch_stream(const CUtensorMap& gmap,
                          const typename Tr::QIn* queries, const float* scales,
                          const unsigned char* valid, float* part_v,
                          int* part_i, const Walk& wk, int Q, int G, int D,
                          int k, int grid_x, int stages, int smem_bytes,
                          cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      stream_topk_kernel<Tr, KL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (Q + Tr::QT - 1) / Tr::QT;
  stream_topk_kernel<Tr, KL><<<dim3(grid_x, q_tiles), THREADS, smem_bytes, st>>>(
      gmap, queries, scales, valid, part_v, part_i, wk, Q, G, D, k, stages);
  return cudaGetLastError();
}

// The checks every launch shares and the gallery's tensor map: 0, a
// cudaError_t, or ENCODE_FAILED + the CUresult.
template <typename Tr>
int prepare_stream(const void* gallery, int Q, int G, int D, int k, int grid_x,
                   int stages, int smem_bytes, int kl, CUtensorMap* gmap) {
  if (Q <= 0 || G <= 0 || D <= 0 || D % 32 != 0 || k < 1 || k > KMAX ||
      grid_x < 1 || stages < MIN_STAGES || stages > MAX_STAGES ||
      stages % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(smem_bytes) != Layout<Tr>::bytes(D, kl, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode = nullptr;
  const int found = tensor_map_encoder(&encode);
  if (found != 0) return found;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * Tr::ELEM};
  const cuuint32_t box[2] = {PANEL_BYTES / Tr::ELEM, TM};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult enc = encode(
      gmap, Tr::MAP_TYPE, 2, const_cast<void*>(gallery), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (enc != CUDA_SUCCESS) return ENCODE_FAILED + static_cast<int>(enc);
  return 0;
}

// Launch both kernels on `stream`. grid_x blocks share the gallery tiles of
// each query tile; part_v / part_i hold Q * grid_x * list_length(k)
// entries, or Q * 2 * grid_x * k with lists in device memory; `stages` and
// `smem_bytes` come from gallery_launch_geometry; `q_scale` [Q] or null
// multiplies the finished scores (see merge_topk_kernel). Returns 0, the
// cudaError_t of the first failure, or ENCODE_FAILED + the CUresult of the
// tensor map.
template <typename Tr>
int launch_stream_topk(const typename Tr::QIn* queries, const void* gallery,
                       const float* scales, const unsigned char* valid,
                       float* part_v, int* part_i, float* out_v,
                       long long* out_i, const float* q_scale, int Q, int G,
                       int D, int k, int grid_x, int stages,
                       int smem_bytes, void* stream) {
  const int kl = list_length(k);
  CUtensorMap gmap;
  const int prep = prepare_stream<Tr>(gallery, Q, G, D, k, grid_x, stages,
                                      smem_bytes, kl, &gmap);
  if (prep != 0) return prep;
  const Walk every{nullptr, nullptr, Pool{nullptr, nullptr, nullptr, 0},
                   (static_cast<long long>(G) + TM - 1) / TM};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define FRP_LAUNCH(KL)                                                        \
  case KL:                                                                    \
    err = launch_stream<Tr, KL>(gmap, queries, scales, valid, part_v, part_i, \
                                every, Q, G, D, k, grid_x, stages,            \
                                smem_bytes, st);                              \
    break
  switch (kl) {
    FRP_LAUNCH(DEVICE_LISTS);
    FRP_LAUNCH(1);
    FRP_LAUNCH(2);
    FRP_LAUNCH(3);
    FRP_LAUNCH(4);
    FRP_LAUNCH(8);
    FRP_LAUNCH(16);
  }
#undef FRP_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge(part_v, part_i, out_v, out_i, q_scale,
                                       nullptr, grid_x, kl, Q, k, st));
}

// Where the pool route keeps its state in device memory (the wrapper
// allocates it, gallery_launch_geometry sizes it): the sample [Q,
// sample_tiles * TM], T_q [Q], the unresolved route's starting thresholds
// [Q], the cursors [Q], the pools [Q, cap] (values, indices), that route's
// lists [Q, 2 grid_x_u, k] (values, indices), and the running count of
// unresolved queries.
struct PoolScratch {
  float* sample;
  float* thr;
  float* thr_unres;
  int* cursor;
  float* pool_v;
  int* pool_i;
  float* part_v;
  int* part_i;
  unsigned long long* unresolved;
};

// The pool route (stages 1-4 above) on `stream`, six launches and no host
// synchronisation: the sample pass on min(grid_x, sample_tiles) blocks per
// query tile, its select (T_q at `rank`), the gather pass on grid_x blocks,
// the select of the pools (sort over `sort_n`, a power of two >= k), the
// device lists of the unresolved queries on grid_x_u blocks per query tile
// and their merge. k in (KSHARED, KMAX], 1 <= sample_tiles <= the gallery's
// tiles, 1 <= rank <= SELECT_THREADS, cap >= k; `force` sends every query to
// the unresolved route. Returns as launch_stream_topk.
template <typename Tr>
int launch_pool_topk(const typename Tr::QIn* queries, const void* gallery,
                     const float* scales, const unsigned char* valid,
                     const PoolScratch& w, float* out_v, long long* out_i,
                     const float* q_scale, int Q, int G, int D, int k,
                     int grid_x, int grid_x_u, int stages, int smem_bytes,
                     int sample_tiles, int rank, int cap, int sort_n, int force,
                     void* stream) {
  const long long n_tiles = (static_cast<long long>(G) + TM - 1) / TM;
  if (k <= KSHARED || grid_x_u < 1 || sample_tiles < 1 || sample_tiles > n_tiles ||
      rank < 1 || rank > SELECT_THREADS || cap < k || sort_n < k ||
      sort_n > 2 * KMAX || (sort_n & (sort_n - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap gmap;
  const int prep = prepare_stream<Tr>(gallery, Q, G, D, k, grid_x, stages,
                                      smem_bytes, DEVICE_LISTS, &gmap);
  if (prep != 0) return prep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Pool none{nullptr, nullptr, nullptr, 0};
  // 1. the sample and T_q
  const Walk sample{nullptr, w.sample, none, sample_tiles};
  cudaError_t err = launch_stream<Tr, SAMPLE>(
      gmap, queries, scales, valid, nullptr, nullptr, sample, Q, G, D, k,
      grid_x < sample_tiles ? grid_x : sample_tiles, stages, smem_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  sample_threshold_kernel<<<Q, SELECT_THREADS, 0, st>>>(
      w.sample, sample_tiles * TM, rank, w.thr, w.cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 2. the gather pass
  const Walk gather{w.thr, nullptr, Pool{w.pool_v, w.pool_i, w.cursor, cap}, n_tiles};
  err = launch_stream<Tr, GATHER>(gmap, queries, scales, valid, nullptr, nullptr,
                                  gather, Q, G, D, k, grid_x, stages, smem_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 3. the select
  const int sel_smem = sort_n * 8;
  err = cudaFuncSetAttribute(select_pool_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, sel_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_pool_kernel<<<Q, SELECT_THREADS, sel_smem, st>>>(
      w.pool_v, w.pool_i, w.cursor, w.thr, cap, k, sort_n, q_scale, out_v, out_i,
      w.thr_unres, w.unresolved, force);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // 4. the unresolved queries on the device lists, and their merge
  const Walk unresolved{w.thr_unres, nullptr, none, n_tiles};
  err = launch_stream<Tr, DEVICE_LISTS>(gmap, queries, scales, valid, w.part_v,
                                        w.part_i, unresolved, Q, G, D, k, grid_x_u,
                                        stages, smem_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge(w.part_v, w.part_i, out_v, out_i, q_scale,
                                       w.thr_unres, grid_x_u, DEVICE_LISTS, Q, k, st));
}

}  // namespace frp
