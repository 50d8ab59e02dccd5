// Scatter-add in a fixed order for Hopper (sm_90a), with no sort.
//
// The port's counterpart of XLA's scatter-add `buf.at[idx].add(val,
// mode="drop")` along dim 0 (e.g. voxelslam_tpu/ops/downsample.py:33),
// whose order on the TPU is fixed; it replaces no Pallas kernel. For
// r < C it computes
//
//     out[r, d] = (((buf[r, d] + val[s0, d]) + val[s1, d]) + ...)
//
// over the sources s0 < s1 < ... with idx[s] == r, each add rounded on its
// own (__fadd_rn / __dadd_rn, never contracted into an FMA): bitwise the
// CPU's sequential index_add_, run to run, with no atomics on floats.
// Indices outside [0, C) (index C, the dropped row) add nothing.
//
// Bound: bytes. A call must read idx, val and buf and write out: at the
// main path's shape (the downsample's C = N = 4,096, D = 4, f32, int64
// idx) 32 + 64 + 64 + 64 KiB = 229,376 bytes, 0.068 us at 3.35 TB/s. It
// does one add per source value, far below any compute peak, and no
// product for a tensor core. The design (ops/segment_add.py `plan` picks
// the path and the sizes on the host):
//
//  * No sort. Path 1, one launch (sum_kernel alone): block b owns a tile of
//    R consecutive rows (a multiple of 8, at most 1,024, sized so that a
//    block expects about 32 sources and the tile fits shared memory),
//    which starts from buf's rows in shared memory. The block streams idx
//    in ascending source order, CHUNK = 4,096 at a time with 16-byte
//    loads, and keeps the sources that fall in its tile through a
//    block-wide exclusive scan: a stable partition, so the block's list is
//    in ascending source order. The tile's loads go out beside the first
//    pass's.
//  * C1. SUB <= 256 list entries at a time (one a thread), the block sorts
//    the entries by tile row, stably: lanes on one row find each other (a
//    ballot a bit of the row), each row's count (shared integer atomics,
//    exact in any order) and start (a scan), and an entry's place = its
//    row's start + its row's entries in earlier warps (per-warp counts) +
//    those in earlier lanes. No float moves in this step.
//  * B. Every thread loads the batch's val rows into a shared stash in that
//    row order, coalesced along D.
//  * C2. A group of LG lanes a row (LG the power of two >= D, at most 32), a
//    lane a column: one chain over the row's contiguous entries, 8 shared
//    loads ahead of 8 adds. A hot row is D chains of plain adds out of
//    shared memory, and at the narrow widths a warp sums several rows at
//    once (8 at D = 4) where the sort-and-search route's warp a row left
//    28 of 32 lanes idle.
//  * The block writes its tile once, coalesced, with 16-byte stores; a row
//    is packed by no other block, so the order is fixed by construction.
//  * Path 2, two launches, where the blocks together would read more of
//    idx than max(16 MiB, the call's own bytes) (large N): partition_kernel
//    cuts idx into P <= 256 chunks of S sources. Each block counts its
//    chunk's sources per bucket (the Rs consecutive rows of one sum block),
//    takes the exclusive scan, and places the sources in its chunk's region
//    of `part` in source order with C1's stable multi-split, per bucket.
//    sum_kernel's block b then reads bucket b's segment of every chunk, in
//    chunk order: its sources in ascending index, and sums them as in path
//    1; no block reads all of idx, and a bucket wider than one tile is
//    summed a tile at a time.
// Everything is sized from the shapes alone: no host read, no allocation
// that depends on the data, so a call captures into a CUDA graph.
// Measured and not kept (PERF.md): warps that each found the rows of every
// 32 list entries anew and added their own (a hot row paid that search a
// batch, not its adds), and the val rows loaded before C1 to overlap the
// sort (more registers a thread, slower).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                   // list entries a thread per pass
constexpr int CHUNK = THREADS * ITEMS;      // list entries per pass
constexpr int PITEMS = 8;                   // sources a thread per round
constexpr int PROUND = THREADS * PITEMS;    // of partition_kernel
constexpr int PMAX = 256;                   // partition chunks at most
constexpr int BMAX = 4096;                  // buckets (sum blocks) of path 2
constexpr int RMAX = 1024;                  // tile rows (the batch sort's)
constexpr int SMEM_MAX = 232448;            // shared bytes a block (H100)
constexpr unsigned FULL = 0xffffffffu;

static_assert(PMAX <= THREADS, "one partition chunk a thread");

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__host__ __device__ constexpr long long align16(long long x) {
  return (x + 15) & ~15LL;
}

// sum_kernel's shared memory, in bytes (ops/segment_add.py `_smem_sum`
// mirrors it): the tile, the stash, the list's sources and rows, the
// chunks' list starts and part offsets, the scans' warp sums, and for the
// sort of a stash batch by row: the rows' counts and starts, per-warp
// counts, and the batch's sources in row order
struct Layout {
  long long tile, stash, src, row, seg, wsum, cnt, start, wc, ssrc, total;
};

__host__ __device__ inline Layout layout(int R, int D, int esz, int sub) {
  Layout L;
  L.tile = 0;
  L.stash = align16(L.tile + (long long)R * D * esz);
  L.src = align16(L.stash + (long long)sub * D * esz);
  L.row = align16(L.src + (long long)CHUNK * 4);
  L.seg = align16(L.row + (long long)CHUNK * 2);
  L.wsum = align16(L.seg + (long long)(2 * PMAX + 1) * 4);
  L.cnt = align16(L.wsum + (long long)WARPS * 4);
  L.start = align16(L.cnt + (long long)R * 4);
  L.wc = align16(L.start + (long long)(R + 1) * 4);
  L.ssrc = align16(L.wc + (long long)WARPS * R);
  L.total = align16(L.ssrc + (long long)sub * 4);
  return L;
}

// partition_kernel's: counts (then cursors), per-warp counts, warp sums
__host__ __device__ inline long long part_smem(int B) {
  return align16(align16((long long)B * 4 + (long long)WARPS * B)
                 + (long long)WARPS * 4);
}

struct Args {
  long long C;    // rows
  int D;          // columns
  int N;          // sources
  int R;          // rows a tile (a multiple of 8)
  int Rs;         // rows a sum block (R on path 1)
  int B;          // sum blocks
  int sub;        // stash entries
  int lg;         // lanes a row group (a power of two, <= 32)
  int P;          // partition chunks (0: path 1)
  int S;          // sources a chunk
  int zero;       // buf is all +0.0 and is not read
};

// Exclusive block-wide prefix sum of v; *total gets the block's sum. Holds
// one __syncthreads; a later scan may rewrite `wsum` only after another.
__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int s = wsum[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + x - v;
}

// The lanes among `mask` whose v has the same bits [lo, hi) as this lane's:
// one ballot a bit. Every lane of the warp must call it.
__device__ __forceinline__ unsigned same_bits(unsigned v, int lo, int hi,
                                              unsigned mask) {
  for (int b = lo; b < hi; ++b) {
    const bool bit = (v >> b) & 1u;
    const unsigned m = __ballot_sync(FULL, bit);
    mask &= bit ? m : ~m;
  }
  return mask;
}

// ITEMS consecutive indices from `first` (-1 past m); 16-byte loads where
// the pointer allows
__device__ __forceinline__ void load_rows(const int* idx, int first, int m,
                                          bool vec, long long* r) {
  if (vec && first + ITEMS <= m) {
    const int4* q = reinterpret_cast<const int4*>(idx + first);
#pragma unroll
    for (int j = 0; j < ITEMS / 4; ++j) {
      const int4 v = __ldg(q + j);
      r[4 * j] = v.x; r[4 * j + 1] = v.y; r[4 * j + 2] = v.z;
      r[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      r[k] = first + k < m ? (long long)__ldg(idx + first + k) : -1LL;
  }
}

__device__ __forceinline__ void load_rows(const long long* idx, int first,
                                          int m, bool vec, long long* r) {
  if (vec && first + ITEMS <= m) {
    const longlong2* q = reinterpret_cast<const longlong2*>(idx + first);
#pragma unroll
    for (int j = 0; j < ITEMS / 2; ++j) {
      const longlong2 v = __ldg(q + j);
      r[2 * j] = v.x; r[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      r[k] = first + k < m ? __ldg(idx + first + k) : -1LL;
  }
}

// row's offset in the tile [row0, row0 + nrows), or ~0u outside it
__device__ __forceinline__ unsigned in_tile(long long row, long long row0,
                                            int nrows) {
  const unsigned long long rel = (unsigned long long)row
                                 - (unsigned long long)row0;
  return rel < (unsigned long long)nrows ? (unsigned)rel : ~0u;
}

// the tile's nel elements between device and shared memory, 16 bytes a
// thread where both ends are aligned (the tile starts 16-byte aligned)
template <typename T>
__device__ __forceinline__ void tile_in(T* s, const T* g, int nel,
                                        bool zero) {
  const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const int n16 = vec ? nel * (int)sizeof(T) / 16 : 0;
  const int tail = n16 * 16 / (int)sizeof(T);
  float4* s4 = reinterpret_cast<float4*>(s);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int x = threadIdx.x; x < n16; x += THREADS)
    s4[x] = zero ? make_float4(0.f, 0.f, 0.f, 0.f) : __ldg(g4 + x);
  for (int x = tail + threadIdx.x; x < nel; x += THREADS)
    s[x] = zero ? T(0) : g[x];
}

template <typename T>
__device__ __forceinline__ void tile_out(T* g, const T* s, int nel) {
  const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const int n16 = vec ? nel * (int)sizeof(T) / 16 : 0;
  const int tail = n16 * 16 / (int)sizeof(T);
  const float4* s4 = reinterpret_cast<const float4*>(s);
  float4* g4 = reinterpret_cast<float4*>(g);
  for (int x = threadIdx.x; x < n16; x += THREADS) g4[x] = s4[x];
  for (int x = tail + threadIdx.x; x < nel; x += THREADS) g[x] = s[x];
}

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
sum_kernel(const T* __restrict__ buf, const T* __restrict__ val,
           const I* __restrict__ idx, const int2* __restrict__ part,
           const int* __restrict__ loff, T* __restrict__ out, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a.R, a.D, (int)sizeof(T), a.sub);
  T* s_tile = reinterpret_cast<T*>(smem + L.tile);
  T* s_stash = reinterpret_cast<T*>(smem + L.stash);
  int* s_src = reinterpret_cast<int*>(smem + L.src);
  unsigned short* s_row = reinterpret_cast<unsigned short*>(smem + L.row);
  int* s_seg = reinterpret_cast<int*>(smem + L.seg);     // [PMAX + 1]
  int* s_base = s_seg + PMAX + 1;                         // [PMAX]
  int* s_wsum = reinterpret_cast<int*>(smem + L.wsum);
  int* s_cnt = reinterpret_cast<int*>(smem + L.cnt);         // [R], zero
  int* s_start = reinterpret_cast<int*>(smem + L.start);     // [R + 1]
  unsigned char* s_wc = smem + L.wc;                          // [WARPS][R]
  int* s_ssrc = reinterpret_cast<int*>(smem + L.ssrc);       // [sub]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D;
  // lane groups: lg lanes a row, a lane a column; NG groups a block
  const int NG = WARPS * (32 / a.lg);
  const int gid = tid / a.lg, c0 = lane & (a.lg - 1);
  const long long brow0 = (long long)blockIdx.x * a.Rs;
  const long long brow1 = min(a.C, brow0 + a.Rs);
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const int rbits = 32 - __clz(a.R - 1);        // bits of a tile row
  for (int x = tid; x < a.R; x += THREADS) s_cnt[x] = 0;
  for (int x = tid; x < WARPS * a.R; x += THREADS) s_wc[x] = 0;

  // the block's list: every source (path 1), or bucket blockIdx.x's
  // segment of each chunk, in chunk order (path 2)
  int m = a.N;
  if (a.P > 0) {
    int len = 0;
    if (tid < a.P) {
      const int* lo = loff + (long long)tid * (a.B + 1) + blockIdx.x;
      s_base[tid] = tid * a.S + lo[0];
      len = lo[1] - lo[0];
    }
    const int start = block_exclusive_scan(len, s_wsum, &m);
    if (tid < a.P) s_seg[tid] = start;
    if (tid == 0) s_seg[a.P] = m;
    __syncthreads();
  }

  for (long long row0 = brow0; row0 < brow1; row0 += a.R) {
    const int nrows = (int)min((long long)a.R, brow1 - row0);
    const int nel = nrows * D;
    if (m == 0) {
      tile_in(s_tile, buf + row0 * D, nel, a.zero != 0);
      __syncthreads();
    }
    for (int j0 = 0; j0 < m; j0 += CHUNK) {
      // A. this pass's list entries that fall in the tile, in order
      const int first = j0 + tid * ITEMS;
      int src[ITEMS];
      long long r[ITEMS];                          // rows (-1: none)
      if (a.P == 0) {
        load_rows(idx, first, m, vec, r);
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) src[k] = first + k;
      } else {
        int at[ITEMS];                          // where entry j lies in part
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const int j = first + k;
          at[k] = -1;
          if (j < m) {
            int lo = 0, hi = a.P - 1;             // last chunk starting <= j
            while (lo < hi) {
              const int mid = (lo + hi + 1) >> 1;
              if (s_seg[mid] <= j) lo = mid; else hi = mid - 1;
            }
            at[k] = s_base[lo] + (j - s_seg[lo]);
          }
        }
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {         // every load at once
          const int2 e = at[k] >= 0 ? __ldg(part + at[k]) : make_int2(0, -1);
          src[k] = e.x;
          r[k] = e.y;
        }
      }
      // the tile's loads go out beside this pass's (the scan's barrier
      // orders them before any add)
      if (j0 == 0) tile_in(s_tile, buf + row0 * D, nel, a.zero != 0);
      unsigned rel[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) rel[k] = in_tile(r[k], row0, nrows);
      unsigned low = ~0u;                        // most threads: none
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) low = min(low, rel[k]);
      unsigned mine = 0;
      if (low != ~0u) {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) mine |= (unsigned)(rel[k] != ~0u) << k;
      }
      int n_in;
      int off = block_exclusive_scan(__popc(mine), s_wsum, &n_in);
      if (mine) {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          if (mine >> k & 1u) {
            s_src[off] = src[k];
            s_row[off] = (unsigned short)rel[k];
            ++off;
          }
        }
      }
      __syncthreads();
      for (int e0 = 0; e0 < n_in; e0 += a.sub) {
        // C1. the batch's entries (one a thread) sorted by tile row,
        // stably: lanes on one row find each other (a ballot a bit of
        // the row), each row's count, the rows' starts (a scan), and an
        // entry's place = its row's start + the entries of its row in
        // earlier warps + those in earlier lanes
        const int ns = min(a.sub, n_in - e0);
        const bool valid = tid < ns;
        const unsigned row = valid ? s_row[e0 + tid] : 0u;
        unsigned peers =
            same_bits(row, 0, rbits, __ballot_sync(FULL, valid));
        if (!valid) peers = 0u;
        const bool lead = valid && lane == __ffs(peers) - 1;
        if (lead) {
          s_wc[warp * a.R + row] = (unsigned char)__popc(peers);
          atomicAdd(&s_cnt[row], __popc(peers));
        }
        __syncthreads();
        {
          const int per = (nrows + THREADS - 1) / THREADS;
          int sum = 0;
          for (int i = 0; i < per; ++i) {
            const int r = tid * per + i;
            if (r < nrows) sum += s_cnt[r];
          }
          int total;
          int pre = block_exclusive_scan(sum, s_wsum, &total);
          for (int i = 0; i < per; ++i) {
            const int r = tid * per + i;
            if (r < nrows) {
              const int c = s_cnt[r];
              s_start[r] = pre;
              s_cnt[r] = 0;                        // zero for the next batch
              pre += c;
            }
          }
          if (tid == 0) s_start[nrows] = total;
        }
        __syncthreads();
        if (valid) {
          int pos = s_start[row] + __popc(peers & ((1u << lane) - 1u));
          for (int w = 0; w < warp; ++w) pos += s_wc[w * a.R + row];
          s_ssrc[pos] = s_src[e0 + tid];
        }
        __syncthreads();
        if (lead) s_wc[warp * a.R + row] = 0;   // read by all, so zeroed now
        // B. the val rows of the batch, in row order, coalesced along D
        const int nv = ns * D;
        for (int x0 = tid; x0 < nv; x0 += 4 * THREADS) {   // 4 loads in flight
          T v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int x = x0 + j * THREADS;
            if (x < nv) {
              const int k = x / D;
              v[j] = __ldg(val + (long long)s_ssrc[k] * D + (x - k * D));
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (x0 + j * THREADS < nv) s_stash[x0 + j * THREADS] = v[j];
        }
        __syncthreads();
        // C2. a lane group a row, a lane a column: one chain over the
        // row's contiguous entries, 8 loads ahead of 8 adds
        for (int r = gid; r < nrows; r += NG) {
          const int b0 = s_start[r], n = s_start[r + 1] - b0;
          if (n == 0) continue;
          for (int d = c0; d < D; d += a.lg) {
            const T* sv = s_stash + b0 * D + d;
            T acc = s_tile[r * D + d];
            int j = 0;
            for (; j + 8 <= n; j += 8) {
              T v[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) v[i] = sv[(j + i) * D];
#pragma unroll
              for (int i = 0; i < 8; ++i) acc = add_rn(acc, v[i]);
            }
            for (; j < n; ++j) acc = add_rn(acc, sv[j * D]);
            s_tile[r * D + d] = acc;
          }
        }
        __syncthreads();               // stash, list, starts and tile reused
      }
    }
    tile_out(out + row0 * D, s_tile, nel);
    __syncthreads();                   // the tile is reloaded
  }
}

// The buckets (-1: none) and rows of sources base + k THREADS + tid,
// k < PITEMS, every load issued before any is used
template <typename I>
__device__ __forceinline__ void bucket_of(const I* idx, int base, int s1,
                                          unsigned C, unsigned Rs, int* bk,
                                          unsigned* row) {
  long long r[PITEMS];
#pragma unroll
  for (int k = 0; k < PITEMS; ++k) {
    const int s = base + k * THREADS + threadIdx.x;
    r[k] = s < s1 ? (long long)__ldg(idx + s) : -1LL;
  }
#pragma unroll
  for (int k = 0; k < PITEMS; ++k) {
    const unsigned long long u = (unsigned long long)r[k];
    row[k] = (unsigned)u;
    bk[k] = u < C ? (int)((unsigned)u / Rs) : -1;
  }
}

template <typename I>
__global__ void __launch_bounds__(THREADS)
partition_kernel(const I* __restrict__ idx, int2* __restrict__ part,
                 int* __restrict__ loff, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_cnt = reinterpret_cast<int*>(smem);                     // [B]
  unsigned char* s_wc = smem + (long long)a.B * 4;               // [WARPS][B]
  int* s_wsum = reinterpret_cast<int*>(
      smem + align16((long long)a.B * 4 + (long long)WARPS * a.B));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B;
  const int s0 = blockIdx.x * a.S;
  const int s1 = min(a.N, s0 + a.S);
  const unsigned C = (unsigned)a.C, Rs = (unsigned)a.Rs;
  const int bbits = 32 - __clz(max(B - 1, 1));   // bits of a bucket

  for (int x = tid; x < B; x += THREADS) s_cnt[x] = 0;
  for (int x = tid; x < WARPS * B; x += THREADS) s_wc[x] = 0;
  __syncthreads();
  // the chunk's sources per bucket, PITEMS loads a thread in flight
  for (int base = s0; base < s1; base += PROUND) {
    int bk[PITEMS];
    unsigned row[PITEMS];
    bucket_of(idx, base, s1, C, Rs, bk, row);
#pragma unroll
    for (int k = 0; k < PITEMS; ++k)
      if (bk[k] >= 0) atomicAdd(&s_cnt[bk[k]], 1);
  }
  __syncthreads();
  // exclusive scan over the buckets: thread t takes `per` of them
  const int per = (B + THREADS - 1) / THREADS;
  int sum = 0;
  for (int i = 0; i < per; ++i) {
    const int b = tid * per + i;
    if (b < B) sum += s_cnt[b];
  }
  int total;
  int pre = block_exclusive_scan(sum, s_wsum, &total);
  int* lo = loff + (long long)blockIdx.x * (B + 1);
  for (int i = 0; i < per; ++i) {
    const int b = tid * per + i;
    if (b < B) {
      const int c = s_cnt[b];
      s_cnt[b] = pre;                          // the bucket's cursor
      lo[b] = pre;
      pre += c;
    }
  }
  if (tid == 0) lo[B] = total;
  __syncthreads();
  // stable placement, THREADS sources a pass (one a thread), PITEMS
  // passes a round of loads
  int2* cpart = part + s0;
  for (int base = s0; base < s1; base += PROUND) {
    int bks[PITEMS];
    unsigned rows[PITEMS];
    bucket_of(idx, base, s1, C, Rs, bks, rows);
#pragma unroll
    for (int k = 0; k < PITEMS; ++k) {
      const int s = base + k * THREADS + tid;
      const int bk = bks[k];
      const unsigned row = rows[k];
      const unsigned valid = __ballot_sync(FULL, bk >= 0);
      unsigned peers = same_bits((unsigned)bk, 0, bbits, valid);   // all lanes
      if (bk < 0) peers = 0u;
      const bool lead = bk >= 0 && lane == __ffs(peers) - 1;
      if (lead) s_wc[warp * B + bk] = (unsigned char)__popc(peers);
      __syncthreads();
      if (bk >= 0) {
        int pos = s_cnt[bk] + __popc(peers & ((1u << lane) - 1u));
        for (int w = 0; w < warp; ++w) pos += s_wc[w * B + bk];
        cpart[pos] = make_int2(s, (int)row);
      }
      __syncthreads();
      if (lead) {                       // a bucket's leaders, one a warp
        atomicAdd(&s_cnt[bk], __popc(peers));
        s_wc[warp * B + bk] = 0;
      }
      __syncthreads();
    }
  }
}

template <typename T, typename I>
int launch(const void* buf, const void* val, const void* idx, void* part,
           void* loff, void* out, const Args& a, int smem, int smem_part,
           cudaStream_t stream) {
  cudaError_t err;
  if (a.P > 0) {
    err = cudaFuncSetAttribute(partition_kernel<I>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_part);
    if (err != cudaSuccess) return (int)err;
    partition_kernel<I><<<a.P, THREADS, smem_part, stream>>>(
        static_cast<const I*>(idx), static_cast<int2*>(part),
        static_cast<int*>(loff), a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(sum_kernel<T, I>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  sum_kernel<T, I><<<a.B, THREADS, smem, stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(val),
      static_cast<const I*>(idx), static_cast<const int2*>(part),
      static_cast<const int*>(loff), static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). buf and out (C, D), val (N, D), all of
// one float type of esz bytes (4: f32, 8: f64); idx (N,) of isz bytes (4:
// int32, 8: int64); all contiguous on the device. The plan (R, Rs, B, sub,
// lg, P, S and the shared bytes) comes from ops/segment_add.py `plan`; on
// path 2 (P > 0) `part` holds N int2 and `loff` P * (B + 1) ints of
// scratch. Launches P > 0 ? 2 : 1 kernels on `stream`; returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a bad plan).
extern "C" int vs_segment_add(const void* buf, const void* val,
                              const void* idx, void* part, void* loff,
                              void* out, long long C, int D, int N, int esz,
                              int isz, int R, int Rs, int B, int sub, int lg,
                              int P, int S, int zero, int smem,
                              int smem_part, void* stream) {
  if (C <= 0 || C > 0x7fffffffLL || D <= 0 || N < 0
      || N > 0x7fffffff - CHUNK || (esz != 4 && esz != 8)
      || (isz != 4 && isz != 8) || R < 8 || R % 8 || R > RMAX || Rs < R
      || B <= 0 || (long long)B * Rs < C || (long long)(B - 1) * Rs >= C
      || sub < 32 || sub % 32 || sub > THREADS || lg < 1 || lg > 32
      || (lg & (lg - 1))
      || P < 0 || P > PMAX)
    return (int)cudaErrorInvalidValue;
  if (smem < layout(R, D, esz, sub).total || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (P == 0 && Rs != R) return (int)cudaErrorInvalidValue;
  if (P > 0 && (B > BMAX || S <= 0 || (long long)P * S < N
                || part == nullptr || loff == nullptr
                || smem_part < part_smem(B) || smem_part > SMEM_MAX))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.C = C; a.D = D; a.N = N; a.R = R; a.Rs = Rs; a.B = B; a.sub = sub;
  a.lg = lg; a.P = P; a.S = S; a.zero = zero;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (esz == 4)
    return isz == 4
        ? launch<float, int>(buf, val, idx, part, loff, out, a, smem,
                             smem_part, st)
        : launch<float, long long>(buf, val, idx, part, loff, out, a, smem,
                                   smem_part, st);
  return isz == 4
      ? launch<double, int>(buf, val, idx, part, loff, out, a, smem,
                            smem_part, st)
      : launch<double, long long>(buf, val, idx, part, loff, out, a, smem,
                                  smem_part, st);
}
