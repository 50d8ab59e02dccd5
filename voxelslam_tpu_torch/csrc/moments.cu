// Voxel-moment accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_kernel` launched by
// `accumulate` in voxelslam_tpu/ops/moments.py (pallas_call at :103,
// body :64-84). For each map level l and point i it adds the packed
// 16-channel row upds[l, i] = w [1, q(3), qq^T packed(6), nv(5), 0] into
// row slots[l, i] of level l's (C_l, 16) table, every table starting at
// zero. Slots outside [0, C_l) are dropped, like XLA's mode="drop".
//
// Bound: bytes. A call must read L*P*(4 + 64) bytes and write
// sum_l C_l * 64 bytes (7.65 MB at the bench shapes, 2.28 us at
// 3.35 TB/s), and does one f32 add per input float, far below any compute
// peak. There is no product, so no tensor core applies. Every row is
// summed in ascending point index, so the tables are bitwise equal to a
// sequential scatter-add (the CPU's index_add_) and repeatable, with no
// atomics in global memory. The design:
//
//  * One block per tile of R_l consecutive rows of level l. The host picks
//    R_l (a multiple of 8, at most TILE = 256) so that a block expects
//    about TARGET = 32 points: dense levels get short tiles, so no block
//    sums far more than the rest. At the bench shapes that is 512 blocks,
//    four on most SMs, all resident at once.
//  * A. The block reads its level's P slots, CHUNK = THREADS * ITEMS at a
//    time with 16-byte loads, and keeps those in its tile: a min over a
//    thread's ITEMS rejects most threads in one test, a block-wide
//    exclusive scan places the rest, and the tile's points land in a
//    shared list in ascending index.
//  * B. 256 list entries at a time, one a thread, the block loads the
//    points' update rows and drops exact-zero rows. A row whose 16 values
//    are all +-0.0 adds nothing bitwise: a sum that starts at +0.0 never
//    becomes -0.0 under round-to-nearest, so adding +-0.0 leaves it as it
//    is. That drops the padded points the map insert sends to slot 0 with
//    w = 0 (about a thousand a scan). A second scan packs the kept rows
//    into a shared stash, still in list order; a sub-pass that keeps
//    none (those padded points) goes straight on to the next.
//  * C. The tile lives in shared memory. Warp w adds the stashed rows of
//    the table rows it owns (row % 8 == w), 32 at a time in list order;
//    lanes of a batch that hold one row find each other with one ballot
//    per row bit, and the lowest of them adds the group's rows in lane
//    order. Each row thus takes its points in ascending index.
//  * The block writes its tile once, zeros included (the output needs no
//    memset), with 16-byte coalesced stores.
// Measured and not kept (PERF.md): a counting sort of the kept points by
// row with 4 threads summing each row, thread block clusters sharing one
// read of the slots, zero rows stored early, one bulk copy (cp.async.bulk)
// of the tile in place of the coalesced stores, and other TILE and TARGET.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;                      // channels per row
constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 256;                   // most table rows a block
constexpr int TARGET = 32;                  // points a block aims at
constexpr int ITEMS = 16;                   // slots a thread per pass
constexpr int CHUNK = THREADS * ITEMS;      // points per pass
constexpr int SUB = THREADS;                // list entries per sub-pass
constexpr int PAIRS = TILE * 4 / THREADS;   // float4s of the tile a thread
constexpr unsigned FULL = 0xffffffffu;

constexpr int bits_for(int n) { return n <= 1 ? 0 : 1 + bits_for((n + 1) / 2); }
constexpr int ROW_BITS = bits_for(TILE);    // bits of a row within a tile

static_assert(TILE % 8 == 0 && (TILE * 4) % THREADS == 0 && TILE <= 4096,
              "TILE: a multiple of 8 and of THREADS / 4, at most 4096");
static_assert(CHUNK <= 65536, "list entries are 16-bit chunk offsets");

// shared memory, in bytes: the tile, the stashed update rows, the list of
// the tile's points (chunk offsets) and their rows, the kept rows' table
// rows, the scans' warp sums (the tile scan's, then two that sub-passes
// take in turn)
constexpr int TILE_OFF = 0;
constexpr int STASH_OFF = TILE_OFF + TILE * CH * 4;
constexpr int PT_OFF = STASH_OFF + SUB * CH * 4;
constexpr int ROW_OFF = PT_OFF + CHUNK * 2;
constexpr int KROW_OFF = ROW_OFF + CHUNK * 2;
constexpr int WSUM_OFF = KROW_OFF + SUB * 2;
constexpr int SMEM_BYTES = WSUM_OFF + 3 * WARPS * 4;

struct Caps {
  int L;
  int cap[MAX_LEVELS];
  int rows[MAX_LEVELS];     // table rows a block: a multiple of 8, <= TILE
};

// Exclusive block-wide prefix sum of v; *total gets the block's sum. Holds
// one __syncthreads. Two scans in a row need distinct `wsum` buffers.
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

// The lanes of the warp that are `valid` and hold the same row (0 for an
// invalid lane): one ballot per bit of the row.
__device__ __forceinline__ unsigned same_row(unsigned row, bool valid) {
  unsigned peers = __ballot_sync(FULL, valid);
#pragma unroll
  for (int b = 0; b < ROW_BITS; ++b) {
    const bool bit = (row >> b) & 1u;
    const unsigned m = __ballot_sync(FULL, bit);
    peers &= bit ? m : ~m;
  }
  return valid ? peers : 0u;
}

__device__ __forceinline__ void add4(float4& a, const float4 v) {
  a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
}

__global__ void __launch_bounds__(THREADS)
accumulate_kernel(const int* __restrict__ slots,
                  const float* __restrict__ upds,
                  float* __restrict__ out, int P, Caps caps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_tile = reinterpret_cast<float4*>(smem + TILE_OFF);   // [TILE][4]
  float4* s_stash = reinterpret_cast<float4*>(smem + STASH_OFF); // [SUB][4]
  unsigned short* s_pt = reinterpret_cast<unsigned short*>(smem + PT_OFF);
  unsigned short* s_row = reinterpret_cast<unsigned short*>(smem + ROW_OFF);
  unsigned short* s_krow = reinterpret_cast<unsigned short*>(smem + KROW_OFF);
  int* s_wsum = reinterpret_cast<int*>(smem + WSUM_OFF);        // 3 x WARPS

  // which level and which tile of it this block owns
  int b = blockIdx.x;
  int l = 0;
  long long row_base = 0;                         // first row of level l
  for (; l < caps.L; ++l) {
    const int ntiles = (caps.cap[l] + caps.rows[l] - 1) / caps.rows[l];
    if (b < ntiles) break;
    b -= ntiles;
    row_base += caps.cap[l];
  }
  const int row0 = b * caps.rows[l];
  const unsigned nrows = (unsigned)min(caps.rows[l], caps.cap[l] - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int* lslots = slots + (long long)l * P;
  const float4* lupd = reinterpret_cast<const float4*>(upds)
                       + (long long)l * P * (CH / 4);
  const bool vec = (reinterpret_cast<uintptr_t>(lslots) & 15) == 0;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
  for (int pr = 0; pr < PAIRS; ++pr) s_tile[tid + pr * THREADS] = zero4;

  for (int base = 0; base < P; base += CHUNK) {
    // A. the chunk's points that fall in the tile, in order
    const int first = base + tid * ITEMS;
    int sl[ITEMS];
    if (vec && first + ITEMS <= P) {
      const int4* p4 = reinterpret_cast<const int4*>(lslots + first);
#pragma unroll
      for (int j = 0; j < ITEMS / 4; ++j) {
        const int4 v = __ldg(p4 + j);
        sl[4 * j] = v.x; sl[4 * j + 1] = v.y;
        sl[4 * j + 2] = v.z; sl[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        sl[j] = first + j < P ? __ldg(lslots + first + j) : -1;
    }
    unsigned low = 0xffffffffu;                   // most threads: none
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      low = min(low, (unsigned)sl[j] - (unsigned)row0);
    unsigned mine = 0;
    if (low < nrows) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        mine |= (unsigned)((unsigned)sl[j] - (unsigned)row0 < nrows) << j;
    }
    int n_in;
    int off = block_exclusive_scan(__popc(mine), s_wsum, &n_in);
    if (mine) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (mine >> j & 1u) {
          s_pt[off] = (unsigned short)(tid * ITEMS + j);
          s_row[off] = (unsigned short)((unsigned)sl[j] - (unsigned)row0);
          ++off;
        }
      }
    }
    __syncthreads();
    const float4* cupd = lupd + (long long)base * (CH / 4);

    for (int e0 = 0, sub = 0; e0 < n_in; e0 += SUB, ++sub) {
      // B. one list entry a thread: load its row, drop it if all +-0.0,
      // stash the kept ones in list order
      const int e = e0 + tid;
      float4 u[4];
      bool keep = false;
      if (e < n_in) {
        const float4* src = cupd + (int)s_pt[e] * (CH / 4);
        unsigned any = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          u[q] = __ldg(src + q);
          any |= __float_as_uint(u[q].x) | __float_as_uint(u[q].y)
                 | __float_as_uint(u[q].z) | __float_as_uint(u[q].w);
        }
        keep = (any & 0x7fffffffu) != 0;
      }
      int n_kept;
      const int pos = block_exclusive_scan(
          keep, s_wsum + WARPS * (1 + (sub & 1)), &n_kept);
      // nothing kept (the padded points): on to the next sub-pass; its
      // scan takes the other warp sums, so none is overwritten unread
      if (n_kept == 0) continue;
      if (keep) {
#pragma unroll
        for (int q = 0; q < 4; ++q) s_stash[pos * 4 + q] = u[q];
        s_krow[pos] = s_row[e];
      }
      __syncthreads();

      // C. warp w adds the kept rows of the table rows it owns (row % WARPS
      // == w), 32 at a time in list order; the lowest lane of each group
      // on one row adds the group's rows in lane order
      for (int k0 = 0; k0 < n_kept; k0 += 32) {
        const int k = k0 + lane;
        const unsigned row = k < n_kept ? s_krow[k] : 0u;
        const bool own = k < n_kept && (int)(row % WARPS) == warp;
        unsigned peers = same_row(row, own);
        if (own && lane == __ffs(peers) - 1) {
          float4 a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) a[q] = s_tile[row * 4 + q];
          while (peers) {
            const int i = k0 + __ffs(peers) - 1;
            peers &= peers - 1;
#pragma unroll
            for (int q = 0; q < 4; ++q) add4(a[q], s_stash[i * 4 + q]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) s_tile[row * 4 + q] = a[q];
        }
      }
      __syncthreads();                // stash, list and warp sums reused
    }
  }

  // the tile, once, zeros included
  float4* out4 = reinterpret_cast<float4*>(out + (row_base + row0) * CH);
#pragma unroll
  for (int pr = 0; pr < PAIRS; ++pr) {
    const int p = tid + pr * THREADS;
    if ((unsigned)(p >> 2) < nrows) out4[p] = s_tile[p];
  }
}

}  // namespace

// C interface (bound with ctypes). slots (L, P) int32, upds (L, P, 16)
// f32, out (sum_l C_l, 16) f32, all contiguous on the device, upds and out
// 16-byte aligned; caps[l] = C_l, each a positive multiple of 8. Launches
// on `stream`; returns the cudaError_t of the launch.
extern "C" int vs_accumulate(const int* slots, const float* upds, float* out,
                             int P, int L, const int* caps_host,
                             void* stream) {
  if (L < 1 || L > MAX_LEVELS || P < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(upds) | reinterpret_cast<uintptr_t>(out))
      & 15)
    return (int)cudaErrorMisalignedAddress;
  Caps caps;
  caps.L = L;
  long long blocks = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) caps.cap[l] = caps.rows[l] = 0;
  for (int l = 0; l < L; ++l) {
    const int c = caps_host[l];
    if (c <= 0 || c % 8) return (int)cudaErrorInvalidValue;
    // about TARGET points a block if the slots spread evenly
    long long r = (long long)c * TARGET / P / 8 * 8;
    r = r < 8 ? 8 : (r > TILE ? TILE : r);
    caps.cap[l] = c;
    caps.rows[l] = (int)r;
    blocks += (c + r - 1) / r;
  }
  cudaError_t err = cudaFuncSetAttribute(
      accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  accumulate_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                      (cudaStream_t)stream>>>(slots, upds, out, P, caps);
  return (int)cudaGetLastError();
}
