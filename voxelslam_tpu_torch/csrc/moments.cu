// Voxel-moment accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_kernel` launched by
// `accumulate` in voxelslam_tpu/ops/moments.py (pallas_call at :103,
// body :64-84). For each map level l and point i it adds the packed
// 16-channel row upds[l, i] = w [1, q(3), qq^T packed(6), nv(5), 0] into
// row slots[l, i] of level l's (C_l, 16) table, every table starting at
// zero. Slots outside [0, C_l) are dropped, like XLA's mode="drop".
//
// Bound: memory. Per call it must read L*P*(4 + 64) bytes and write
// sum_l C_l * 64 bytes (6.8 MB of tables at the bench shapes), and does
// one add per input float, so bytes dominate by far.
//
// Design (owner computes, deterministic): the TPU kept whole tables in
// VMEM; a 64k-row table is 4 MB, far beyond the 227 KB of shared memory.
// Here one block owns a tile of ROWS table rows of one level (64 KB of
// shared memory), stages the level's slots in chunks, and walks the
// points in ascending index order; the thread that owns a row (row %
// THREADS) adds the point's four float4s. Each row's sum is therefore
// taken in ascending point order with no atomics: bitwise repeatable,
// and bitwise equal to a sequential scatter-add. The block then writes
// its whole tile, zeros included, so the output needs no memset. Every
// thread scans every point of its level, so the walk, not the bytes,
// bounds this first version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;          // channels per row
constexpr int ROWS = 1024;      // table rows per block: 64 KB of floats
constexpr int THREADS = 256;    // row r is owned by thread r % THREADS
constexpr int CHUNK = 1024;     // slots staged per pass
constexpr int MAX_LEVELS = 8;

struct Caps {
  int L;
  int cap[MAX_LEVELS];
};

__global__ void __launch_bounds__(THREADS)
accumulate_kernel(const int* __restrict__ slots,
                  const float* __restrict__ upds,
                  float* __restrict__ out, int P, Caps caps) {
  extern __shared__ float4 tile4[];              // ROWS * CH floats
  float* tile = reinterpret_cast<float*>(tile4);
  __shared__ int s_slot[CHUNK];

  // which level and which tile of it this block owns
  int b = blockIdx.x;
  int l = 0;
  long long row_base = 0;                         // first row of level l
  for (; l < caps.L; ++l) {
    const int ntiles = (caps.cap[l] + ROWS - 1) / ROWS;
    if (b < ntiles) break;
    b -= ntiles;
    row_base += caps.cap[l];
  }
  const int row0 = b * ROWS;
  const int nrows = min(ROWS, caps.cap[l] - row0);
  const int tid = threadIdx.x;

  for (int k = tid; k < nrows * (CH / 4); k += THREADS)
    tile4[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int* lslots = slots + (long long)l * P;
  const float4* lupds =
      reinterpret_cast<const float4*>(upds + (long long)l * P * CH);

  for (int base = 0; base < P; base += CHUNK) {
    const int n = min(CHUNK, P - base);
    __syncthreads();                              // tile zeroed / chunk done
    for (int j = tid; j < n; j += THREADS) s_slot[j] = lslots[base + j];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int r = s_slot[j] - row0;
      if ((unsigned)r < (unsigned)nrows && (r % THREADS) == tid) {
        const float4* u = lupds + (long long)(base + j) * (CH / 4);
        float4* dst = tile4 + r * (CH / 4);
#pragma unroll
        for (int q = 0; q < CH / 4; ++q) {
          const float4 v = u[q];
          float4 a = dst[q];
          a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
          dst[q] = a;
        }
      }
    }
  }
  __syncthreads();

  float4* out4 = reinterpret_cast<float4*>(out + (row_base + row0) * CH);
  for (int k = tid; k < nrows * (CH / 4); k += THREADS) out4[k] = tile4[k];
}

}  // namespace

// C interface (bound with ctypes). slots (L, P) int32, upds (L, P, 16)
// f32, out (sum_l C_l, 16) f32, all contiguous on the device; caps[l] =
// C_l. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int vs_accumulate(const int* slots, const float* upds, float* out,
                             int P, int L, const int* caps_host,
                             void* stream) {
  if (L < 1 || L > MAX_LEVELS || P < 1) return (int)cudaErrorInvalidValue;
  Caps caps;
  caps.L = L;
  int blocks = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) caps.cap[l] = 0;
  for (int l = 0; l < L; ++l) {
    caps.cap[l] = caps_host[l];
    blocks += (caps_host[l] + ROWS - 1) / ROWS;
  }
  const int smem = ROWS * CH * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  accumulate_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      slots, upds, out, P, caps);
  return (int)cudaGetLastError();
}
