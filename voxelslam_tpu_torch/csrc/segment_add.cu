// Segment sum in a fixed order for Hopper (sm_90a).
//
// The port's counterpart of XLA's scatter-add `buf.at[idx].add(val,
// mode="drop")` along dim 0, whose order on the TPU is fixed; it replaces
// no Pallas kernel. `ops/segment_add.py` sorts idx stably (torch.sort)
// and finds each destination row's first sorted entry (torch.searchsorted
// over 0..C), so that row r's sources are perm[starts[r] .. starts[r+1])
// in ascending source index. This kernel then computes
//
//     out[r, d] = (((buf[r, d] + val[s0, d]) + val[s1, d]) + ...)
//
// for r < C, the sources in that order: bitwise the CPU's sequential
// index_add_, run to run, with no atomics. Rows >= C (index C, the
// dropped row) are never written.
//
// Bound: bytes. A call must read the N source rows and their indices and
// the C buffer rows, and write C rows: one add per source value, far
// below any compute peak, and no product for a tensor core. The design:
// one warp per destination row, its lanes over the D columns (coalesced
// where D >= 32, a few idle lanes at the narrow widths the map uses), each
// lane a serial chain over the row's sources. A hot row is one long chain
// per column; the rows are independent, so C / 8 blocks of eight warps
// keep the card busy at the map's widths (C = 4,096 .. 1,000,000).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);                   // never contracted into an FMA
}

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
segment_add_kernel(const T* __restrict__ buf, const T* __restrict__ val,
                   const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ starts, T* __restrict__ out,
                   int64_t C, int D) {
  const int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= C) return;
  const int64_t b = starts[row];
  const int64_t e = starts[row + 1];
  for (int d = lane; d < D; d += 32) {
    T acc = buf[row * D + d];
    for (int64_t j = b; j < e; ++j) acc = add_rn(acc, val[perm[j] * D + d]);
    out[row * D + d] = acc;
  }
}

template <typename T>
int launch(const T* buf, const T* val, const int64_t* perm,
           const int64_t* starts, T* out, int64_t C, int D, void* stream) {
  if (C <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (C + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  segment_add_kernel<T><<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(buf, val, perm, starts,
                                                  out, C, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vs_segment_add_f32(const float* buf, const float* val,
                                  const int64_t* perm, const int64_t* starts,
                                  float* out, int64_t C, int D,
                                  void* stream) {
  return launch<float>(buf, val, perm, starts, out, C, D, stream);
}

extern "C" int vs_segment_add_f64(const double* buf, const double* val,
                                  const int64_t* perm, const int64_t* starts,
                                  double* out, int64_t C, int D,
                                  void* stream) {
  return launch<double>(buf, val, perm, starts, out, C, D, stream);
}
