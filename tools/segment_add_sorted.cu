// The sort-and-search route of segment_add, kept as a yardstick: not
// part of the port (voxelslam_tpu_torch/csrc/segment_add.cu replaces it).
// chip_smoke.py builds it (nvcc, sm_90a, ctypes) and times it beside the
// port's route in one call: a stable torch.sort of idx, torch.searchsorted
// over 0..C for each destination row's first sorted entry, so that row r's
// sources are perm[starts[r] .. starts[r+1]) in ascending source index,
// then this kernel:
//
//     out[r, d] = (((buf[r, d] + val[s0, d]) + val[s1, d]) + ...)
//
// for r < C, one warp a destination row, its lanes over the D columns,
// each lane a serial chain over the row's sources. Bitwise the CPU's
// sequential index_add_; rows >= C (index C, the dropped row) are never
// written.

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

extern "C" int vs_segment_add_sorted_f32(const float* buf, const float* val,
                                  const int64_t* perm, const int64_t* starts,
                                  float* out, int64_t C, int D,
                                  void* stream) {
  return launch<float>(buf, val, perm, starts, out, C, D, stream);
}

extern "C" int vs_segment_add_sorted_f64(const double* buf, const double* val,
                                  const int64_t* perm, const int64_t* starts,
                                  double* out, int64_t C, int D,
                                  void* stream) {
  return launch<double>(buf, val, perm, starts, out, C, D, stream);
}
