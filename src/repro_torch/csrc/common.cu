#include "common.cuh"

REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One launch of a kernel that does nothing (one block of one warp): the
// floor under any kernel's device time on this card.
REPRO_API int repro_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
