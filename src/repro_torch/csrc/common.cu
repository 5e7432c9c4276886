#include "common.cuh"

REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
