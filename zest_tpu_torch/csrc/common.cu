#include "common.cuh"

// Text of a CUDA error code, for the Python wrappers' exceptions.
ZT_API const char* zt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
