// Error strings for the C entry points, which return cudaGetLastError().
#include <cuda_runtime.h>

extern "C" const char* vqa_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
