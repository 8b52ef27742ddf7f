// Error names for the Python wrappers: a launcher returns cudaGetLastError()
// and the wrapper raises with this string.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
