// CUDA error names for the Python wrappers: each C entry returns the code
// of cudaGetLastError() after its launch, and the wrapper raises with this
// string when the code is not 0.
#include <cuda_runtime.h>

extern "C" const char* orbit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
