// Error text for the codes the kernel entries return (cudaGetLastError()),
// so the Python wrappers can raise with CUDA's own message.

#include <cuda_runtime.h>

extern "C" const char* se_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
