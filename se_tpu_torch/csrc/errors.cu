// Error text for the codes the kernel entries return (cudaGetLastError()),
// so the Python wrappers can raise with CUDA's own message; and the device
// the entries run on. The library links its own CUDA runtime, whose current
// device PyTorch's `torch.cuda.device` does not set, so ops/_build.py
// `launch` sets it to the tensors' device before every entry (the launches,
// cudaFuncSetAttribute and the occupancy queries then all see that device).

#include <cuda_runtime.h>

extern "C" const char* se_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int se_set_device(int dev) { return (int)cudaSetDevice(dev); }
