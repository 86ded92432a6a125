// Error text for the codes the launchers return (ops/op_builder.py
// check_launch).
#include <cuda_runtime.h>

extern "C" const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
