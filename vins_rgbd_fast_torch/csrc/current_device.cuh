// The launchers' check that the calling host thread's current CUDA device
// is the one the tensors live on.  The runtime launches on the current
// device, so a launch with another device's stream and pointers fails or
// runs in the wrong context; the wrappers (ops/fast.py, ops/lk.py) launch
// under a guard for the tensors' device, and this refuses a caller
// without one.
#pragma once

#include <cuda_runtime.h>

inline cudaError_t check_current_device(int device) {
  int current = -1;
  const cudaError_t st = cudaGetDevice(&current);
  if (st != cudaSuccess) return st;
  return current == device ? cudaSuccess : cudaErrorInvalidDevice;
}
