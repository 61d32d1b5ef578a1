// What every C entry point does before it launches: make the tensors'
// device the current one.
//
// The Python side hands each entry point the index of the device its
// tensors lie on and the raw handle of PyTorch's current stream of that
// device. A process with one card, or one that already works on the right
// card, pays one cudaGetDevice (tens of nanoseconds); only a call that
// finds another device current switches, and switches back when the entry
// point returns. The same guard as a Python `with torch.cuda.device(...)`
// costs microseconds a call, more than the small kernels take to run.

#pragma once

#include <cuda_runtime.h>

class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    status_ = cudaGetDevice(&previous_);
    if (status_ == cudaSuccess && previous_ != device) {
      status_ = cudaSetDevice(device);
      switched_ = status_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(previous_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

  // cudaSuccess, or why the device could not be made current.
  int status() const { return static_cast<int>(status_); }

 private:
  cudaError_t status_ = cudaSuccess;
  int previous_ = -1;
  bool switched_ = false;
};
