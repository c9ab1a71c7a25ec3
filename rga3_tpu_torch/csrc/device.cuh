// The device a launch runs on. The library links its own CUDA runtime, whose
// current device is 0 until it is set, whatever PyTorch's is: each C entry
// point takes the ordinal of the device its tensors lie on and makes it
// current in this runtime (`use_device`) before it sets a kernel's
// attributes or launches, so a call for tensors on cuda:1 runs on cuda:1 on
// that device's stream. A kernel's attributes belong to one device's
// context: `PerDevice` sets them once for each device.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace rga3 {

constexpr int kMaxDevices = 64;

inline cudaError_t use_device(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// The result of `compute()` on the current device, computed at the first
// call on that device.
class PerDevice {
 public:
  template <typename F>
  cudaError_t get(F compute) {
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    if (!done_[dev]) {
      result_[dev] = compute();
      done_[dev] = true;
    }
    return result_[dev];
  }

 private:
  std::mutex mu_;
  bool done_[kMaxDevices] = {};
  cudaError_t result_[kMaxDevices] = {};
};

}  // namespace rga3
