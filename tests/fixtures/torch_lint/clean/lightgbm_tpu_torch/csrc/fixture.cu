// A kernel entry with a plain C interface, for R004's fixtures.
#include <cuda_runtime.h>

namespace {
__global__ void scale_kernel(float* x, long long n, float s) {}
}  // namespace

extern "C" {

int fixture_scale(float* x, long long n, int blocks, double s,
                  void* stream) {
  scale_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, static_cast<float>(s));
  return static_cast<int>(cudaGetLastError());
}

long long fixture_bytes(int n) { return 4LL * n; }

}  // extern "C"
