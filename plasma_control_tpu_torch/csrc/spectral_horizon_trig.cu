// Kernel 1's trig-drift instantiations, compiled beside spectral_horizon.cu
// (the rot drift and the C entry points) so that the build runs both at once.

#include "spectral_horizon.cuh"

int pct_spectral::launch_trig(const Buffers& b, const SpectralParams& p, const Shape& s,
                              cudaStream_t stream, int* max_clusters) {
  return launch_placement<false>(b, p, s, stream, max_clusters);
}
