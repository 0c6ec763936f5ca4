// Kernel K3 at SH degree 1 (K = 4 coefficients per channel): the
// instantiations grt_march_bwd (march_bwd.cu) dispatches to. See march_bwd.cuh.

#include "march_bwd.cuh"

namespace k3 {
template cudaError_t launch_k<4>(const Params&, bool, int, int, cudaStream_t, int*);
}  // namespace k3
