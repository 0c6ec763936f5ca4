// Kernel K1 at SH degree 2 (K = 9 coefficients per channel): the
// instantiations grt_march (march.cu) dispatches to. See march.cuh.

#include "march.cuh"

namespace k1 {
template cudaError_t launch_k<9>(const Params&, int, int, int, cudaStream_t, int*);
}  // namespace k1
