// The wider instances of fused_layer_bwd.cu's kernels
// (fused_layer_bwd_kernel.cuh): both kinds at WIDER_TIER, for a K past
// S_COLS or a head past one pass, in a translation unit of their own so
// that nvcc builds them beside the one-pass and wide instances.
#include "fused_layer_bwd_kernel.cuh"

cudaError_t fused_layer_bwd::launch_bwd_wider(int kind, const BwdPlan& plan, const BwdRows& io,
                                              cudaStream_t stream) {
  return kind == COUPLING_BWD ? launch_bwd_kind<COUPLING_BWD, WIDER_TIER>(plan, io, stream)
                              : launch_bwd_kind<CONDITIONER_BWD, WIDER_TIER>(plan, io, stream);
}
