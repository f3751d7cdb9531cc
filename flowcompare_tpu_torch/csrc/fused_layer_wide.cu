// The wide instances of fused_layer.cu's kernels (fused_layer_kernel.cuh):
// every kind at WIDE_TIER, for products past PASS_W columns (K up to
// S_COLS, row-wise epilogues in one pass), in a translation unit of their
// own so that nvcc builds them beside the one-pass and wider instances.
#include "fused_layer_kernel.cuh"

cudaError_t fused_layer::launch_wide(int kind, const Plan& plan, const Rows& io,
                                     cudaStream_t stream) {
  switch (kind) {
    case CONDITIONER: return launch_kind<CONDITIONER, WIDE_TIER>(plan, io, stream);
    case COUPLING: return launch_kind<COUPLING, WIDE_TIER>(plan, io, stream);
    case COUPLING_INVERSE: return launch_kind<COUPLING_INVERSE, WIDE_TIER>(plan, io, stream);
    case COUPLING_RECORD: return launch_kind<COUPLING_RECORD, WIDE_TIER>(plan, io, stream);
    case DGCNN_TAIL: return launch_kind<DGCNN_TAIL, WIDE_TIER>(plan, io, stream);
    case AUGMENT: return launch_kind<AUGMENT, WIDE_TIER>(plan, io, stream);
    default: return cudaErrorInvalidValue;
  }
}
