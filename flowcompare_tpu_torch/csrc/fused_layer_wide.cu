// The wide instances of fused_layer.cu's kernels (fused_layer_kernel.cuh):
// every kind with WIDE = true, for products past PASS_W columns, in a
// translation unit of their own so that nvcc builds them beside the
// one-pass instances.
#include "fused_layer_kernel.cuh"

cudaError_t fused_layer::launch_wide(int kind, const Plan& plan, const Rows& io,
                                     cudaStream_t stream) {
  switch (kind) {
    case CONDITIONER: return launch_kind<CONDITIONER, true>(plan, io, stream);
    case COUPLING: return launch_kind<COUPLING, true>(plan, io, stream);
    case COUPLING_INVERSE: return launch_kind<COUPLING_INVERSE, true>(plan, io, stream);
    case COUPLING_RECORD: return launch_kind<COUPLING_RECORD, true>(plan, io, stream);
    case DGCNN_TAIL: return launch_kind<DGCNN_TAIL, true>(plan, io, stream);
    case AUGMENT: return launch_kind<AUGMENT, true>(plan, io, stream);
    default: return cudaErrorInvalidValue;
  }
}
