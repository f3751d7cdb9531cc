// The wider instances of fused_layer.cu's kernels (fused_layer_kernel.cuh):
// every kind at WIDER_TIER, for a K past S_COLS (the input in two halves)
// or a row-wise epilogue past one pass, in a translation unit of their own
// so that nvcc builds them beside the one-pass and wide instances.
#include "fused_layer_kernel.cuh"

cudaError_t fused_layer::launch_wider(int kind, const Plan& plan, const Rows& io,
                                      cudaStream_t stream) {
  switch (kind) {
    case CONDITIONER: return launch_kind<CONDITIONER, WIDER_TIER>(plan, io, stream);
    case COUPLING: return launch_kind<COUPLING, WIDER_TIER>(plan, io, stream);
    case COUPLING_INVERSE: return launch_kind<COUPLING_INVERSE, WIDER_TIER>(plan, io, stream);
    case COUPLING_RECORD: return launch_kind<COUPLING_RECORD, WIDER_TIER>(plan, io, stream);
    case DGCNN_TAIL: return launch_kind<DGCNN_TAIL, WIDER_TIER>(plan, io, stream);
    case AUGMENT: return launch_kind<AUGMENT, WIDER_TIER>(plan, io, stream);
    default: return cudaErrorInvalidValue;
  }
}
