// The bf16 launchers of grouped_rowscale.cu (qk_rowscale_topk_bf16,
// qk_rowscale_fold_bf16, qk_chunk_merge_bf16): the same source with
// QK_BF16_UNIT defined, a translation unit of its own so that nvcc builds
// the f32 and the bf16 instantiations of the kernels in parallel.
#define QK_BF16_UNIT
#include "grouped_rowscale.cu"
