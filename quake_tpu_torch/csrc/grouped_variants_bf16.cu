// The bf16 launchers of grouped_variants.cu (qk_raw_scores_bf16,
// qk_packed_topk_bf16, qk_sized_topk_bf16, qk_multi_topk_bf16): the same
// source with QK_BF16_UNIT defined, a translation unit of its own so that
// nvcc builds the f32 and the bf16 instantiations of the kernels in parallel.
#define QK_BF16_UNIT
#include "grouped_variants.cu"
