// The bf16 launcher of grouped_exact.cu (qk_exact_topk_bf16): the same
// source with QK_BF16_UNIT defined, a translation unit of its own so that
// nvcc builds the f32 and the bf16 instantiations of the kernels in parallel.
#define QK_BF16_UNIT
#include "grouped_exact.cu"
