"""Search operations: grouping, the grouped scan with its CUDA kernels, the
flat parent ranking and score conventions."""
