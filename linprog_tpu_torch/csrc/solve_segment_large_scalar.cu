// Kernel 1's streaming branch on its scalar-load builds (shapes whose rows
// are not 16-byte aligned, and unaligned pointers), compiled in an nvcc
// process of its own beside solve_segment_large.cu, which holds the design,
// the bulk-copy builds and the entry points.

#include "solve_segment_large.cuh"

namespace lpl {
LP_LARGE_SCALAR_BUILDS(LP_LARGE_DEFINE)
}  // namespace lpl
