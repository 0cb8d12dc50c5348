// The bf16 instantiations of the ordered segment sums (csrc/segment_sum.cuh),
// built beside csrc/segment_sum.cu's float32 ones by an nvcc of their own.

#include "segment_sum.cuh"

namespace pgcn_seg {

int gather_sum_bf16(const int4* work, Plan pl, const int2* items, const void* x, int64_t ldx,
                    void* out, int vec_bytes, int group, int passes, int hub_vec_bytes,
                    cudaStream_t s) {
  return gather_sum<__nv_bfloat16>(work, pl, items, x, ldx, out, vec_bytes, group, passes,
                                   hub_vec_bytes, s);
}

int segment_sum_bf16(const int4* work, Plan pl, const int32_t* perm, const void* values,
                     int64_t ldv, void* out, int vec_bytes, int group, int passes,
                     int hub_vec_bytes, cudaStream_t s) {
  return segment_sum<__nv_bfloat16>(work, pl, perm, values, ldv, out, vec_bytes, group, passes,
                                    hub_vec_bytes, s);
}

}  // namespace pgcn_seg
