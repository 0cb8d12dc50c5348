// Ordered segment sums over the CSR of an index vector, for sm_90a: the C
// entry points and the float32 instantiations. The kernels, what they
// replace, what bounds them and their design are in csrc/segment_sum.cuh;
// the bf16 instantiations in csrc/segment_sum_bf16.cu.

#include "segment_sum.cuh"

namespace pgcn_seg {

int gather_sum_bf16(const int4* work, Plan pl, const int2* items, const void* x, int64_t ldx,
                    void* out, int vec_bytes, int group, int passes, int hub_vec_bytes,
                    cudaStream_t s);
int segment_sum_bf16(const int4* work, Plan pl, const int32_t* perm, const void* values,
                     int64_t ldv, void* out, int vec_bytes, int group, int passes,
                     int hub_vec_bytes, cudaStream_t s);

// whether vectors of vb bytes divide rows of `width` elements of `esize`
// bytes, every address and every row stride (elements)
bool aligned(int width, int esize, int vb, uintptr_t addresses, int64_t strides) {
  return vb >= esize && vb <= 16 && !(vb & (vb - 1)) && (int64_t)width * esize % vb == 0 &&
         (addresses | (uintptr_t)(strides * esize)) % (uintptr_t)vb == 0;
}

// the plan of a layout (ops/cuda_segment.py:layout) over rows of `width`
// elements of `esize` bytes, or false if it does not cover them
bool plan_of(int n_hub, int n_live, int n_work, int width, int esize, int vec_bytes, int group,
             int passes, int tw, int hub_tw, int hub_vec_bytes, uintptr_t addresses,
             int64_t strides, int64_t ld, Plan* pl) {
  if (width <= 0 || tw < 1 || tw > kWarps || n_hub < 0 || n_hub > n_live || n_live > n_work ||
      n_work <= 0 || hub_tw < 1 || hub_tw > kWarps)
    return false;
  *pl = Plan{n_hub, n_live, n_work, hub_tw, tw, width, width, ld, 0};
  if (vec_bytes == 0) return width <= kMaxItemWidth && tw == 1 && hub_tw == 1;
  if (!aligned(width, esize, vec_bytes, addresses, strides)) return false;
  pl->nvec = (int)((int64_t)width * esize / vec_bytes);
  if (!(group == 32 || (group == 16 && tw == 1))) return false;
  if (!(passes == 1 || passes == 2 || passes == 4)) return false;
  if (pl->nvec > (int64_t)(tw > 1 ? 32 * tw : group) * passes) return false;
  if (!aligned(width, esize, hub_vec_bytes, addresses, strides)) return false;
  pl->hub_nvec = (int)((int64_t)width * esize / hub_vec_bytes);
  return n_hub == 0 || 32 * hub_tw >= pl->hub_nvec;
}

}  // namespace pgcn_seg

using namespace pgcn_seg;

// (a): out [n, F] (x's type; rows ldo apart) = the ordered gather-sum of
// the packed items ({src, val}, int32 pairs in segment order) over rows of
// x (ldx apart), by the work list ({seg, begin, end, 0}: the first n_hub
// hubs, the first n_live with items, n_work = n entries) with the layout
// (vec_bytes, group, passes, tw; the hubs' hub_tw, hub_vec_bytes)
extern "C" int pgcn_gather_sum(const int32_t* work, int n_hub, int n_live, int n_work,
                               const int32_t* items, const void* x, int64_t ldx, int dtype,
                               void* out, int64_t ldo, int F, int vec_bytes, int group,
                               int passes, int tw, int hub_tw, int hub_vec_bytes,
                               void* stream) {
  const int esize = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  Plan pl;
  if (!esize ||
      !plan_of(n_hub, n_live, n_work, F, esize, vec_bytes, group, passes, tw, hub_tw,
               hub_vec_bytes, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out),
               ldx | ldo, ldo, &pl))
    return (int)cudaErrorInvalidValue;
  const int4* w = reinterpret_cast<const int4*>(work);
  const int2* it = reinterpret_cast<const int2*>(items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = dtype == 0 ? gather_sum<float>(w, pl, it, x, ldx, out, vec_bytes, group, passes,
                                                hub_vec_bytes, s)
                            : gather_sum_bf16(w, pl, it, x, ldx, out, vec_bytes, group, passes,
                                              hub_vec_bytes, s);
  return rc ? rc : (int)cudaGetLastError();
}

// (b): out [n, W] (rows ldo apart) += the ordered sums of values [E, W]
// (rows ldv apart, out's type) through perm (null: the items in order),
// over the work list's first n_live = n_work entries, as (a)
extern "C" int pgcn_segment_sum(const int32_t* work, int n_hub, int n_live, int n_work,
                                const int32_t* perm, const void* values, int64_t ldv,
                                int dtype, void* out, int64_t ldo, int W, int vec_bytes,
                                int group, int passes, int tw, int hub_tw, int hub_vec_bytes,
                                void* stream) {
  const int esize = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  Plan pl;
  if (!esize || n_live != n_work ||
      !plan_of(n_hub, n_live, n_work, W, esize, vec_bytes, group, passes, tw, hub_tw,
               hub_vec_bytes,
               reinterpret_cast<uintptr_t>(values) | reinterpret_cast<uintptr_t>(out), ldv | ldo,
               ldo, &pl))
    return (int)cudaErrorInvalidValue;
  const int4* w = reinterpret_cast<const int4*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = dtype == 0 ? segment_sum<float>(w, pl, perm, values, ldv, out, vec_bytes, group,
                                                 passes, hub_vec_bytes, s)
                            : segment_sum_bf16(w, pl, perm, values, ldv, out, vec_bytes, group,
                                               passes, hub_vec_bytes, s);
  return rc ? rc : (int)cudaGetLastError();
}
