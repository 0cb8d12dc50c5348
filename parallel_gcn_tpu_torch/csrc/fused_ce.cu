// Masked softmax cross-entropy with accuracy and, in training, the softmax
// gradient, in one pass over the logits, for sm_90a.
//
// Replaces the Pallas kernels of parallel_gcn_tpu/ops/pallas_ce.py (K9):
//   kTrain = false: _ce_kernel_eval  (loss sum and correct count)
//   kTrain = true:  _ce_kernel_train (the same, and the gradient
//                   (softmax − onehot)·mask/num written beside them)
// Per row, in f32 (pallas_ce.py:41-84): lmax = max x, shifted = x − lmax,
// sumexp = Σ exp(shifted), lse = log(sumexp), truth = shifted[safe] with
// safe = clamp(label, 0, C−1); loss += mask·(lse − truth) and
// correct += mask·(truth >= 0), the TPU kernel's truth-equals-row-max test
// (an exact tie counts as correct, unlike an argmax). Rows with mask 0
// (padding, other splits) add 0 and get a zero gradient.
//
// What bounds it on an H100: memory. At synth-reddit's [233472, 41] f32
// logits the train variant reads 38.3 MB of logits (and 1.9 MB of int64
// labels, 0.2 MB of mask) and writes 38.3 MB of gradient, ~0.023 ms at
// 3.35 TB/s; the eval variant reads only, ~0.012 ms. One expf per element
// is far below the card's special-function rate.
//
// Hopper design. The TPU kernel reduces 512-row blocks on a sequential grid
// and sums its [G, 128] partials outside the kernel. Here a block of 8 warps
// owns 128 consecutive rows, which are one contiguous run of 128·C floats:
//   * C <= 64: the run is staged into shared memory with 16-byte loads (when
//     the logits are 16-byte aligned), then each row is worked by 8 lanes
//     (columns lane8, lane8 + 8, ...), so a warp takes 4 rows a step and all
//     32 lanes are busy at C = 41 (a warp per row left 23 idle in its second
//     column pass). Max and sum are 3-step butterflies within the 8 lanes;
//     exp is taken once per element and kept for the gradient, which is
//     written back over the staged row and stored as the same flat 16-byte
//     stream. (A persistent grid streaming 64-row chunks through a cp.async
//     ring measured slower: kernel_variants.py, PERF.md.)
//   * C > 64: a warp per row, columns lane, lane + 32, ... read from memory.
// Each block sums its rows in a fixed order (its lanes' rows in turn, a
// butterfly in each warp, the warps in order) into one (loss, correct)
// partial; the last block to finish (a ticket counter, which it resets)
// sums the partials in block order and divides by num. One launch, no
// atomics in any sum: two runs are bit-identical. The ragged last block
// skips rows >= n itself: the host pads nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 128;
constexpr int kStagedCols = 64;  // C up to which rows are staged (8 per lane)
constexpr int kRowLanes = 8;     // lanes a staged row

__device__ unsigned int g_ticket[2];  // one per variant; zero between launches

__device__ __forceinline__ float warp_max(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int clamp_label(int64_t label, int c) {
  return label < 0 ? 0 : (label >= c ? c - 1 : (int)label);
}

// a and b summed over the block in a fixed order: a butterfly within each
// warp, then the warps' sums in warp order by thread 0 (the result is
// thread 0's).
__device__ __forceinline__ void block_sum2(float& a, float& b, float (*s)[kWarps]) {
  a = warp_sum(a, 32);
  b = warp_sum(b, 32);
  if (threadIdx.x % 32 == 0) {
    s[0][threadIdx.x / 32] = a;
    s[1][threadIdx.x / 32] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = b = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += s[0][w];
      b += s[1][w];
    }
  }
}

// One staged row (C <= 64) worked by 8 lanes: adds mask·(lse − truth) and
// mask·(truth >= 0) to (loss, correct) on the row's first lane and, in
// training, writes the row's gradient over it.
template <bool kTrain, typename LT>
__device__ __forceinline__ void staged_row(float* x, bool live, int64_t row, int c,
                                           const LT* __restrict__ labels,
                                           const uint8_t* __restrict__ mask, float inv_num,
                                           int lane, float& loss, float& correct) {
  const int l8 = lane % kRowLanes;
  float v[kStagedCols / kRowLanes];
  float m = -INFINITY;
#pragma unroll
  for (int t = 0; t < kStagedCols / kRowLanes; ++t) {
    const int j = l8 + kRowLanes * t;
    v[t] = (live && j < c) ? x[j] : -INFINITY;
    m = fmaxf(m, v[t]);
  }
  const float lmax = warp_max(m, kRowLanes);
  int safe = 0;
  float maskf = 0.0f;
  if (live) {
    safe = clamp_label((int64_t)labels[row], c);
    maskf = mask[row] ? 1.0f : 0.0f;
  }
  float s = 0.0f;
  float held = 0.0f;
#pragma unroll
  for (int t = 0; t < kStagedCols / kRowLanes; ++t) {
    const int j = l8 + kRowLanes * t;
    if (j == safe) held = v[t];
    v[t] = j < c ? expf(v[t] - lmax) : 0.0f;  // exp once, kept for the gradient
    s += v[t];
  }
  const float sumexp = warp_sum(s, kRowLanes);
  const float truth =
      __shfl_sync(0xffffffffu, held, (lane & ~(kRowLanes - 1)) | (safe % kRowLanes)) - lmax;
  if (live && l8 == 0) {
    loss += maskf * (logf(sumexp) - truth);
    correct += maskf * (truth >= 0.0f ? 1.0f : 0.0f);
  }
  if (kTrain && live) {
    const float scale = maskf * inv_num;
#pragma unroll
    for (int t = 0; t < kStagedCols / kRowLanes; ++t) {
      const int j = l8 + kRowLanes * t;
      if (j < c) x[j] = (v[t] / sumexp - (j == safe ? 1.0f : 0.0f)) * scale;
    }
  }
}

template <bool kTrain, typename LT>
__global__ void __launch_bounds__(kThreads)
ce_kernel(const float* __restrict__ logits, const LT* __restrict__ labels,
          const uint8_t* __restrict__ mask, int64_t n, int c, float inv_num, float num,
          float* __restrict__ partials, float* __restrict__ grad, float* __restrict__ loss_out,
          float* __restrict__ acc_out) {
  __shared__ __align__(16) float rows_s[kRowsPerBlock * kStagedCols];
  __shared__ float red_s[2][kWarps];
  __shared__ bool last_s;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t row0 = (int64_t)blockIdx.x * kRowsPerBlock;
  const int rows = (int)(n - row0 < kRowsPerBlock ? n - row0 : kRowsPerBlock);
  float loss = 0.0f;
  float correct = 0.0f;
  if (c <= kStagedCols) {
    // the block's rows as one flat run of rows·c floats (the block starts
    // 512·c bytes into the logits, so 16-byte aligned logits keep it aligned)
    const int len = rows * c;
    const float* src = logits + row0 * c;
    if ((reinterpret_cast<uintptr_t>(logits) & 15u) == 0) {
#pragma unroll 4
      for (int e = tid; e < len / 4; e += kThreads)
        reinterpret_cast<float4*>(rows_s)[e] = __ldg(reinterpret_cast<const float4*>(src) + e);
      for (int e = len / 4 * 4 + tid; e < len; e += kThreads) rows_s[e] = src[e];
    } else {
      for (int e = tid; e < len; e += kThreads) rows_s[e] = src[e];
    }
    __syncthreads();
#pragma unroll
    for (int step = 0; step < kRowsPerBlock / (kWarps * 4); ++step) {  // 4 rows a warp-step
      const int r = (step * kWarps + warp) * 4 + lane / kRowLanes;
      staged_row<kTrain>(rows_s + r * c, r < rows, row0 + r, c, labels, mask, inv_num, lane,
                         loss, correct);
    }
    if (kTrain) {  // the block's gradient as the same flat run
      __syncthreads();
      float* dst = grad + row0 * c;
      if ((reinterpret_cast<uintptr_t>(grad) & 15u) == 0) {
        for (int e = tid; e < len / 4; e += kThreads)
          reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(rows_s)[e];
        for (int e = len / 4 * 4 + tid; e < len; e += kThreads) dst[e] = rows_s[e];
      } else {
        for (int e = tid; e < len; e += kThreads) dst[e] = rows_s[e];
      }
    }
  } else {
    for (int i = warp; i < rows; i += kWarps) {
      const int64_t row = row0 + i;
      const float* x = logits + row * c;
      float m = -INFINITY;
      for (int j = lane; j < c; j += 32) m = fmaxf(m, x[j]);
      const float lmax = warp_max(m, 32);
      float s = 0.0f;
      for (int j = lane; j < c; j += 32) s += expf(x[j] - lmax);
      const float sumexp = warp_sum(s, 32);
      const int safe = clamp_label((int64_t)labels[row], c);
      const float truth = x[safe] - lmax;
      const float maskf = mask[row] ? 1.0f : 0.0f;
      if (lane == 0) {
        loss += maskf * (logf(sumexp) - truth);
        correct += maskf * (truth >= 0.0f ? 1.0f : 0.0f);
      }
      if (kTrain) {
        const float scale = maskf * inv_num;
        float* g = grad + row * c;
        for (int j = lane; j < c; j += 32)
          g[j] = (expf(x[j] - lmax) / sumexp - (j == safe ? 1.0f : 0.0f)) * scale;
      }
    }
  }
  block_sum2(loss, correct, red_s);
  if (tid == 0) {
    partials[2 * (int64_t)blockIdx.x] = loss;
    partials[2 * (int64_t)blockIdx.x + 1] = correct;
    __threadfence();
    last_s = atomicAdd(&g_ticket[kTrain], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_s) return;
  // the last block: every partial is written; sum them in block order
  __threadfence();
  float l = 0.0f, a = 0.0f;
  for (int64_t i = tid; i < gridDim.x; i += kThreads) {
    l += __ldcg(partials + 2 * i);
    a += __ldcg(partials + 2 * i + 1);
  }
  __syncthreads();  // red_s is free again
  block_sum2(l, a, red_s);
  if (tid == 0) {
    *loss_out = l / num;
    *acc_out = a / num;
    g_ticket[kTrain] = 0u;
  }
}

template <bool kTrain, typename LT>
int launch(const float* logits, const void* labels, const uint8_t* mask, int64_t n,
           int c, float inv_num, float num, float* partials, int64_t n_parts, float* grad,
           float* loss, float* acc, cudaStream_t stream) {
  ce_kernel<kTrain, LT><<<(unsigned)n_parts, kThreads, 0, stream>>>(
      logits, static_cast<const LT*>(labels), mask, n, c, inv_num, num, partials, grad, loss,
      acc);
  return 0;
}

}  // namespace

// logits: [n, c] f32, contiguous; labels: [n] int32 (label_dtype 0) or
// int64 (1); mask: [n] bool (one byte each); partials: [n_parts, 2] f32
// scratch with n_parts = ceil(n / 128), one a block; grad: [n, c] f32 for the train
// variant, nullptr for the eval variant; loss, acc: one f32 each. inv_num is
// f32(1 / num) and num the split's size, as the TPU kernel takes them. One
// launch. Returns cudaGetLastError() after it (0 on success).
extern "C" int pgcn_masked_ce(const float* logits, const void* labels, int label_dtype,
                              const uint8_t* mask, int64_t n, int c, float inv_num,
                              float num, float* partials, int64_t n_parts, float* grad,
                              float* loss, float* acc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || n_parts != (n + kRowsPerBlock - 1) / kRowsPerBlock ||
      n_parts > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (label_dtype == 0) {
    rc = grad ? launch<true, int32_t>(logits, labels, mask, n, c, inv_num, num, partials, n_parts, grad, loss, acc, s)
              : launch<false, int32_t>(logits, labels, mask, n, c, inv_num, num, partials, n_parts, grad, loss, acc, s);
  } else if (label_dtype == 1) {
    rc = grad ? launch<true, int64_t>(logits, labels, mask, n, c, inv_num, num, partials, n_parts, grad, loss, acc, s)
              : launch<false, int64_t>(logits, labels, mask, n, c, inv_num, num, partials, n_parts, grad, loss, acc, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
