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
// Hopper design. The TPU kernel reduces 512-row blocks on a sequential grid
// and sums its [G, 128] partials outside the kernel. Here a warp owns 8
// consecutive rows and a row is worked by the whole warp: lanes take
// columns lane, lane + 32, ... so a row (41 floats on synth-reddit) is read
// coalesced, and its max and sum are warp butterflies (every lane ends with
// the same bits). With C <= 64 a lane holds its two columns of all 8 rows in
// registers, loaded before any reduction, so the 8 rows' loads are in flight
// together rather than one row's latency after another (wider rows loop over
// memory, with the same arithmetic). A block of 8 warps owns 64 rows and
// writes one (loss, correct) partial; a second one-block kernel sums the
// [G, 2] partials in a fixed order and divides by num. No atomics, so two
// runs are bit-identical. The ragged last block skips rows >= n itself: the
// host pads nothing.
//
// What bounds it on an H100: memory. At synth-reddit's [233472, 41] f32
// logits the train variant reads 38.3 MB of logits (and 1.9 MB of int64
// labels, 0.2 MB of mask) and writes 38.3 MB of gradient, ~0.023 ms at
// 3.35 TB/s; the eval variant reads only, ~0.012 ms. Two expf per element
// are far below the card's special-function rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 64
constexpr int kFinalThreads = 1024;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Add one row's mask·(lse − truth) and mask·(truth >= 0) to (loss,
// correct); returns the row's gradient scale mask·inv_num.
__device__ __forceinline__ float row_terms(float sumexp, float truth, float maskf,
                                          float inv_num, float& loss, float& correct) {
  const float lse = logf(sumexp);
  loss += maskf * (lse - truth);
  correct += maskf * (truth >= 0.0f ? 1.0f : 0.0f);
  return maskf * inv_num;
}

__device__ __forceinline__ int clamp_label(int64_t label, int c) {
  return label < 0 ? 0 : (label >= c ? c - 1 : (int)label);
}

constexpr int kCachedCols = 64;  // C a warp keeps in registers (2 per lane)

template <bool kTrain, typename LT>
__global__ void __launch_bounds__(kWarps * 32)
ce_kernel(const float* __restrict__ logits, const LT* __restrict__ labels,
          const uint8_t* __restrict__ mask, int64_t n, int c, float inv_num,
          float* __restrict__ partials, float* __restrict__ grad) {
  __shared__ float part_s[kWarps][2];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 = (int64_t)blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  float loss = 0.0f;
  float correct = 0.0f;
  if (c <= kCachedCols) {
    float v[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        v[i][h] = (row0 + i < n && j < c) ? logits[(row0 + i) * c + j] : -INFINITY;
      }
    }
    // lane i < 8 fetches row i's label and mask; shuffled out per row
    int my_safe = 0;
    float my_mask = 0.0f;
    if (lane < kRowsPerWarp && row0 + lane < n) {
      my_safe = clamp_label((int64_t)labels[row0 + lane], c);
      my_mask = mask[row0 + lane] ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int64_t row = row0 + i;
      if (row >= n) break;  // warp-uniform
      const float lmax = warp_max(fmaxf(v[i][0], v[i][1]));
      float s = 0.0f;
      if (lane < c) s += expf(v[i][0] - lmax);
      if (lane + 32 < c) s += expf(v[i][1] - lmax);
      const float sumexp = warp_sum(s);
      const int safe = __shfl_sync(0xffffffffu, my_safe, i);
      const float maskf = __shfl_sync(0xffffffffu, my_mask, i);
      const float held = safe >= 32 ? v[i][1] : v[i][0];
      const float truth = __shfl_sync(0xffffffffu, held, safe & 31) - lmax;
      const float scale = row_terms(sumexp, truth, maskf, inv_num, loss, correct);
      if (kTrain) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = lane + 32 * h;
          const float onehot = j == safe ? 1.0f : 0.0f;
          if (j < c) grad[row * c + j] = (expf(v[i][h] - lmax) / sumexp - onehot) * scale;
        }
      }
    }
  } else {
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int64_t row = row0 + i;
      if (row >= n) break;  // warp-uniform
      const float* x = logits + row * c;
      float m = -INFINITY;
      for (int j = lane; j < c; j += 32) m = fmaxf(m, x[j]);
      const float lmax = warp_max(m);
      float s = 0.0f;
      for (int j = lane; j < c; j += 32) s += expf(x[j] - lmax);
      const float sumexp = warp_sum(s);
      const int safe = clamp_label((int64_t)labels[row], c);
      const float truth = x[safe] - lmax;
      const float maskf = mask[row] ? 1.0f : 0.0f;
      const float scale = row_terms(sumexp, truth, maskf, inv_num, loss, correct);
      if (kTrain) {
        float* g = grad + row * c;
        for (int j = lane; j < c; j += 32) {
          const float onehot = j == safe ? 1.0f : 0.0f;
          g[j] = (expf(x[j] - lmax) / sumexp - onehot) * scale;
        }
      }
    }
  }
  if (lane == 0) {
    part_s[warp][0] = loss;
    part_s[warp][1] = correct;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      l += part_s[w][0];
      a += part_s[w][1];
    }
    partials[2 * (int64_t)blockIdx.x] = l;
    partials[2 * (int64_t)blockIdx.x + 1] = a;
  }
}

// Sum the [g, 2] partials in a fixed order (strided per thread, then a
// shared-memory tree) and write loss_sum / num and correct / num.
__global__ void __launch_bounds__(kFinalThreads)
ce_finalize_kernel(const float* __restrict__ partials, int64_t g, float num,
                   float* __restrict__ loss, float* __restrict__ acc) {
  __shared__ float s[2][kFinalThreads];
  const int t = threadIdx.x;
  float l = 0.0f, a = 0.0f;
  for (int64_t i = t; i < g; i += kFinalThreads) {
    l += partials[2 * i];
    a += partials[2 * i + 1];
  }
  s[0][t] = l;
  s[1][t] = a;
  __syncthreads();
  for (int w = kFinalThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      s[0][t] += s[0][t + w];
      s[1][t] += s[1][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    *loss = s[0][0] / num;
    *acc = s[1][0] / num;
  }
}

template <bool kTrain, typename LT>
void launch(const float* logits, const void* labels, const uint8_t* mask, int64_t n,
            int c, float inv_num, float* partials, int64_t g, float* grad,
            cudaStream_t stream) {
  ce_kernel<kTrain, LT><<<(unsigned)g, kWarps * 32, 0, stream>>>(
      logits, static_cast<const LT*>(labels), mask, n, c, inv_num, partials, grad);
}

}  // namespace

// logits: [n, c] f32, contiguous; labels: [n] int32 (label_dtype 0) or
// int64 (1); mask: [n] bool (one byte each); partials: [n_parts, 2] f32
// scratch with n_parts = ceil(n / 64); grad: [n, c] f32 for the train
// variant, nullptr for the eval variant; loss, acc: one f32 each. inv_num is
// f32(1 / num) and num the split's size, as the TPU kernel takes them.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int pgcn_masked_ce(const float* logits, const void* labels, int label_dtype,
                              const uint8_t* mask, int64_t n, int c, float inv_num,
                              float num, float* partials, int64_t n_parts, float* grad,
                              float* loss, float* acc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || n_parts != (n + kRowsPerBlock - 1) / kRowsPerBlock ||
      n_parts > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (label_dtype == 0) {
    if (grad) launch<true, int32_t>(logits, labels, mask, n, c, inv_num, partials, n_parts, grad, s);
    else launch<false, int32_t>(logits, labels, mask, n, c, inv_num, partials, n_parts, grad, s);
  } else if (label_dtype == 1) {
    if (grad) launch<true, int64_t>(logits, labels, mask, n, c, inv_num, partials, n_parts, grad, s);
    else launch<false, int64_t>(logits, labels, mask, n, c, inv_num, partials, n_parts, grad, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  ce_finalize_kernel<<<1, kFinalThreads, 0, s>>>(partials, n_parts, num, loss, acc);
  return (int)cudaGetLastError();
}
