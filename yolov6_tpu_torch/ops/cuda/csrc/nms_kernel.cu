// Greedy NMS keep loop for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel yolov6_tpu/ops/pallas/nms_kernel.py::_nms_kernel
// (launched by pallas_greedy_nms, pl.pallas_call at nms_kernel.py:89).
//
// What it computes, per image b, over K class-offset candidates whose scores
// are 0 below conf: max_det steps, each (1) the first-index argmax of the
// alive scores, (2) emit that index, or an invalid row once no alive score is
// > 0, (3) kill every alive box with
//     inter / (area_cur + area - inter + 1e-12) > iou_thres.
// A zero-area box has IoU 0 with itself and so is emitted again on the next
// step, exactly as the Pallas kernel and the JAX loop do.
//
// What bounds it on the H100: neither bytes nor operations. The inputs are
// read once (20 B a candidate, under 1 MB an image), but the max_det steps
// form a dependent chain: each needs a block-wide argmax (3 barriers) before
// its suppression pass can start. So the time is about max_det times the
// latency of one step, and only B of the 132 SMs have work.
//
// The design: one block of 1024 threads per image. The working scores live
// in dynamic shared memory (4*K bytes; a killed candidate's score becomes -1,
// which stands in for the alive mask), so the argmax scan never leaves the
// SM. The boxes stay in global memory: read-only and at most B*K*16 bytes,
// they sit in the 50 MB L2 after the first step. Each step does a per-thread
// (max score, min index) scan, a warp-shuffle reduction, a cross-warp
// reduction in shared memory, then a strided IoU pass over the alive boxes.
// Once the best score is <= 0 the block writes the remaining rows invalid
// and exits, which gives the same output as running on.
//
// Build with -fmad=false and without --use_fast_math: the IoU is then
// rounded as in the plain torch version, so the kept index sequence matches
// it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (v, i) <- the better of (v, i) and (ov, oi): higher score, then lower index.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                  int K, int max_det, float iou_thres,
                  int32_t* __restrict__ out_idx, uint8_t* __restrict__ out_valid) {
  extern __shared__ float work[];  // [K] alive score, or -1 once dead
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float best_v;
  __shared__ int best_i;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* bx = boxes + (size_t)blockIdx.x * K;
  const float* sc = scores + (size_t)blockIdx.x * K;
  int32_t* idx = out_idx + (size_t)blockIdx.x * max_det;
  uint8_t* valid = out_valid + (size_t)blockIdx.x * max_det;

  for (int k = tid; k < K; k += kThreads) {
    const float s = sc[k];
    work[k] = s > 0.f ? s : -1.f;
  }
  __syncthreads();

  for (int step = 0; step < max_det; ++step) {
    // every live entry is >= -1, so a thread with any entry takes a real index
    float v = -2.f;
    int i = K;
    for (int k = tid; k < K; k += kThreads) {
      const float s = work[k];
      if (s > v) {  // strict: the first index wins a tie within the thread
        v = s;
        i = k;
      }
    }
    warp_argmax(v, i);
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = warp_v[lane];
      i = warp_i[lane];
      warp_argmax(v, i);
      if (lane == 0) {
        best_v = v;
        best_i = i;
      }
    }
    __syncthreads();
    const float cur_v = best_v;
    const int cur = best_i;
    if (!(cur_v > 0.f)) {  // nothing alive: every later step emits nothing
      for (int r = step + tid; r < max_det; r += kThreads) {
        idx[r] = 0;
        valid[r] = 0;
      }
      return;
    }
    if (tid == 0) {
      idx[step] = cur;
      valid[step] = 1;
    }
    const float4 c = bx[cur];
    const float area_cur = (c.z - c.x) * (c.w - c.y);
    for (int k = tid; k < K; k += kThreads) {
      if (work[k] > 0.f) {
        const float4 o = bx[k];
        const float iw = fmaxf(fminf(c.z, o.z) - fmaxf(c.x, o.x), 0.f);
        const float ih = fmaxf(fminf(c.w, o.w) - fmaxf(c.y, o.y), 0.f);
        const float inter = iw * ih;
        const float area = (o.z - o.x) * (o.w - o.y);
        const float iou = inter / (area_cur + area - inter + 1e-12f);
        if (iou > iou_thres) work[k] = -1.f;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes [B, K, 4] and scores [B, K] fp32, contiguous; idx [B, max_det] int32
// and valid [B, max_det] bytes are written. Launches on `stream` and returns
// the CUDA error code of the launch (0 on success); it does not synchronise.
int yolov6_greedy_nms(const void* boxes, const void* scores, int B, int K, int max_det,
                      float iou_thres, void* idx, void* valid, void* stream) {
  const size_t smem = (size_t)K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  greedy_nms_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)scores, K, max_det, iou_thres,
      (int32_t*)idx, (uint8_t*)valid);
  return (int)cudaGetLastError();
}

const char* yolov6_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
