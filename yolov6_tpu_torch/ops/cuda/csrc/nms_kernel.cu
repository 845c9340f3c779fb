// Greedy NMS keep for Hopper (sm_90a), bound to Python with ctypes.
//
// Covers two TPU-side keeps of the JAX package:
//   - the Pallas rule: yolov6_tpu/ops/pallas/nms_kernel.py::_nms_kernel
//     (launched by pallas_greedy_nms, pl.pallas_call at nms_kernel.py:89);
//   - the default rule: yolov6_tpu/ops/nms.py::_tiled_keep + _emit_topk_kept,
//     the keep of the JAX package's default method 'tiled'.
//
// What it computes, per image b, over K class-offset candidates whose scores
// are 0 below conf: max_det steps, each (1) the first-index argmax of the
// alive scores, (2) emit that index, or an invalid row once no alive score is
// > 0, (3) kill every alive box with
//     inter / (area_cur + area - inter + 1e-12) > iou_thres.
// The two rules differ only on a box whose IoU with itself is not above the
// threshold (zero area, or inverted, x2 < x1): under the default rule
// (emit_once) the emitted box also leaves the alive set, so it is emitted
// once; under the Pallas rule it stays the argmax and fills every remaining
// row, as the Pallas kernel and the JAX loop do.
//
// Precondition: per image, the positive scores form a non-increasing prefix,
// which is how the selection stage hands candidates over (a stable
// descending sort, the tail below conf zeroed). The wrapper
// (ops/cuda/nms_kernel.py::greedy_nms) stable-sorts a direct caller's
// candidates that are not known to be in that order, and maps the indices
// back. The first alive candidate is then the argmax, so greedy NMS is a
// walk over the prefix in order: the tile walk. What bounds the walk is its
// dependent chain, not bytes or operations: each input byte is read once and
// the IoU work is a few hundred thousand operations an image. The design
// keeps that chain short and on chip:
//   (a) tiles of kTile boxes come in with cp.async, double-buffered, so tile
//       t+1 arrives while tile t resolves; each box is read once, in order;
//   (b) every tile candidate is tested against the kept buffer in shared
//       memory (kept boxes and areas, 20 B each), 8 threads a candidate,
//       combined with a ballot;
//   (c) the strict-upper-triangular kTile x kTile overlap mask of the tile is
//       built as bits in shared memory (2 KB), the 8 threads of a row on
//       neighbouring columns so that their reads hit distinct banks;
//   (d) one warp walks the tile's survivors in order with register bit masks
//       (__ffs): keep the first alive rank, clear the ranks it suppresses.
//       Alive ranks whose rows suppress nothing are kept in one step each
//       run, so the chain is one step per rank that suppresses a later one.
//       This takes the place of _tiled_keep's Jacobi sweeps, a TPU idiom;
//   (e) the same warp appends the kept boxes to the kept buffer and writes
//       idx/valid.
// Two barriers a tile, and the walk stops once max_det boxes are kept or the
// prefix ends, so the sequential depth is the number of tiles visited
// (out_tiles), not max_det steps of three barriers each. What is left per
// tile is the IoU work of (b) and (c) on one SM, and the launch and the pass
// over the scores per image. Pairs that do not intersect, most of them
// under the class offset, skip the IEEE division (iou_above). Shared memory
// is the two tiles, the mask and the kept buffer: 6 KB + 20 B a kept box,
// whatever K is.
//
// One block of 1024 threads per image, so only B of the 132
// SMs have work; splitting an image over a cluster of blocks is the next
// lever.
//
// Rounding: build with -fmad=false and without --use_fast_math, and keep the
// expression inter / (area_a + area_b - inter + 1e-12f). Float addition
// commutes and fminf/fmaxf are symmetric, so this IoU is bitwise symmetric in
// its two boxes: the kept-buffer test and the within-tile mask may take
// either orientation and still round as the plain torch version does, so
// the kept index sequence matches it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 128;                   // candidates per tile of the walk
constexpr int kTileWords = kTile / 32;       // 32-bit words in a mask row
constexpr int kPerCand = kThreads / kTile;   // threads per tile candidate
// dynamic shared memory of the walk, before the kept buffer: two tiles of
// boxes and the overlap mask
constexpr int kWalkFixedBytes = 2 * kTile * 16 + kTile * kTileWords * 4;
static_assert(kPerCand == 8, "the cross-tile ballot groups 8 lanes a candidate");
static_assert(kTileWords == 4, "the resolve loop clears a mask row as one uint4");

__device__ __forceinline__ float box_area(const float4 b) {
  return (b.z - b.x) * (b.w - b.y);
}

// IoU(a, b) > thr, with the IoU inter / (area_a + area_b - inter + 1e-12)
// rounded as the plain version rounds it. Boxes that do not intersect have
// IoU +0, -0 or NaN (a zero union), none of which is above a threshold >= 0,
// so they skip the division: most pairs of class-offset candidates.
__device__ __forceinline__ bool iou_above(const float4 a, float area_a, const float4 b,
                                          float area_b, float thr) {
  const float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.f);
  const float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.f);
  const float inter = iw * ih;
  if (inter == 0.f && thr >= 0.f) return false;
  return inter / (area_a + area_b - inter + 1e-12f) > thr;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Thread r < kTile copies candidate base + r into dst[r] asynchronously;
// slots past the prefix get a zero box, which is never alive.
__device__ __forceinline__ void load_tile(float4* dst, const float4* bx, int base, int n_pos,
                                          int tid) {
  if (tid < kTile) {
    if (base + tid < n_pos) {
      cp_async16(dst + tid, bx + base + tid);
    } else {
      dst[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  cp_async_commit();
}

// The tile walk over the sorted prefix of n_pos candidates. Returns the
// number of tiles visited.
__device__ int tile_walk(unsigned char* smem, const float4* __restrict__ bx, int n_pos, int K,
                         int max_det, float iou_thres, bool emit_once,
                         int32_t* __restrict__ idx, uint8_t* __restrict__ valid) {
  __shared__ uint8_t ok_s[kTile];  // tile candidate alive after the kept-buffer test
  __shared__ int n_kept_s;
  __shared__ int fill_s;
  float4* tiles = reinterpret_cast<float4*>(smem);  // [2][kTile]
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + 2 * kTile * 16);  // [kTile][kTileWords]
  float4* kept_box = reinterpret_cast<float4*>(smem + kWalkFixedBytes);  // [min(max_det, K)]
  float* kept_area = reinterpret_cast<float*>(kept_box + min(max_det, K));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = tid / kPerCand;   // this thread's tile candidate (and mask row)
  const int sub = tid % kPerCand;
  const int n_tiles = (n_pos + kTile - 1) / kTile;

  if (n_tiles > 0) load_tile(tiles, bx, 0, n_pos, tid);
  cp_async_wait_all();
  __syncthreads();

  int n_kept = 0;  // rows written so far
  int fill = -1;   // Pallas rule: the candidate that fills every remaining row
  int t = 0;
  for (; t < n_tiles && n_kept < max_det && fill < 0; ++t) {
    const float4* cur = tiles + (t & 1) * kTile;
    const int base = t * kTile;
    const int m = min(kTile, n_pos - base);  // live candidates in this tile
    if (t + 1 < n_tiles) load_tile(tiles + ((t + 1) & 1) * kTile, bx, base + kTile, n_pos, tid);

    // (b) candidate r against the kept buffer, kPerCand threads a candidate
    const float4 c = cur[r];
    const float area_c = box_area(c);
    bool dead = false;
    if (r < m) {
      for (int q = sub; q < n_kept; q += kPerCand) {
        if (iou_above(kept_box[q], kept_area[q], c, area_c, iou_thres)) {
          dead = true;
          break;
        }
      }
    }
    const bool group_dead = (__ballot_sync(0xffffffffu, dead) >> (lane & ~(kPerCand - 1))) & 0xffu;
    const bool alive = r < m && !group_dead;
    if (sub == 0) ok_s[r] = alive;

    // (c) row r of the overlap mask: columns j = r+1 .. m-1, every
    // kPerCand-th one a thread, so the row's threads read neighbouring boxes
    // (no bank conflict); rows of dead candidates are never read
    uint32_t row_bits[kTileWords] = {0u, 0u, 0u, 0u};
    if (alive) {
      for (int j = r + 1 + ((sub - r - 1) & (kPerCand - 1)); j < m; j += kPerCand) {
        const float4 o = cur[j];
        if (iou_above(c, area_c, o, box_area(o), iou_thres)) {
          const uint32_t bit = 1u << (j & 31);
          const int w = j >> 5;  // four selects keep row_bits in registers
          row_bits[0] |= w == 0 ? bit : 0u;
          row_bits[1] |= w == 1 ? bit : 0u;
          row_bits[2] |= w == 2 ? bit : 0u;
          row_bits[3] |= w == 3 ? bit : 0u;
        }
      }
    }
#pragma unroll
    for (int w = 0; w < kTileWords; ++w) {
#pragma unroll
      for (int off = kPerCand / 2; off > 0; off >>= 1) {
        row_bits[w] |= __shfl_xor_sync(0xffffffffu, row_bits[w], off);
      }
    }
    if (sub == 0) {
      *reinterpret_cast<uint4*>(mask + r * kTileWords) =
          make_uint4(row_bits[0], row_bits[1], row_bits[2], row_bits[3]);
    }
    __syncthreads();

    // (d) one warp resolves the tile in rank order; (e) and appends. An alive
    // rank is kept; only a "special" one changes what follows it: a row with
    // bits (it suppresses later ranks) or, under the Pallas rule, a box that
    // does not suppress itself. So the alive ranks ahead of the next special
    // one are kept in one step, and the chain is one step per special rank.
    if (warp == 0) {
      uint32_t live[kTileWords], special[kTileWords], self_kill[kTileWords], kept[kTileWords];
#pragma unroll
      for (int w = 0; w < kTileWords; ++w) {
        const int rank = w * 32 + lane;
        live[w] = __ballot_sync(0xffffffffu, ok_s[rank]);
        const float4 b = cur[rank];
        const float ab = box_area(b);
        self_kill[w] = emit_once ? 0xffffffffu
                                 : __ballot_sync(0xffffffffu, iou_above(b, ab, b, ab, iou_thres));
        const uint4 row = *reinterpret_cast<const uint4*>(mask + rank * kTileWords);
        special[w] = __ballot_sync(0xffffffffu, (row.x | row.y | row.z | row.w) != 0u) |
                     ~self_kill[w];
        kept[w] = 0u;
      }
      int n = n_kept;
      bool stop = false;
#pragma unroll
      for (int w = 0; w < kTileWords; ++w) {
        while (!stop && live[w] != 0u) {
          const uint32_t spec = live[w] & special[w];
          const uint32_t first = spec & (0u - spec);  // lowest alive special rank, or 0
          uint32_t take = spec ? live[w] & (first - 1u) : live[w];
          const int room = max_det - n;
          if (__popc(take) >= room) {  // the rows fill up within this run
            uint32_t head = 0u;
            for (int q = 0; q < room; ++q) {
              head |= take & (0u - take);
              take &= take - 1u;
            }
            kept[w] |= head;
            n = max_det;
            stop = true;
            break;
          }
          kept[w] |= take;  // emitted: they leave the alive set
          live[w] &= ~take;
          n += __popc(take);
          if (spec == 0u) break;
          kept[w] |= first;
          live[w] &= ~first;
          ++n;
          const int bit = __ffs(spec) - 1;
          if (!((self_kill[w] >> bit) & 1u)) {  // Pallas rule: it stays the argmax
            fill = base + w * 32 + bit;
            stop = true;
            break;
          }
          const uint4 row = *reinterpret_cast<const uint4*>(mask + (w * 32 + bit) * kTileWords);
          live[0] &= ~row.x;
          live[1] &= ~row.y;
          live[2] &= ~row.z;
          live[3] &= ~row.w;
        }
      }
      int pos = n_kept;
#pragma unroll
      for (int w = 0; w < kTileWords; ++w) {
        if ((kept[w] >> lane) & 1u) {
          const int p = pos + __popc(kept[w] & ((1u << lane) - 1u));
          const float4 b = cur[w * 32 + lane];
          kept_box[p] = b;
          kept_area[p] = box_area(b);
          idx[p] = base + w * 32 + lane;
          valid[p] = 1;
        }
        pos += __popc(kept[w]);
      }
      if (lane == 0) {
        n_kept_s = n;
        fill_s = fill;
      }
    }
    cp_async_wait_all();  // tile t+1 has landed for this thread's copies
    __syncthreads();
    n_kept = n_kept_s;
    fill = fill_s;
  }
  for (int row = n_kept + tid; row < max_det; row += kThreads) {
    idx[row] = fill >= 0 ? fill : 0;
    valid[row] = fill >= 0;
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, int K,
                  int max_det, float iou_thres, int emit_once, int32_t* __restrict__ out_idx,
                  uint8_t* __restrict__ out_valid, int32_t* __restrict__ out_tiles) {
  // tiles, mask, kept buffer
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_pos_s;

  const int tid = threadIdx.x;
  const float4* bx = boxes + (size_t)blockIdx.x * K;
  const float* sc = scores + (size_t)blockIdx.x * K;
  int32_t* idx = out_idx + (size_t)blockIdx.x * max_det;
  uint8_t* valid = out_valid + (size_t)blockIdx.x * max_det;

  if (tid == 0) n_pos_s = 0;
  __syncthreads();
  // one pass over the scores: the length of the positive prefix
  int n_local = 0;
  for (int k = tid; k < K; k += kThreads) n_local += sc[k] > 0.f;
  n_local = __reduce_add_sync(0xffffffffu, n_local);
  if ((tid & 31) == 0 && n_local) atomicAdd(&n_pos_s, n_local);
  __syncthreads();
  const int t = tile_walk(smem, bx, n_pos_s, K, max_det, iou_thres, emit_once != 0, idx, valid);
  if (tid == 0) out_tiles[blockIdx.x] = t;
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel takes for K candidates and max_det rows:
// the two tiles, the overlap mask and the kept buffer.
int yolov6_greedy_nms_smem_bytes(int K, int max_det) {
  return kWalkFixedBytes + 20 * (max_det < K ? max_det : K);
}

// Lets launches on the current device take up to max_bytes of dynamic
// shared memory. Call once per device before its first launch; returns the
// CUDA error code.
int yolov6_greedy_nms_init(int max_bytes) {
  return (int)cudaFuncSetAttribute(greedy_nms_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
}

// boxes [B, K, 4] (16-byte aligned) and scores [B, K] fp32, contiguous,
// the positive scores of each image a non-increasing prefix; idx [B,
// max_det] int32, valid [B, max_det] bytes and tiles [B] int32 (tiles the
// walk visited) are written. emit_once != 0 selects the default rule, 0 the
// Pallas rule. Needs yolov6_greedy_nms_init on this device first, with at
// least yolov6_greedy_nms_smem_bytes(K, max_det). Launches on `stream` and
// returns the CUDA error code of the launch (0 on success); it does not
// synchronise.
int yolov6_greedy_nms(const void* boxes, const void* scores, int B, int K, int max_det,
                      float iou_thres, int emit_once, void* idx, void* valid, void* tiles,
                      void* stream) {
  const int smem = yolov6_greedy_nms_smem_bytes(K, max_det);
  greedy_nms_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)scores, K, max_det, iou_thres, emit_once,
      (int32_t*)idx, (uint8_t*)valid, (int32_t*)tiles);
  return (int)cudaGetLastError();
}

const char* yolov6_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
