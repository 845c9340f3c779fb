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
// Two algorithms, chosen per image by the block itself (out_path):
//
// path 1, the tile walk, when the positive scores form a non-increasing
// prefix, which is how the selection stage hands candidates over (a stable
// descending sort, the tail below conf zeroed). The first alive candidate is
// then the argmax, so greedy NMS is a walk over the prefix in order. What
// bounds the walk is its dependent chain, not bytes or operations: each
// input byte is read once and the IoU work is a few hundred thousand
// operations an image. The design keeps that chain short and on chip:
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
// under the class offset, skip the IEEE division (iou_above).
//
// path 0, the argmax loop, for any other order (PR 1's design): the working
// scores live in dynamic shared memory (4*K bytes; a killed candidate's
// score becomes -1, which stands in for the alive mask); per step a thread
// scan, a warp-shuffle argmax with the lower index winning ties, a
// cross-warp reduction, then a strided IoU pass over the alive boxes read
// from global memory (L2). Its time is about max_det times the latency of
// one step. It stops early once nothing is alive. No caller in the package
// reaches it, since non_max_suppression always hands over sorted candidates;
// it serves direct callers of greedy_nms with candidates in another order.
//
// Both paths use one block of 1024 threads per image, so only B of the 132
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
constexpr int kWarps = kThreads / 32;
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

// Path 0: max_det argmax steps over the working scores in `work`.
__device__ void argmax_loop(float* work, const float4* __restrict__ bx, int K, int max_det,
                            float iou_thres, bool emit_once, int32_t* __restrict__ idx,
                            uint8_t* __restrict__ valid) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float best_v;
  __shared__ int best_i;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

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
    const float area_cur = box_area(c);
    for (int k = tid; k < K; k += kThreads) {
      if (work[k] > 0.f) {
        const float4 o = bx[k];
        if ((emit_once && k == cur) || iou_above(c, area_cur, o, box_area(o), iou_thres)) {
          work[k] = -1.f;
        }
      }
    }
    __syncthreads();
  }
}

// Path 1: the tile walk over the sorted prefix of n_pos candidates. Returns
// the number of tiles visited.
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
                  uint8_t* __restrict__ out_valid, uint8_t* __restrict__ out_path,
                  int32_t* __restrict__ out_tiles) {
  // path 0: [K] alive scores, or -1 once dead; path 1: tiles, mask, kept buffer
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_pos_s;

  const int tid = threadIdx.x;
  const float4* bx = boxes + (size_t)blockIdx.x * K;
  const float* sc = scores + (size_t)blockIdx.x * K;
  int32_t* idx = out_idx + (size_t)blockIdx.x * max_det;
  uint8_t* valid = out_valid + (size_t)blockIdx.x * max_det;
  float* work = reinterpret_cast<float*>(smem);

  if (tid == 0) n_pos_s = 0;
  __syncthreads();
  // one pass over the scores: the working copy, the count of positive
  // scores, and whether they form a non-increasing prefix
  int n_local = 0;
  int in_order = 1;
  for (int k = tid; k < K; k += kThreads) {
    const float s = sc[k];
    work[k] = s > 0.f ? s : -1.f;
    n_local += s > 0.f;
    if (k + 1 < K) {
      const float next = sc[k + 1];
      in_order &= !(next > 0.f) || s >= next;
    }
  }
  n_local = __reduce_add_sync(0xffffffffu, n_local);
  if ((tid & 31) == 0 && n_local) atomicAdd(&n_pos_s, n_local);
  const bool sorted = __syncthreads_and(in_order);
  const int n_pos = n_pos_s;

  if (sorted) {
    const int t = tile_walk(smem, bx, n_pos, K, max_det, iou_thres, emit_once != 0, idx, valid);
    if (tid == 0) {
      out_path[blockIdx.x] = 1;
      out_tiles[blockIdx.x] = t;
    }
  } else {
    if (tid == 0) {
      out_path[blockIdx.x] = 0;
      out_tiles[blockIdx.x] = 0;
    }
    argmax_loop(work, bx, K, max_det, iou_thres, emit_once != 0, idx, valid);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel takes for K candidates and max_det rows:
// the larger of path 0's working scores and path 1's tiles, mask and kept
// buffer.
int yolov6_greedy_nms_smem_bytes(int K, int max_det) {
  const int walk = kWalkFixedBytes + 20 * (max_det < K ? max_det : K);
  return 4 * K > walk ? 4 * K : walk;
}

// Lets launches on the current device take up to max_bytes of dynamic
// shared memory. Call once per device before its first launch; returns the
// CUDA error code.
int yolov6_greedy_nms_init(int max_bytes) {
  return (int)cudaFuncSetAttribute(greedy_nms_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
}

// boxes [B, K, 4] (16-byte aligned) and scores [B, K] fp32, contiguous;
// idx [B, max_det] int32, valid [B, max_det] bytes, path [B] bytes (1 for
// the tile walk, 0 for the argmax loop) and tiles [B] int32 (tiles the walk
// visited) are written. emit_once != 0 selects the default rule, 0 the
// Pallas rule. Needs yolov6_greedy_nms_init on this device first, with at
// least yolov6_greedy_nms_smem_bytes(K, max_det). Launches on `stream` and
// returns the CUDA error code of the launch (0 on success); it does not
// synchronise.
int yolov6_greedy_nms(const void* boxes, const void* scores, int B, int K, int max_det,
                      float iou_thres, int emit_once, void* idx, void* valid, void* path,
                      void* tiles, void* stream) {
  const int smem = yolov6_greedy_nms_smem_bytes(K, max_det);
  greedy_nms_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)scores, K, max_det, iou_thres, emit_once,
      (int32_t*)idx, (uint8_t*)valid, (uint8_t*)path, (int32_t*)tiles);
  return (int)cudaGetLastError();
}

const char* yolov6_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
