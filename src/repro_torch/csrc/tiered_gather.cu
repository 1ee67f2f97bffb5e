// Tiered row-gather kernels for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/tiered_gather/kernel.py:
//   tiered_segmented_kernel (kernel.py:133) -> tiered_lookup_kernel, n_seg >= 1
//   tiered_gather_kernel    (kernel.py:186) -> tiered_lookup_kernel, n_seg == 1
//   gather_rows_kernel      (kernel.py:52)  -> gather_rows_kernel
//
// What bounds it: bytes. Each gather reads one selected row (f32/bf16 near,
// or int8 far plus one f32 scale) and writes one f32 row; there are no
// operations to speak of beyond one multiply per far element. At the serving
// shapes (D = 2*L*Hkv*hd = 20480, N = 512) one step moves some 55 MB, three
// quarters of it the f32 rows written.
//
// Both kernels resolve tier[id] and slot[id] themselves and read ONLY the
// selected tier's row (the TPU version DMAs both candidate rows and
// selects; it also pads rows to 128 lanes, which is not carried over).
// Indices follow JAX's indexing (a negative index counts from the end, what
// is still out of range is clamped); segment ids outside [0, n_seg) are
// dropped as jax.ops.segment_sum drops them. Far rows are float(q) * scale,
// one rounding, as the plain version computes them: rows are bit-exact.
//
// The tiered lookup, the design (phase clocks of a -DTG_PHASE_CLOCKS build,
// repro_torch.kernels.compare, guided it):
//   * rows are cut into pieces of kPiece elements, and a persistent grid of
//     kBlocksPerSM blocks an SM walks the (row, piece) items in order, block
//     b taking items b, b + G, ... So the near rows (80 KB read, 80 KB
//     written at f32) and the far ones (20 KB read) spread evenly over the
//     blocks, the whole grid is resident at once, and at any time it writes
//     a window of neighbouring rows;
//   * each block resolves the tier and slot of all its items at once, one
//     thread an item, into shared memory: one chain of dependent reads
//     (ids -> tier, slot) a block instead of one per row;
//   * kPiece and kBlocksPerSM were the fastest of pieces of 1024 to 4096
//     elements at 2 to 5 blocks an SM. A grid of one block a row that is
//     all resident at once (more row streams side by side) was slower than
//     the two waves of one block a row it replaces;
//   * the (n_seg, 2) hit table is counted by one more block of the same
//     launch, in shared memory with integer atomics (exact in any order),
//     and written whole: no zero-fill launch before the kernel and no global
//     atomics.
// gather_rows_kernel: one block per gather row, 16-byte vectors, several
// loads in flight before their stores, a scalar tail for widths or
// addresses that are not 16-byte aligned.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

__device__ __forceinline__ long long clamp_idx(long long i, long long n) {
  i = i < 0 ? i + n : i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// One 16-byte load of T, widened to V floats.
template <typename T>
struct Vec {
  static constexpr int V = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float* o) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = to_f32(e[k]);
  }
};

// dst[j] = float(src[j]) (* scale when scaled), the block's threads together.
template <typename T>
__device__ __forceinline__ void copy_row(const T* __restrict__ src, float scale,
                                         bool scaled, float* __restrict__ dst, int d) {
  constexpr int V = Vec<T>::V;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int nvec = aligned ? d / V : 0;
  for (int base = threadIdx.x; base < nvec; base += blockDim.x * kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * blockDim.x;
      if (c < nvec) Vec<T>::load(src + static_cast<long long>(c) * V, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * blockDim.x;
      if (c < nvec) {
        float4* o = reinterpret_cast<float4*>(dst + static_cast<long long>(c) * V);
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          float4 w;
          w.x = scaled ? v[u][4 * q + 0] * scale : v[u][4 * q + 0];
          w.y = scaled ? v[u][4 * q + 1] * scale : v[u][4 * q + 1];
          w.z = scaled ? v[u][4 * q + 2] * scale : v[u][4 * q + 2];
          w.w = scaled ? v[u][4 * q + 3] * scale : v[u][4 * q + 3];
          o[q] = w;
        }
      }
    }
  }
  for (int j = nvec * V + threadIdx.x; j < d; j += blockDim.x) {
    const float x = to_f32(src[j]);
    dst[j] = scaled ? x * scale : x;
  }
}

constexpr int kPiece = 2048;      // elements of a row a block moves at a time (8 KB of f32)
constexpr int kBlocksPerSM = 3;   // the lookup's persistent grid
constexpr int kCountCap = 2048;   // segments the counting block holds a pass

#ifdef TG_PHASE_CLOCKS
// Development build only (repro_torch.kernels.compare): per block, the
// global timer (ns) at its start, once its first items are resolved and at
// its end, and its items.
constexpr int kClockBlocks = 4096;
__device__ unsigned long long tg_clock[4 * kClockBlocks];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// dst[j] = float(src[j]) (* scale when scaled) for a piece of len <= kPiece
// elements, the block's threads together: every 16-byte load of a thread
// in flight before its stores.
template <typename T>
__device__ __forceinline__ void move_piece(const T* __restrict__ src, float scale, bool scaled,
                                           float* __restrict__ dst, int len) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = (kPiece / V + kThreads - 1) / kThreads;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int nvec = aligned ? len / V : 0;
  uint4 raw[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int c = threadIdx.x + u * kThreads;
    if (c < nvec) raw[u] = __ldg(reinterpret_cast<const uint4*>(src) + c);
  }
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int c = threadIdx.x + u * kThreads;
    if (c < nvec) {
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      float4* o = reinterpret_cast<float4*>(dst + static_cast<long long>(c) * V);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        float4 w = make_float4(to_f32(e[4 * q]), to_f32(e[4 * q + 1]), to_f32(e[4 * q + 2]),
                               to_f32(e[4 * q + 3]));
        if (scaled) w.x *= scale, w.y *= scale, w.z *= scale, w.w *= scale;
        o[q] = w;
      }
    }
  }
  for (int j = nvec * V + threadIdx.x; j < len; j += kThreads) {
    const float x = to_f32(src[j]);
    dst[j] = scaled ? x * scale : x;
  }
}

// The (n_seg, 2) table of (near, far) hits, whole, by one block: segment
// ids outside [0, n_seg) are dropped.
__device__ void count_hits(const int32_t* __restrict__ tier, long long n_pages,
                           const int32_t* __restrict__ ids, const int32_t* __restrict__ seg_of,
                           int n, int n_seg, int32_t* __restrict__ seg_hits) {
  __shared__ int hist[2 * kCountCap];
  for (int g0 = 0; g0 < n_seg; g0 += kCountCap) {
    const int m = min(kCountCap, n_seg - g0);
    for (int j = threadIdx.x; j < 2 * m; j += kThreads) hist[j] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int g = (seg_of != nullptr ? seg_of[j] : 0) - g0;
      if (g >= 0 && g < m) atomicAdd(hist + 2 * g + (tier[clamp_idx(ids[j], n_pages)] == 0 ? 0 : 1), 1);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * m; j += kThreads) seg_hits[2 * g0 + j] = hist[j];
    __syncthreads();
  }
}

// Blocks 0 .. G-1 move the (row, piece) items b, b + G, ... (near as is,
// far dequantized); block G counts the hits.
template <typename NearT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
tiered_lookup_kernel(const NearT* __restrict__ near, long long near_rows,
                     const int8_t* __restrict__ far_q, const float* __restrict__ far_scale,
                     long long far_rows, const int32_t* __restrict__ tier,
                     const int32_t* __restrict__ slot, long long n_pages,
                     const int32_t* __restrict__ ids, const int32_t* __restrict__ seg_of,
                     int n, int d, int n_seg, float* __restrict__ out,
                     int32_t* __restrict__ seg_hits) {
  const int G = gridDim.x - 1;
  if (blockIdx.x == G) {
    count_hits(tier, n_pages, ids, seg_of, n, n_seg, seg_hits);
    return;
  }
#ifdef TG_PHASE_CLOCKS
  const unsigned long long c0 = global_ns();
  unsigned long long c1 = 0;
#endif
  __shared__ int item_tier[kThreads];
  __shared__ long long item_slot[kThreads];
  const int pieces = (d + kPiece - 1) / kPiece;
  const long long items = static_cast<long long>(n) * pieces;
  for (long long w0 = blockIdx.x; w0 < items; w0 += static_cast<long long>(G) * kThreads) {
    const long long w = w0 + static_cast<long long>(threadIdx.x) * G;
    if (w < items) {
      const long long id = clamp_idx(ids[w / pieces], n_pages);
      item_tier[threadIdx.x] = tier[id];
      item_slot[threadIdx.x] = slot[id];
    }
    __syncthreads();
#ifdef TG_PHASE_CLOCKS
    if (c1 == 0) c1 = global_ns();
#endif
    for (int q = 0; q < kThreads && w0 + static_cast<long long>(q) * G < items; ++q) {
      const long long wq = w0 + static_cast<long long>(q) * G;
      const int t = item_tier[q];
      const long long s = item_slot[q];
      const long long i = wq / pieces;
      const int j0 = static_cast<int>(wq % pieces) * kPiece;
      const int len = min(kPiece, d - j0);
      float* dst = out + i * d + j0;
      if (t == 0) {
        if (near_rows == 0) {
          for (int j = threadIdx.x; j < len; j += kThreads) dst[j] = 0.0f;
        } else {
          move_piece(near + clamp_idx(s, near_rows) * d + j0, 1.0f, false, dst, len);
        }
      } else if (far_rows == 0) {
        for (int j = threadIdx.x; j < len; j += kThreads) dst[j] = 0.0f;
      } else {
        const long long c = clamp_idx(t == 1 ? s : 0, far_rows);
        move_piece(far_q + c * d + j0, far_scale[c], true, dst, len);
      }
    }
    __syncthreads();  // the next batch's resolution overwrites the item table
  }
#ifdef TG_PHASE_CLOCKS
  if (threadIdx.x == 0 && blockIdx.x < kClockBlocks) {
    unsigned long long* c = tg_clock + 4 * blockIdx.x;
    c[0] = c0, c[1] = c1, c[2] = global_ns(), c[3] = (items - blockIdx.x + G - 1) / G;
  }
#endif
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ src, long long m, const int32_t* __restrict__ ids,
                   int d, const float* __restrict__ scales, float* __restrict__ out) {
  const int i = blockIdx.x;
  const long long r = clamp_idx(ids[i], m);
  copy_row(src + r * d, scales != nullptr ? scales[r] : 1.0f, scales != nullptr,
           out + static_cast<long long>(i) * d, d);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// near_kind: 0 = float32, 1 = bfloat16. seg_of may be null (one segment).
// seg_hits (n_seg, 2) int32 is written whole (it need not be zeroed).
int tg_tiered_lookup(const void* near, int near_kind, long long near_rows,
                     const void* far_q, const void* far_scale, long long far_rows,
                     const void* tier, const void* slot, long long n_pages,
                     const void* ids, const void* seg_of, int n, int d, int n_seg,
                     void* out, void* seg_hits, void* stream) {
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long items = static_cast<long long>(n) * ((d + kPiece - 1) / kPiece);
    const int grid = static_cast<int>(items < kBlocksPerSM * sms ? items : kBlocksPerSM * sms) + 1;
    const auto* fq = static_cast<const int8_t*>(far_q);
    const auto* fs = static_cast<const float*>(far_scale);
    const auto* tr = static_cast<const int32_t*>(tier);
    const auto* sl = static_cast<const int32_t*>(slot);
    const auto* id = static_cast<const int32_t*>(ids);
    const auto* sg = static_cast<const int32_t*>(seg_of);
    auto* o = static_cast<float*>(out);
    auto* h = static_cast<int32_t*>(seg_hits);
    if (near_kind == 1) {
      tiered_lookup_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(near), near_rows, fq, fs, far_rows, tr, sl,
          n_pages, id, sg, n, d, n_seg, o, h);
    } else {
      tiered_lookup_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(near), near_rows, fq, fs, far_rows, tr, sl, n_pages,
          id, sg, n, d, n_seg, o, h);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// src_kind: 0 = float32, 1 = bfloat16, 2 = int8. scales may be null.
int tg_gather_rows(const void* src, int src_kind, long long m, const void* ids, int n,
                   int d, const void* scales, void* out, void* stream) {
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* id = static_cast<const int32_t*>(ids);
    const auto* sc = static_cast<const float*>(scales);
    auto* o = static_cast<float*>(out);
    if (src_kind == 1) {
      gather_rows_kernel<__nv_bfloat16><<<n, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(src), m, id, d, sc, o);
    } else if (src_kind == 2) {
      gather_rows_kernel<int8_t><<<n, kThreads, 0, st>>>(
          static_cast<const int8_t*>(src), m, id, d, sc, o);
    } else {
      gather_rows_kernel<float><<<n, kThreads, 0, st>>>(
          static_cast<const float*>(src), m, id, d, sc, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef TG_PHASE_CLOCKS
// The lookup's phase clocks of its first n blocks into host (4 n values).
int tg_phase_clocks(unsigned long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, tg_clock, sizeof(unsigned long long) * 4 * n));
}
#endif

}  // extern "C"
