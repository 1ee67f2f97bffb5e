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
// shapes (D = 2*L*Hkv*hd = 20480, N = 512) one step moves some 60 MB.
//
// What the design does about it:
//   * the kernel resolves tier[id] and slot[id] itself and reads ONLY the
//     selected tier's row (the TPU version DMAs both candidate rows and
//     selects; it also pads rows to 128 lanes, which is not carried over);
//   * one block per gather row; each thread moves 16-byte vectors, several
//     loads in flight before their stores, with a scalar tail for widths or
//     addresses that are not 16-byte aligned;
//   * the near/far counters: the TPU grid runs in order and carries them in
//     SMEM; blocks here run in parallel, so each gather makes one integer
//     atomicAdd into the (n_seg, 2) table the wrapper zeroed. Integer sums
//     are exact in any order, so counts are bit-exact with the plain version.
//   * far rows are float(q) * scale, one rounding, as the plain version
//     computes them: rows are bit-exact too.
// Indices follow JAX's indexing (a negative index counts from the end, what
// is still out of range is clamped); segment ids outside [0, n_seg) are
// dropped as jax.ops.segment_sum drops them.
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

__device__ __forceinline__ void zero_row(float* dst, int d) {
  for (int j = threadIdx.x; j < d; j += blockDim.x) dst[j] = 0.0f;
}

// One block per gather: resolve the tier and slot of ids[i], copy the
// selected row (near as is, far dequantized), count the hit into its segment.
template <typename NearT>
__global__ void __launch_bounds__(kThreads)
tiered_lookup_kernel(const NearT* __restrict__ near, long long near_rows,
                     const int8_t* __restrict__ far_q, const float* __restrict__ far_scale,
                     long long far_rows, const int32_t* __restrict__ tier,
                     const int32_t* __restrict__ slot, long long n_pages,
                     const int32_t* __restrict__ ids, const int32_t* __restrict__ seg_of,
                     int d, int n_seg, float* __restrict__ out, int32_t* __restrict__ seg_hits) {
  const int i = blockIdx.x;
  const long long id = clamp_idx(ids[i], n_pages);
  const int t = tier[id];
  const long long s = slot[id];
  float* dst = out + static_cast<long long>(i) * d;
  if (t == 0) {
    if (near_rows == 0) {
      zero_row(dst, d);
    } else {
      copy_row(near + clamp_idx(s, near_rows) * d, 1.0f, false, dst, d);
    }
  } else if (far_rows == 0) {
    zero_row(dst, d);
  } else {
    const long long c = clamp_idx(t == 1 ? s : 0, far_rows);
    copy_row(far_q + c * d, far_scale[c], true, dst, d);
  }
  if (threadIdx.x == 0) {
    const int g = seg_of != nullptr ? seg_of[i] : 0;
    if (g >= 0 && g < n_seg) atomicAdd(seg_hits + 2 * g + (t == 0 ? 0 : 1), 1);
  }
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
int tg_tiered_lookup(const void* near, int near_kind, long long near_rows,
                     const void* far_q, const void* far_scale, long long far_rows,
                     const void* tier, const void* slot, long long n_pages,
                     const void* ids, const void* seg_of, int n, int d, int n_seg,
                     void* out, void* seg_hits, void* stream) {
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* fq = static_cast<const int8_t*>(far_q);
    const auto* fs = static_cast<const float*>(far_scale);
    const auto* tr = static_cast<const int32_t*>(tier);
    const auto* sl = static_cast<const int32_t*>(slot);
    const auto* id = static_cast<const int32_t*>(ids);
    const auto* sg = static_cast<const int32_t*>(seg_of);
    auto* o = static_cast<float*>(out);
    auto* h = static_cast<int32_t*>(seg_hits);
    if (near_kind == 1) {
      tiered_lookup_kernel<__nv_bfloat16><<<n, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(near), near_rows, fq, fs, far_rows, tr, sl,
          n_pages, id, sg, d, n_seg, o, h);
    } else {
      tiered_lookup_kernel<float><<<n, kThreads, 0, st>>>(
          static_cast<const float*>(near), near_rows, fq, fs, far_rows, tr, sl, n_pages,
          id, sg, d, n_seg, o, h);
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

}  // extern "C"
