// Flash attention forward for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py:76, body _kernel :31-73):
// blocked causal or non-causal attention with an online softmax in f32,
// GQA (query head h reads KV head h / group), keys at kpos >= lk_valid
// masked, and, when causal, kpos <= qpos + q_offset.
//
// What bounds it: at the serving prefill (one prompt of L = 512, head_dim
// 64 or 128) the work is 4 * Hq * L^2/2 * D operations (QK^T and PV, half
// of them under the causal mask) against some 2.6 MB of q, k, v and o
// (smollm-360m's widths): below the bf16 ridge of the card at that length,
// so bytes bound it there and operations from about L = 700-800 up. This
// first kernel runs its products on the f32 CUDA cores, far from either
// bound; wgmma, TMA and warp specialisation are later work.
//
// What the design does:
//   * one block per (q tile of 64 rows, q head, batch); the TPU's sequential
//     KV grid axis becomes a loop over 64-row K/V tiles inside the block,
//     which stops at the diagonal when causal and at lk_valid always;
//   * q, k and v are read in their type through their strides (the model
//     hands in transposed projection views, no copy) and widened to f32 in
//     shared memory, rows padded by 4 floats so the float4 reads below hit
//     distinct banks; ragged tiles are zero-filled and masked, so neither
//     the head padding to 128 lanes nor the block padding of the TPU op is
//     carried over;
//   * 256 threads as 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3,
//     key columns tx + 16j of the score tile and output columns 4tx..4tx+3
//     (and 64 + 4tx.. at D = 128). A row's max and sum are butterfly
//     shuffles over the 16 lanes of its half-warp, the P tile goes through
//     shared memory to the PV product, m, l and acc stay in registers;
//   * the arithmetic is the TPU kernel's: scores times 1/sqrt(d), masked to
//     -1e30, p = exp(s - m_new), acc and l rescaled by exp(m - m_new), p kept
//     in f32 for PV, the final divide clamped at 1e-30. Every reduction runs
//     in a fixed order, so two runs give the same bits.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPStride = kBK + 4;
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int kStride = D + 4;  // floats per staged row
  static constexpr int kCols = D / 64;   // float4 output groups per thread
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((kBQ + 2 * kBK) * kStride + kBQ * kPStride);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

// Stage `rows` rows of D elements (row r at src + r * row_stride) into dst
// as f32, each row kStride floats apart; rows at or past `valid` are zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, long long row_stride,
                                           int valid, float* __restrict__ dst) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = D / V;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * V;
    float f[V];
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = to_f32(e[k]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = 0.0f;
    }
    float4* o = reinterpret_cast<float4*>(dst + r * Tile<D>::kStride + c);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) o[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float lane_of(float4 v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, long long q_sb, long long q_sh, long long q_sl,
                 const T* __restrict__ k, long long k_sb, long long k_sh, long long k_sl,
                 const T* __restrict__ v, long long v_sb, long long v_sh, long long v_sl,
                 T* __restrict__ o, int hq, int group, int lq, int lk, int causal,
                 int lk_valid, int q_offset, float scale) {
  using TL = Tile<D>;
  constexpr int S = TL::kStride;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * S;
  float* vs = ks + kBK * S;
  float* ps = vs + kBK * S;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  stage_rows<T, D, kBQ>(q + b * q_sb + h * q_sh + q0 * q_sl, q_sl, lq - q0, qs);

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float m[4], l[4], acc[4][4 * TL::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * TL::kCols; ++c) acc[i][c] = 0.0f;
  }

  // keys any row of this block can see
  int k_end = min(lk_valid, lk);
  if (causal) k_end = min(k_end, min(lq, q0 + kBQ) - 1 + q_offset + 1);
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, D, kBK>(kb + k0 * k_sl, k_sl, lk - k0, ks);
    stage_rows<T, D, kBK>(vb + k0 * v_sl, v_sl, lk - k0, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * S + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * S + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < lk_valid && (!causal || kpos <= qpos + q_offset);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * TL::kCols; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(4 * ty + i) * kPStride + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kPStride + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * S + 4 * tx;
#pragma unroll
        for (int g = 0; g < TL::kCols; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + 64 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = lane_of(pa[i], u);
            acc[i][4 * g + 0] = fmaf(p, w.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, w.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, w.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, w.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * hq + h) * lq + row) * D + 4 * tx;
#pragma unroll
    for (int g = 0; g < TL::kCols; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) from_f32(acc[i][4 * g + c] / denom, orow + 64 * g + c);
  }
}

template <typename T, int D>
int launch(const void* q, const long long* qs, const void* k, const long long* ks,
           const void* v, const long long* vs, void* o, int b, int hq, int hkv, int lq,
           int lk, int causal, int lk_valid, int q_offset, float scale, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = Tile<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kBQ - 1) / kBQ, hq, b);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), qs[0], qs[1], qs[2], static_cast<const T*>(k), ks[0], ks[1],
      ks[2], static_cast<const T*>(v), vs[0], vs[1], vs[2], static_cast<T*>(o), hq, hq / hkv,
      lq, lk, causal, lk_valid, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), each with element strides
// {batch, head, row} and unit stride along D; o (B, Hq, Lq, D) contiguous.
// kind: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Returns a CUDA error
// code (cudaErrorInvalidValue for a kind or head_dim not built).
int fa_forward(const void* q, const long long* q_strides, const void* k,
               const long long* k_strides, const void* v, const long long* v_strides,
               void* o, int kind, int head_dim, int b, int hq, int hkv, int lq, int lk,
               int causal, int lk_valid, int q_offset, float scale, void* stream) {
  if (b == 0 || lq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, q_strides, k, k_strides, v, v_strides, o, b, hq, hkv, lq, lk, causal, \
                lk_valid, q_offset, scale, st
  if (kind == 0 && head_dim == 64) return launch<float, 64>(FA_ARGS);
  if (kind == 0 && head_dim == 128) return launch<float, 128>(FA_ARGS);
  if (kind == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(FA_ARGS);
  if (kind == 1 && head_dim == 128) return launch<__nv_bfloat16, 128>(FA_ARGS);
#undef FA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
