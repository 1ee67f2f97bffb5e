// Paged decode attention for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Replaces the Pallas TPU kernel paged_attention_kernel
// (src/repro/kernels/paged_attention/kernel.py:73, body _kernel :33-70): for
// each sequence b and KV head h, the G query heads of the group attend once
// over the first lengths[b] positions of a paged K/V pool (Hkv, P, ps, d),
// position t living in row t % ps of page page_table[b, t / ps], with an
// online softmax in f32 and scale 1/sqrt(d).
//
// What bounds it: bytes. Every K and V element up to each length is read
// once and used for G dot products, so decode stays far below the card's
// ridge: at 8 slots of some 550 positions, head_dim 64 and 5 KV heads, one
// launch moves some 5.6 MB, under 2 us at 3.35 TB/s.
//
// What the design does:
//   * one block per (KV head, sequence), the group's G query rows together,
//     so each K/V element is read from device memory once for all G heads;
//     the TPU's sequential page axis becomes a loop over 64-position chunks
//     inside the block, and the G <= 8 rows need no padding to 8 sublanes
//     (nor d to 128 lanes);
//   * the grid comes from shapes alone: each block reads its own length, so
//     the caller never reads lengths back to the host. Positions at or past
//     min(length, pp * ps) are masked and whole chunks past it are skipped,
//     so a length past the pool's end never reads past page pp - 1;
//   * each chunk is staged in shared memory as f32 by all 256 threads
//     (16-byte loads in the pool's type, through the pool's strides, so a
//     strided view of a contiguous per-slot cache needs no copy); then warp
//     g owns query row g: its 32 lanes score positions lane and lane + 32,
//     the chunk's max and sum are warp shuffles, and lane e accumulates
//     output columns e, e + 32, ... of the row in registers;
//   * the arithmetic is the TPU kernel's: scores times 1/sqrt(d), masked to
//     -1e30, p = exp(s - m_new) kept in f32 for PV, acc and l rescaled by
//     exp(m - m_new), the final divide clamped at 1e-30. Every reduction runs
//     in a fixed order, so two runs give the same bits.
// Page ids follow JAX's indexing: a negative id counts from the end, what
// is still out of range is clamped.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // positions staged per iteration
constexpr int kMaxG = 8;       // query heads per KV head; one warp each
constexpr int kThreads = 32 * kMaxG;
constexpr float kNegInf = -1e30f;

template <int D>
struct Layout {
  static constexpr int kStride = D + 4;  // floats per staged K/V row
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * kChunk * kStride + kMaxG * D + kMaxG * kChunk);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

template <typename T, int V>
__device__ __forceinline__ void load16(const T* src, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = to_f32(e[k]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, long long q_sb, long long q_sh,
                    const TKV* __restrict__ kp, long long k_sh, long long k_sp, long long k_sr,
                    const TKV* __restrict__ vp, long long v_sh, long long v_sp, long long v_sr,
                    const int32_t* __restrict__ page_table, int pp, long long n_phys,
                    const int32_t* __restrict__ lengths, int ps, int group, float scale,
                    TQ* __restrict__ out) {
  constexpr int S = Layout<D>::kStride;
  constexpr int V = 16 / sizeof(TKV);  // K/V elements per 16-byte load
  constexpr int VPR = D / V;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kChunk * S;
  float* qs = vs + kChunk * S;
  float* pr = qs + kMaxG * D;

  const int h = blockIdx.x, b = blockIdx.y, hkv = gridDim.x;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cap = static_cast<long long>(pp) * ps;
  const int len = static_cast<int>(min(static_cast<long long>(lengths[b]), cap));
  const int32_t* pt = page_table + static_cast<long long>(b) * pp;

  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int g = i / D, e = i % D;
    qs[i] = to_f32(q[b * q_sb + (static_cast<long long>(h) * group + g) * q_sh + e]);
  }

  float m = kNegInf, l = 0.0f, acc[D / 32];
#pragma unroll
  for (int c = 0; c < D / 32; ++c) acc[c] = 0.0f;

  for (int c0 = 0; c0 < len; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done (and q is staged)
    for (int i = threadIdx.x; i < kChunk * VPR; i += kThreads) {
      const int r = i / VPR, e = (i % VPR) * V;
      const int pos = c0 + r;
      float fk[V], fv[V];
      if (pos < len) {
        long long page = pt[pos / ps];
        page = page < 0 ? page + n_phys : page;
        page = page < 0 ? 0 : (page >= n_phys ? n_phys - 1 : page);
        const long long row = pos % ps;
        load16<TKV, V>(kp + h * k_sh + page * k_sp + row * k_sr + e, fk);
        load16<TKV, V>(vp + h * v_sh + page * v_sp + row * v_sr + e, fv);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) fk[k] = fv[k] = 0.0f;
      }
      float4* ok = reinterpret_cast<float4*>(ks + r * S + e);
      float4* ov = reinterpret_cast<float4*>(vs + r * S + e);
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        ok[k] = make_float4(fk[4 * k], fk[4 * k + 1], fk[4 * k + 2], fk[4 * k + 3]);
        ov[k] = make_float4(fv[4 * k], fv[4 * k + 1], fv[4 * k + 2], fv[4 * k + 3]);
      }
    }
    __syncthreads();
    if (w < group) {  // warp-uniform
      const float* qrow = qs + w * D;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 8
      for (int e = 0; e < D; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qrow + e);
        s0 = dot4(a, *reinterpret_cast<const float4*>(ks + lane * S + e), s0);
        s1 = dot4(a, *reinterpret_cast<const float4*>(ks + (lane + 32) * S + e), s1);
      }
      s0 = c0 + lane < len ? s0 * scale : kNegInf;
      s1 = c0 + lane + 32 < len ? s1 * scale : kNegInf;
      float cmax = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float psum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l = l * corr + psum;
      m = m_new;
      float* prow = pr + w * kChunk;
      prow[lane] = p0;
      prow[lane + 32] = p1;
      __syncwarp();
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[c] *= corr;
#pragma unroll 4
      for (int t = 0; t < kChunk; ++t) {
        const float p = prow[t];
        const float* vrow = vs + t * S + lane;
#pragma unroll
        for (int c = 0; c < D / 32; ++c) acc[c] = fmaf(p, vrow[32 * c], acc[c]);
      }
    }
  }

  if (w < group) {
    const float denom = fmaxf(l, 1e-30f);
    TQ* orow = out + (static_cast<long long>(b) * hkv * group + static_cast<long long>(h) * group + w) * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) from_f32(acc[c] / denom, orow + lane + 32 * c);
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const long long* qs, const void* k, const long long* ks,
           const void* v, const long long* vs, const void* page_table, int pp,
           long long n_phys, const void* lengths, int ps, int b, int hkv, int group,
           float scale, void* out, cudaStream_t st) {
  auto kern = paged_decode_kernel<TQ, TKV, D>;
  const size_t smem = Layout<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(hkv, b), kThreads, smem, st>>>(
      static_cast<const TQ*>(q), qs[0], qs[1], static_cast<const TKV*>(k), ks[0], ks[1], ks[2],
      static_cast<const TKV*>(v), vs[0], vs[1], vs[2], static_cast<const int32_t*>(page_table),
      pp, n_phys, static_cast<const int32_t*>(lengths), ps, group, scale, static_cast<TQ*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Hq, D) with strides {batch, head}; k and v pools (Hkv, P, ps, D)
// with strides {head, page, row}; unit stride along D everywhere.
// page_table (B, pp) and lengths (B,) int32, contiguous; out (B, Hq, D)
// contiguous in q's type. q_kind / kv_kind: 0 = float32, 1 = bfloat16;
// head_dim 64 or 128; group = Hq / Hkv <= 8. Returns a CUDA error code
// (cudaErrorInvalidValue for a combination not built).
int pa_decode(const void* q, const long long* q_strides, const void* k,
              const long long* k_strides, const void* v, const long long* v_strides,
              const void* page_table, int pp, long long n_phys, const void* lengths,
              int ps, int q_kind, int kv_kind, int head_dim, int b, int hkv, int group,
              float scale, void* out, void* stream) {
  if (b == 0 || hkv == 0) return static_cast<int>(cudaGetLastError());
  if (group < 1 || group > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS q, q_strides, k, k_strides, v, v_strides, page_table, pp, n_phys, lengths, \
                ps, b, hkv, group, scale, out, st
#define PA_HD(TQ, TKV)                                             \
  if (head_dim == 64) return launch<TQ, TKV, 64>(PA_ARGS);         \
  if (head_dim == 128) return launch<TQ, TKV, 128>(PA_ARGS);
  if (q_kind == 0 && kv_kind == 0) { PA_HD(float, float) }
  if (q_kind == 0 && kv_kind == 1) { PA_HD(float, __nv_bfloat16) }
  if (q_kind == 1 && kv_kind == 0) { PA_HD(__nv_bfloat16, float) }
  if (q_kind == 1 && kv_kind == 1) { PA_HD(__nv_bfloat16, __nv_bfloat16) }
#undef PA_HD
#undef PA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
