// Chunked WKV6 (RWKV6 linear attention, per-channel decay) for Hopper
// (sm_90a), bound to PyTorch by ctypes.
//
// Replaces the Pallas TPU kernel wkv6_chunked_kernel
// (src/repro/kernels/rwkv6_scan/kernel.py:77, body _kernel :32-74). Per
// (batch b, head h), over the tokens of a sequence, with lw <= 0 the log
// decay:
//
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
//
// computed chunk by chunk in the TPU kernel's closed form. Within a chunk
// of n <= kC tokens, with cw the inclusive cumulative sum of lw over the
// chunk (per channel) and cw[-1] = 0:
//
//   A[t,s] = sum_k r[t,k] k[s,k] exp(cw[t-1,k] - cw[s,k])   (s < t)
//   A[t,t] = sum_k r[t,k] u[k] k[t,k]
//   y      = A v + (r o exp(cw[t-1])) S_in
//   S_out  = diag(exp(cw[n-1])) S_in + (k o exp(cw[n-1] - cw))^T v
//
// What bounds it: bytes. At rwkv6-7b's prefill (one prompt of T = 512, 64
// heads of 64) the call reads r, k, v, lw and writes y, 42 MB in f32, and
// writes the 1 MB state: some 13 us at 3.35 TB/s, against some 0.8 GFLOP
// of f32 work (12 us at 67 TFLOP/s). At decode (8 slots, T = 1) it reads
// and writes the 8 MB state: 5 us.
//
// What the design does:
//   * one block per (b, h). The TPU grid's sequential chunk axis becomes a
//     loop over chunks inside the block, with the (hd, hd) f32 state in
//     shared memory (16 KB at hd = 64) for the whole sequence;
//   * no (C, C, hd) decay tensor (1 MiB at C = hd = 64 on the TPU): each
//     A[t,s] is a dot product over k whose terms take their own exponent.
//     Every exponent is a difference cw[t-1,k] - cw[s,k] of one running sum
//     of non-positive terms, so it is <= 0 in floating point too, and
//     nothing overflows however strong the decay. The factored form
//     (r exp(cw)) (k exp(-cw))^T would overflow f32 once -cw passes ~88
//     (the TPU kernel's note, :14-17), so it is not used;
//   * r, k, v and lw are read in model layout (B, T, H, hd) through their
//     strides: no transpose and no padding of T. The ragged last chunk is
//     masked by running its loops to n, so a decode step (T = 1) does one
//     token's work;
//   * tiles are padded to hd + 1 floats a row, so the k and cw reads of a
//     warp that walks s hit distinct banks;
//   * every sum is taken by one thread in a fixed order (no float atomics):
//     two runs give the same bits;
//   * the block reads the initial state once at its start and writes the
//     final state once at its end, and no other block touches that (b, h)
//     state, so the final state may be written over the initial one (the
//     model's decode updates its cache this way, in place).
// f32 products on the CUDA cores: wgmma and TMA are later work.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kC = 32;         // tokens per chunk
constexpr int kThreads = 256;

template <int HD>
struct Smem {
  static constexpr int kLd = HD + 1;  // floats per staged (token) row
  static constexpr int kALd = kC + 1;
  static constexpr size_t kBytes =
      sizeof(float) * (4 * kC * kLd + kC * kALd + HD * HD + 2 * HD);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, long long r_sb, long long r_st, long long r_sh,
            const float* __restrict__ k, long long k_sb, long long k_st, long long k_sh,
            const float* __restrict__ v, long long v_sb, long long v_st, long long v_sh,
            const float* __restrict__ lw, long long w_sb, long long w_st, long long w_sh,
            const float* __restrict__ u, const float* s0, float* __restrict__ y,
            float* s_out, int T, int H) {
  constexpr int L = Smem<HD>::kLd;
  constexpr int AL = Smem<HD>::kALd;
  extern __shared__ float smem[];
  float* rs = smem;            // r, then r o exp(cw[t-1])
  float* ks = rs + kC * L;     // k, then k o exp(cw[n-1] - cw)
  float* vs = ks + kC * L;
  float* cw = vs + kC * L;     // lw, then its inclusive cumulative sum
  float* as = cw + kC * L;     // A (n x n, lower triangle)
  float* st = as + kC * AL;    // state (HD x HD), [k][v]
  float* us = st + HD * HD;    // u
  float* tail = us + HD;       // exp(cw[n-1])

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const long long sbase = static_cast<long long>(blockIdx.x) * HD * HD;

  for (int i = tid; i < HD * HD; i += kThreads) st[i] = s0 ? s0[sbase + i] : 0.0f;
  for (int i = tid; i < HD; i += kThreads) us[i] = u[h * HD + i];

  for (int c0 = 0; c0 < T; c0 += kC) {
    const int n = min(kC, T - c0);
    __syncthreads();  // the previous chunk's readers are done (and the state is staged)
    for (int i = tid; i < n * HD; i += kThreads) {
      const int t = i / HD, e = i % HD;
      const long long tt = c0 + t;
      rs[t * L + e] = r[b * r_sb + tt * r_st + h * r_sh + e];
      ks[t * L + e] = k[b * k_sb + tt * k_st + h * k_sh + e];
      vs[t * L + e] = v[b * v_sb + tt * v_st + h * v_sh + e];
      cw[t * L + e] = lw[b * w_sb + tt * w_st + h * w_sh + e];
    }
    __syncthreads();
    for (int e = tid; e < HD; e += kThreads) {
      float run = 0.0f;
      for (int t = 0; t < n; ++t) {
        run += cw[t * L + e];
        cw[t * L + e] = run;
      }
      tail[e] = expf(run);
    }
    __syncthreads();
    // A: the diagonal carries the bonus u, below it each term its own decay
    for (int i = tid; i < n * n; i += kThreads) {
      const int t = i / n, s = i % n;
      if (s > t) continue;
      const float* rt = rs + t * L;
      const float* kk = ks + s * L;
      float a = 0.0f;
      if (s == t) {
#pragma unroll 8
        for (int e = 0; e < HD; ++e) a = fmaf(rt[e] * us[e], kk[e], a);
      } else {
        const float* ct = cw + (t - 1) * L;
        const float* cs = cw + s * L;
#pragma unroll 8
        for (int e = 0; e < HD; ++e) a = fmaf(rt[e] * kk[e], expf(ct[e] - cs[e]), a);
      }
      as[t * AL + s] = a;
    }
    __syncthreads();
    // r o exp(cw[t-1]) for the carried-in state, k o exp(cw[n-1] - cw) for the new one
    for (int i = tid; i < n * HD; i += kThreads) {
      const int t = i / HD, e = i % HD;
      if (t > 0) rs[t * L + e] *= expf(cw[(t - 1) * L + e]);
      ks[t * L + e] *= expf(cw[(n - 1) * L + e] - cw[t * L + e]);
    }
    __syncthreads();
    for (int i = tid; i < n * HD; i += kThreads) {
      const int t = i / HD, e = i % HD;
      const float* at = as + t * AL;
      const float* rt = rs + t * L;
      float acc = 0.0f;
      for (int s = 0; s <= t; ++s) acc = fmaf(at[s], vs[s * L + e], acc);
#pragma unroll 8
      for (int j = 0; j < HD; ++j) acc = fmaf(rt[j], st[j * HD + e], acc);
      y[((static_cast<long long>(b) * T + c0 + t) * H + h) * HD + e] = acc;
    }
    __syncthreads();  // y has read the state this chunk started from
    for (int i = tid; i < HD * HD; i += kThreads) {
      const int j = i / HD, e = i % HD;
      float acc = tail[j] * st[i];
      for (int s = 0; s < n; ++s) acc = fmaf(ks[s * L + j], vs[s * L + e], acc);
      st[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < HD * HD; i += kThreads) s_out[sbase + i] = st[i];
}

template <int HD>
int launch(const float* r, const long long* rs, const float* k, const long long* ks,
           const float* v, const long long* vs, const float* lw, const long long* ws,
           const float* u, const float* s0, float* y, float* s_out, int b, int t, int h,
           cudaStream_t stream) {
  auto kern = wkv6_kernel<HD>;
  const size_t smem = Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<b * h, kThreads, smem, stream>>>(r, rs[0], rs[1], rs[2], k, ks[0], ks[1], ks[2], v, vs[0],
                                          vs[1], vs[2], lw, ws[0], ws[1], ws[2], u, s0, y, s_out,
                                          t, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// r, k, v, lw (B, T, H, hd) f32, each with element strides {batch, token,
// head} and unit stride along hd; u (H, hd) f32 contiguous; s0 (B, H, hd,
// hd) f32 contiguous, or null for a zero state; y (B, T, H, hd) and s_out
// (B, H, hd, hd) f32 contiguous. s_out may be s0. hd 16, 32 or 64. Returns
// a CUDA error code (cudaErrorInvalidValue for an hd not built).
int wkv6_forward(const float* r, const long long* r_strides, const float* k,
                 const long long* k_strides, const float* v, const long long* v_strides,
                 const float* lw, const long long* lw_strides, const float* u, const float* s0,
                 float* y, float* s_out, int b, int t, int h, int hd, void* stream) {
  if (b == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WKV_ARGS r, r_strides, k, k_strides, v, v_strides, lw, lw_strides, u, s0, y, s_out, b, t, h, st
  if (hd == 16) return launch<16>(WKV_ARGS);
  if (hd == 32) return launch<32>(WKV_ARGS);
  if (hd == 64) return launch<64>(WKV_ARGS);
#undef WKV_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
