// Chunked Mamba2 SSD scan for Hopper (sm_90a), bound to PyTorch by ctypes.
//
// Replaces the Pallas TPU kernel ssd_chunked_kernel
// (src/repro/kernels/mamba2_scan/kernel.py:76, body _kernel :29-73). Per
// (batch b, head h), over the steps of a sequence, with a scalar decay
// dt_t * A_h <= 0 per step:
//
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T        S: (P, N)
//   y_t = S_t C_t + D x_t
//
// computed chunk by chunk in the TPU kernel's closed form. Within a chunk
// of n <= kC steps, with cw the inclusive cumulative sum of dt * A:
//
//   G[t,s] = exp(cw[t] - cw[s]) dt[s]                  (s <= t)
//   y      = ((C B^T) o G) x + exp(cw) o (C S_in^T) + D x
//   S_out  = exp(cw[n-1]) S_in + (x o (exp(cw[n-1] - cw) dt))^T B
//
// What bounds it: at zamba2-1.2b's prefill (one prompt of T = 512, 64
// heads, P = N = 64) operations. The call reads x and writes y (17 MB in
// f32), reads dt, B and C (0.4 MB) and writes the 1 MB state: some 5 us at
// 3.35 TB/s, against some 0.8 GFLOP of f32 work in this closed form, most
// of it the carried state's products (12 us at 67 TFLOP/s). At decode (8
// slots, T = 1) bytes: it reads and writes the 8 MB state, 5 us.
//
// What the design does:
//   * one block per (b, h). The TPU grid's sequential chunk axis becomes a
//     loop over chunks inside the block, with the (P, N) f32 state in shared
//     memory (16 KB at P = N = 64) for the whole sequence;
//   * every exponent is a difference of one running sum of non-positive
//     terms, or that sum itself, so it is <= 0 in floating point too and
//     nothing overflows however strong the decay;
//   * x, dt, B and C are read in model layout (x (B, T, H, P), dt (B, T, H),
//     B and C (B, T, N) shared by the heads) through their strides: no
//     transpose and no padding of T. The ragged last chunk is masked by
//     running its loops to n, so a decode step (T = 1) does one step's work.
//     Like the TPU kernel it forms the Gram matrix C B^T in every head;
//   * the state and the B and C tiles are padded to N + 1 floats a row, so
//     a warp that walks p or s hits distinct banks;
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

constexpr int kC = 32;         // steps per chunk
constexpr int kThreads = 256;

template <int P, int N>
struct Smem {
  static constexpr int kXLd = P + 1;
  static constexpr int kNLd = N + 1;
  static constexpr int kMLd = kC + 1;
  static constexpr size_t kBytes =
      sizeof(float) * (kC * kXLd + 2 * kC * kNLd + kC * kMLd + P * kNLd + 5 * kC);
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, long long x_sb, long long x_st, long long x_sh,
           const float* __restrict__ dt, long long d_sb, long long d_st, long long d_sh,
           const float* __restrict__ bm, long long b_sb, long long b_st,
           const float* __restrict__ cm, long long c_sb, long long c_st,
           const float* __restrict__ a_log_decay, const float* __restrict__ dskip,
           const float* s0, float* __restrict__ y, float* s_out, int T, int H) {
  constexpr int XL = Smem<P, N>::kXLd;
  constexpr int NL = Smem<P, N>::kNLd;
  constexpr int ML = Smem<P, N>::kMLd;
  extern __shared__ float smem[];
  float* xs = smem;            // x (n x P)
  float* bs = xs + kC * XL;    // B (n x N)
  float* cs = bs + kC * NL;    // C (n x N)
  float* ms = cs + kC * NL;    // (C B^T) o G (n x n, lower triangle)
  float* st = ms + kC * ML;    // state (P x N)
  float* dts = st + P * NL;    // dt
  float* cw = dts + kC;        // inclusive cumulative sum of dt * A
  float* ecw = cw + kC;        // exp(cw)
  float* wt = ecw + kC;        // exp(cw[n-1] - cw) dt
  float* misc = wt + kC;       // [0] = exp(cw[n-1])

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const float a = a_log_decay[h], d = dskip[h];
  const long long sbase = static_cast<long long>(blockIdx.x) * P * N;

  for (int i = tid; i < P * N; i += kThreads) st[(i / N) * NL + i % N] = s0 ? s0[sbase + i] : 0.0f;

  for (int c0 = 0; c0 < T; c0 += kC) {
    const int n = min(kC, T - c0);
    __syncthreads();  // the previous chunk's readers are done (and the state is staged)
    for (int i = tid; i < n * P; i += kThreads) {
      const int t = i / P, p = i % P;
      xs[t * XL + p] = x[b * x_sb + (c0 + t) * x_st + h * x_sh + p];
    }
    for (int i = tid; i < n * N; i += kThreads) {
      const int t = i / N, e = i % N;
      bs[t * NL + e] = bm[b * b_sb + (c0 + t) * b_st + e];
      cs[t * NL + e] = cm[b * c_sb + (c0 + t) * c_st + e];
    }
    for (int t = tid; t < n; t += kThreads) dts[t] = dt[b * d_sb + (c0 + t) * d_st + h * d_sh];
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int t = 0; t < n; ++t) {
        run += dts[t] * a;
        cw[t] = run;
      }
      misc[0] = expf(run);
    }
    __syncthreads();
    for (int t = tid; t < n; t += kThreads) {
      ecw[t] = expf(cw[t]);
      wt[t] = expf(cw[n - 1] - cw[t]) * dts[t];
    }
    for (int i = tid; i < n * n; i += kThreads) {
      const int t = i / n, s = i % n;
      if (s > t) continue;
      const float* ct = cs + t * NL;
      const float* bsr = bs + s * NL;
      float gram = 0.0f;
#pragma unroll 8
      for (int e = 0; e < N; ++e) gram = fmaf(ct[e], bsr[e], gram);
      ms[t * ML + s] = gram * (expf(cw[t] - cw[s]) * dts[s]);
    }
    __syncthreads();
    for (int i = tid; i < n * P; i += kThreads) {
      const int t = i / P, p = i % P;
      const float* mt = ms + t * ML;
      const float* ct = cs + t * NL;
      const float* sp = st + p * NL;
      float intra = 0.0f, carry = 0.0f;
      for (int s = 0; s <= t; ++s) intra = fmaf(mt[s], xs[s * XL + p], intra);
#pragma unroll 8
      for (int e = 0; e < N; ++e) carry = fmaf(ct[e], sp[e], carry);
      const float xv = xs[t * XL + p];
      y[((static_cast<long long>(b) * T + c0 + t) * H + h) * P + p] =
          intra + ecw[t] * carry + d * xv;
    }
    __syncthreads();  // y has read the state this chunk started from
    const float decay = misc[0];
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, e = i % N;
      float acc = 0.0f;
      for (int s = 0; s < n; ++s) acc = fmaf(xs[s * XL + p] * wt[s], bs[s * NL + e], acc);
      st[p * NL + e] = decay * st[p * NL + e] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) s_out[sbase + i] = st[(i / N) * NL + i % N];
}

template <int P, int N>
int launch(const float* x, const long long* xs, const float* dt, const long long* ds,
           const float* bm, const long long* bs, const float* cm, const long long* cs,
           const float* a, const float* d, const float* s0, float* y, float* s_out, int b, int t,
           int h, cudaStream_t stream) {
  auto kern = ssd_kernel<P, N>;
  const size_t smem = Smem<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<b * h, kThreads, smem, stream>>>(x, xs[0], xs[1], xs[2], dt, ds[0], ds[1], ds[2], bm,
                                          bs[0], bs[1], cm, cs[0], cs[1], a, d, s0, y, s_out, t, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, T, H, P) with element strides {batch, step, head}; dt (B, T, H)
// with strides {batch, step, head}; B and C (B, T, N) with strides {batch,
// step}; unit stride along P and N; A and D (H,) f32 contiguous; s0 (B, H,
// P, N) f32 contiguous, or null for a zero state; y (B, T, H, P) and s_out
// (B, H, P, N) f32 contiguous. s_out may be s0. P and N each 16, 32 or
// 64. Returns a CUDA error code (cudaErrorInvalidValue for a size not
// built).
int ssd_forward(const float* x, const long long* x_strides, const float* dt,
                const long long* dt_strides, const float* bm, const long long* b_strides,
                const float* cm, const long long* c_strides, const float* a, const float* d,
                const float* s0, float* y, float* s_out, int b, int t, int h, int p, int n,
                void* stream) {
  if (b == 0 || h == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_ARGS x, x_strides, dt, dt_strides, bm, b_strides, cm, c_strides, a, d, s0, y, s_out, \
                 b, t, h, st
#define SSD_N(P)                                          \
  if (n == 16) return launch<P, 16>(SSD_ARGS);            \
  if (n == 32) return launch<P, 32>(SSD_ARGS);            \
  if (n == 64) return launch<P, 64>(SSD_ARGS);
  if (p == 16) { SSD_N(16) }
  if (p == 32) { SSD_N(32) }
  if (p == 64) { SSD_N(64) }
#undef SSD_N
#undef SSD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
