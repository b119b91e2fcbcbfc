// Chunked Mamba-2 SSD scan (Hymba's SSM heads) for Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_scan_pallas / _kernel in
// src/repro/kernels/ssd_scan/ssd_scan.py.  For x [B,S,H,P], dt [B,S,H],
// a [H], bmat and cmat [B,S,N] (P <= 64, N <= 16; x, dt, bmat and cmat of
// one type, float32 or bfloat16, widened to float32 in registers as the TPU
// kernel casts in its body; a float32, as the model computes it) it computes,
// per batch row b and head h, with the state h in R^{P x N} starting from
// zero:
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T
//   y_t = h_t C_t
//
// and writes y [B,S,H,P] and the final state h_S [B,H,P,N], both float32.
// The TPU kernel keeps the state in VMEM scratch and drops it; the model's
// prefill needs it for the decode cache, so this kernel writes it out.
//
// Layout: dt and a are contiguous.  x, bmat and cmat may be views into a
// wider per-token row (the model splits them out of one projection): each
// is contiguous within a token ([H,P] or [N]) and steps a row stride of
// its own from one token to the next, batch rows included.
//
// Chunk math (chunks of Q = 128 steps, as the TPU kernel), with
// c_t = sum_{j<=t} dt_j a (inclusive, within the chunk; dt a <= 0):
//   y_t = sum_{s<=t} (C_t . B_s) exp(min(c_t - c_s, 0)) dt_s x_s
//       + exp(c_t) h C_t
//   h'  = exp(c_last) h + sum_s exp(min(c_last - c_s, 0)) dt_s x_s B_s^T
// Every exponent is clamped at 0 before exp, as the TPU kernel clamps its
// masked ones: nothing can overflow.  B and C are read straight from their
// [B,S,N] rows, shared by the heads of a batch row; the per-head broadcast
// of the TPU wrapper is never materialized.  Steps past S in the last
// chunk are loaded as x = dt = B = C = 0: their decay is exp(0) and their
// update 0, so the state is untouched; their y is not written.
//
// What bounds it on this card: bytes.  A call reads x, dt, a, B and C once
// and writes y and the state once; y (float32) and x dominate: on the
// Hymba prefill (x, dt, B, C bfloat16; B 1, S 1300, H 50, P 64) 25.4 MB,
// 7.6 us at 3.35 TB/s.  The recurrence needs 5 P N float32 flops a step
// and head (0.33 GFLOP there, 5 us at the float32 peak); the chunked form
// below does about twice that.
//
// Design (simple first): one block of 256 threads per (b, h), the state in
// shared memory, a loop over chunks inside the block (the TPU's sequential
// chunk axis).  Within a chunk each thread owns one step t and 32 of the P
// channels of y_t: it keeps C_t in registers and walks s = 0..t, so the
// [Q,Q] decay and score matrices never exist in memory.  The grid is B*H
// blocks (50 at B 1 for Hymba-1.5B) on 132 SMs: underfilled; splitting P
// or the chunks' intra part across blocks is later work.  Float32 on CUDA
// cores throughout (no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 128;           // chunk length
constexpr int kMaxP = 64;        // head width (channels)
constexpr int kMaxN = 16;        // state size
constexpr int kThreads = 2 * Q;  // two threads (32 channels each) per step
constexpr int kPer = kMaxP / 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// T: the type of x, dt, bmat and cmat.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, long long x_row, long long b_row,
           long long c_row, float* __restrict__ y,
           float* __restrict__ h_out, int S, int H, int P, int N) {
  __shared__ float xs[Q][kMaxP];    // x of the chunk, zero past P
  __shared__ float bs[Q][kMaxN];    // B of the chunk, zero past N
  __shared__ float st[kMaxP][kMaxN];
  __shared__ float dts[Q], csum[Q], rem[Q];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const float ah = a[h];
  const long long row0 = static_cast<long long>(b) * S;  // b's first token
  const long long hbase = static_cast<long long>(bh) * P * N;

  for (int i = tid; i < kMaxP * kMaxN; i += kThreads)
    st[i / kMaxN][i % kMaxN] = 0.f;

  const int t = tid % Q;            // the step this thread's y row is for
  const int p0 = (tid / Q) * kPer;  // its first channel

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();        // the previous chunk is done with every buffer
    for (int i = tid; i < Q * kMaxP; i += kThreads) {
      const int s = i / kMaxP, p = i % kMaxP, pos = c0 + s;
      xs[s][p] = (pos < S && p < P)
          ? to_f32(x[(row0 + pos) * x_row + h * P + p]) : 0.f;
    }
    for (int i = tid; i < Q * kMaxN; i += kThreads) {
      const int s = i / kMaxN, n = i % kMaxN, pos = c0 + s;
      bs[s][n] = (pos < S && n < N)
          ? to_f32(bm[(row0 + pos) * b_row + n]) : 0.f;
    }
    if (tid < Q) {
      const int pos = c0 + tid;
      dts[tid] = pos < S ? to_f32(dt[(row0 + pos) * H + h]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                 // inclusive cumsum of dt * a, in order
      float c = 0.f;
      for (int s = 0; s < Q; ++s) {
        c += dts[s] * ah;
        csum[s] = c;
      }
    }
    __syncthreads();
    const float last = csum[Q - 1];
    if (tid < Q) rem[tid] = expf(fminf(last - csum[tid], 0.f)) * dts[tid];

    // y row t, channels p0 .. p0 + 31.
    const int pos = c0 + t;
    float cr[kMaxN];
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      cr[n] = (pos < S && n < N)
          ? to_f32(cm[(row0 + pos) * c_row + n]) : 0.f;
    float acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
    const float ct = csum[t];
    for (int s = 0; s <= t; ++s) {
      float sc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) sc += cr[n] * bs[s][n];
      const float wv = sc * expf(fminf(ct - csum[s], 0.f)) * dts[s];
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] += wv * xs[s][p0 + j];
    }
    if (pos < S) {
      const float e = expf(fminf(ct, 0.f));
      float* yrow = y + ((row0 + pos) * H + h) * P;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int p = p0 + j;
        if (p < P) {
          float inter = 0.f;
#pragma unroll
          for (int n = 0; n < kMaxN; ++n) inter += cr[n] * st[p][n];
          yrow[p] = acc[j] + e * inter;
        }
      }
    }
    __syncthreads();

    // h' = exp(c_last) h + sum_s x_s (B_s rem_s)^T.
    const float keep = expf(fminf(last, 0.f));
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i % N;
      float c = 0.f;
      for (int s = 0; s < Q; ++s) c += xs[s][p] * (bs[s][n] * rem[s]);
      st[p][n] = st[p][n] * keep + c;
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    h_out[hbase + i] = st[i / N][i % N];
}

template <typename T>
int launch(const void* x, const void* dt, const float* a, const void* bm,
           const void* cm, long long x_row, long long b_row, long long c_row,
           float* y, float* h_out, int B, int S, int H, int P, int N,
           cudaStream_t stream) {
  ssd_kernel<T><<<B * H, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), x_row, b_row,
      c_row, y, h_out, S, H, P, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing and does not synchronize.
// x, dt, bm and cm are bfloat16 where `is_bf16` is nonzero, else float32;
// x_row, b_row and c_row are the element strides from one token to the
// next of x, bm and cm; a, y and h_out are float32, y and h_out
// contiguous.  Returns the cudaError_t of the launch.
int ssd_scan_launch(const void* x, const void* dt, const float* a,
                    const void* bm, const void* cm, int is_bf16,
                    long long x_row, long long b_row, long long c_row,
                    float* y, float* h_out, int B, int S, int H, int P,
                    int N, void* stream) {
  if (B < 0 || S < 0 || H < 0 || P < 1 || P > kMaxP || N < 1 || N > kMaxN
      || x_row < static_cast<long long>(H) * P || b_row < N || c_row < N)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, x_row, b_row, c_row, y,
                                 h_out, B, S, H, P, N, st);
  return launch<float>(x, dt, a, bm, cm, x_row, b_row, c_row, y, h_out, B,
                       S, H, P, N, st);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
