// Chunked WKV6 recurrence (RWKV-6 "Finch" time-mix) for Hopper (sm_90a).
//
// Replaces the TPU kernel rwkv6_scan_pallas / _kernel in
// src/repro/kernels/rwkv6_scan/rwkv6_scan.py.  For r, k, v, w [B,S,H,K]
// (row-major, contiguous, K = 64) and the bonus u [H,K] (r, k, v and u of
// one type, float32 or bfloat16, widened to float32 in registers as the TPU
// kernel casts in its body; w float32, as the model computes it) it computes,
// per batch row b and head h, with the state S in R^{K x K} (key x value)
// starting from zero:
//
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// and writes y [B,S,H,K] and the final state S_S [B,H,K,K], both float32.
// The TPU kernel keeps the state in VMEM scratch and drops it; the model's
// prefill needs it for the decode cache, so this kernel writes it out.
//
// Chunk math (chunks of Q = 16 steps, as the TPU kernel): with
// lw_j = max(log(max(w_j, 1e-38)), -60), every decay exponent is a direct
// sum of lw over its span, never a difference of two running cumsums
// (which cancels catastrophically under strong decay):
//   y_t  = (r_t * exp(sum_{j<t} lw_j)) S                        (inter)
//        + sum_{s<t} [sum_k r_tk k_sk exp(sum_{s<j<t} lw_jk)] v_s  (intra)
//        + (sum_k r_tk u_k k_tk) v_t                            (bonus)
//   S'   = diag(exp(sum_j lw_j)) S + sum_s (k_s * exp(sum_{j>s} lw_j))^T v_s
// Every exponent is <= 0: the chunk can underflow to 0, never overflow.
// Steps past S in the last chunk are loaded as r = k = v = 0, w = 1, so they
// leave the state untouched; their y is not written.
//
// What bounds it on this card: bytes, narrowly.  A call reads r, k, v, w
// once and writes y and the state once: on the RWKV-6 prefill (r, k, v
// bfloat16, w float32; B 1, S 699, H 32) 20.6 MB, 6.1 us at 3.35 TB/s; the
// recurrence needs 5 K^2 float32 flops a step and head (0.46 GFLOP there,
// 6.8 us at the float32 peak).  The chunked form below does about twice
// those flops.
//
// Design (simple first): one block of 256 threads per (b, h), the state in
// shared memory, a loop over chunks inside the block (the TPU's sequential
// chunk axis).  The grid is B*H blocks: 32 at B 1 for RWKV-6 1.6B, a quarter
// of the 132 SMs, so the card is underfilled; splitting the value axis
// across blocks is later work.  All arithmetic is float32 on CUDA cores (no
// TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 64;            // head size (key width = value width)
constexpr int Q = 16;            // chunk length
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// T: the type of r, k, v and u.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const T* __restrict__ u, float* __restrict__ y,
            float* __restrict__ s_out, int S, int H) {
  __shared__ float st[K][K];                 // state [key][value]
  __shared__ float rs[Q][K], ks[Q][K], vs[Q][K], lw[Q][K];
  __shared__ float rdec[Q][K], kdec[Q][K];   // r, k times their decays
  __shared__ float att[Q][Q];                // intra-chunk scores (s < t)
  __shared__ float diag[Q];                  // bonus scores (s = t)
  __shared__ float total[K];                 // chunk's summed log-decay
  __shared__ float us[K];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long step = static_cast<long long>(H) * K;   // one time step
  const long long base = static_cast<long long>(b) * S * step
      + static_cast<long long>(h) * K;
  const long long sbase = static_cast<long long>(bh) * K * K;

  for (int i = tid; i < K * K; i += kThreads)
    st[i / K][i % K] = 0.f;
  if (tid < K) us[tid] = to_f32(u[h * K + tid]);

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();        // the previous chunk is done with every buffer
    for (int i = tid; i < Q * K; i += kThreads) {
      const int t = i / K, c = i % K, pos = c0 + t;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 1.f;
      if (pos < S) {
        const long long off = base + pos * step + c;
        rv = to_f32(r[off]);
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
        wv = w[off];
      }
      rs[t][c] = rv;
      ks[t][c] = kv;
      vs[t][c] = vv;
      lw[t][c] = fmaxf(logf(fmaxf(wv, 1e-38f)), -60.f);
    }
    __syncthreads();

    // Banded sums per (step, key): before t, after t, and the whole chunk.
    for (int i = tid; i < Q * K; i += kThreads) {
      const int t = i / K, c = i % K;
      float pre = 0.f, suf = 0.f;
      for (int j = 0; j < t; ++j) pre += lw[j][c];
      for (int j = t + 1; j < Q; ++j) suf += lw[j][c];
      rdec[t][c] = rs[t][c] * expf(pre);
      kdec[t][c] = ks[t][c] * expf(suf);
      if (t == 0) total[c] = suf + lw[0][c];
    }
    // Scores: one warp per (t, s <= t), two keys per lane.
    for (int pi = warp; pi < Q * Q; pi += kWarps) {
      const int t = pi / Q, s = pi % Q;
      if (s > t) continue;                   // uniform across the warp
      float acc = 0.f;
      for (int c = lane; c < K; c += 32) {
        if (s == t) {
          acc += rs[t][c] * (us[c] * ks[t][c]);
        } else {
          float d = 0.f;
          for (int j = s + 1; j < t; ++j) d += lw[j][c];
          acc += rs[t][c] * ks[s][c] * expf(d);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        if (s == t) diag[t] = acc;
        else att[t][s] = acc;
      }
    }
    __syncthreads();

    // y[t][v]: inter-chunk (old state) + intra-chunk + bonus.
    for (int i = tid; i < Q * K; i += kThreads) {
      const int t = i / K, c = i % K, pos = c0 + t;
      if (pos >= S) continue;
      float inter = 0.f;
#pragma unroll 8
      for (int j = 0; j < K; ++j) inter += rdec[t][j] * st[j][c];
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra += att[t][s] * vs[s][c];
      intra += diag[t] * vs[t][c];
      y[base + pos * step + c] = inter + intra;
    }
    __syncthreads();

    // S' = diag(exp(total)) S + kdec^T v.
    for (int i = tid; i < K * K; i += kThreads) {
      const int kk = i / K, c = i % K;
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < Q; ++s) acc += kdec[s][kk] * vs[s][c];
      st[kk][c] = st[kk][c] * expf(total[kk]) + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * K; i += kThreads)
    s_out[sbase + i] = st[i / K][i % K];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const void* u, float* y, float* s_out, int B, int S, int H,
           cudaStream_t stream) {
  wkv6_kernel<T><<<B * H, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, static_cast<const T*>(u), y, s_out, S, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing and does not synchronize.
// r, k, v and u are bfloat16 where `is_bf16` is nonzero, else float32;
// w, y and s_out are float32.  Returns the cudaError_t of the launch.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const float* w, const void* u, int is_bf16, float* y,
                      float* s_out, int B, int S, int H, int head_size,
                      void* stream) {
  if (head_size != K || B < 0 || S < 0 || H < 0) return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, y, s_out, B, S, H, st);
  return launch<float>(r, k, v, w, u, y, s_out, B, S, H, st);
}

const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
