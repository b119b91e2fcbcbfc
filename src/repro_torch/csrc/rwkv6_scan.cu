// Chunk-parallel WKV6 recurrence (RWKV-6 "Finch" time-mix) for Hopper
// (sm_90a).
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
//   y_t  = (r_t * exp(sum_{j<t} lw_j)) S_{c-1}                     (inter)
//        + sum_{s<t} [sum_k r_tk k_sk exp(sum_{s<j<t} lw_jk)] v_s  (intra)
//        + (sum_k r_tk u_k k_tk) v_t                               (bonus)
//   S_c  = diag(exp(total_c)) S_{c-1} + L_c,   total_c = sum_j lw_j,
//   L_c  = sum_s (k_s * exp(sum_{j>s} lw_j))^T v_s.
// The pairwise sums run along t for a fixed s (d[t+1,s] = d[t,s] + lw_t):
// still direct sums of same-signed terms, in O(Q^2 K) adds a chunk.  Every
// exponent is <= 0: a chunk can underflow to 0, never overflow.  Steps past
// S in the last chunk are loaded as r = k = v = 0, w = 1, so they leave the
// state untouched; their y is not written.
//
// What bounds it on this card: the recurrence's operations, narrowly.  A
// call reads r, k, v, w once and writes y and the state once: on the RWKV-6
// prefill (r, k, v bfloat16, w float32; B 1, S 699, H 32) 20.6 MB, 6.1 us
// at 3.35 TB/s; the recurrence needs 5 K^2 float32 flops a step and head
// (0.46 GFLOP there, 6.8 us at the float32 peak).  The chunked form below
// does about twice those flops, plus the scratch traffic.
//
// Design: the state enters the next chunk linearly with a diagonal decay,
// so every chunk's local work runs in parallel and only the scalar
// recurrence S_c = exp(total_c) S_{c-1} + L_c per state element is serial.
// rwkv6_scan_launch runs three kernels back to back on the caller's stream:
//   (1) wkv6_local_kernel, one block of 256 threads per (b, h, chunk):
//       L_c and total_c into the scratch.  1,408 blocks at the RWKV-6
//       prefill (B 1, H 32, 44 chunks).
//   (2) wkv6_state_kernel, one thread per (b, h, key, value): walks the
//       chunks with S <- exp(total_c) S + L_c, overwrites L_c with the
//       state that enters chunk c, and writes the final state.  131,072
//       threads, 44 steps each; the next chunks' loads are issued ahead.
//   (3) wkv6_output_kernel, one block of 256 threads per (b, h, chunk):
//       the intra-chunk scores (each thread one s and 4 of the 64 keys,
//       reduced over 16 lanes), then y = scores v + (r exp(prefix)) S_{c-1}.
//       1,408 blocks.
// Each block loads its chunk 16 bytes a thread, every input's loads in
// flight before any is stored (the wrapper puts r, k, v and w on 16-byte
// boundaries).  Scratch (allocated by the caller): B H n_chunks (K^2 + K)
// float32, 23.4 MB at the RWKV-6 prefill, written by (1), read and
// rewritten by (2), read by (3): ~92 MB of traffic.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, RWKV-6 prefill
// shape): 0.067 ms of device time a call, 14x faster than PR 15's design
// and ~10x the bound: (1) 0.014 ms; (2) 0.019 ms, its 47 MB of scratch
// traffic at 2.5 TB/s; (3) 0.034 ms, which loads four inputs and a 16 KB
// state a block, takes ~7,700 expf for the scores and runs the K-deep
// inter-chunk product at four outputs a thread.  PR 15's design, one
// block per (b, h) walking the 44 chunks in order, ran 32 blocks on 132
// SMs and spent ~21 us a chunk on a serial chain of unprefetched loads,
// four barriers and an O(Q^3 K) score loop of logf / expf; its arithmetic
// alone was ~1 us a chunk.  All arithmetic is float32 on CUDA cores (no
// TF32, which would miss the 3e-4 tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 64;            // head size (key width = value width)
constexpr int Q = 16;            // chunk length
constexpr int KK = K * K;
constexpr int kThreads = 256;
constexpr int kStateThreads = 128;
constexpr int kAhead = 8;        // chunks the state pass loads ahead

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float log_decay(float w) {
  return fmaxf(logf(fmaxf(w, 1e-38f)), -60.f);
}

// The block's chunk: blockIdx.x = (b * H + h) * n_chunks + chunk.
struct Chunk {
  int c0;                 // first step
  long long base;         // offset of (b, step 0, h, key 0) in r, k, v, w, y
  long long step;         // elements from one step to the next
};

__device__ __forceinline__ Chunk chunk_of(int S, int H, int n_chunks) {
  const int blk = blockIdx.x;
  const int c = blk % n_chunks, bh = blk / n_chunks;
  const int b = bh / H, h = bh % H;
  Chunk ch;
  ch.c0 = c * Q;
  ch.step = static_cast<long long>(H) * K;
  ch.base = static_cast<long long>(b) * S * ch.step
      + static_cast<long long>(h) * K;
  return ch;
}

// Widen a 16-byte vector: 4 float32 or 8 bfloat16 values.
__device__ __forceinline__ void widen(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const uint4& raw, float (&v)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // little-endian: low half first
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// This thread's 16-byte vector of a chunk's [Q][K] rows of one input (a
// row is 8 vectors of bfloat16 or 16 of float32): load() issues the load,
// store() widens it into shared memory, steps past S as `fill`.  Every
// input is loaded before any is stored, so all loads are in flight at
// once; 16-byte loads move the chunk in 8x (bfloat16) fewer requests than
// loads of one value a thread.
template <typename T>
struct Rows {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kPerRow = K / kVec;
  static_assert(Q * kPerRow <= kThreads, "one vector a thread at most");
  uint4 raw;
  int t, c0;
  bool in;

  __device__ __forceinline__ void load(const T* __restrict__ src,
                                       const Chunk& ch, int S) {
    const int i = threadIdx.x;
    t = i / kPerRow;
    c0 = (i % kPerRow) * kVec;
    in = i < Q * kPerRow && ch.c0 + t < S;
    raw = in ? *reinterpret_cast<const uint4*>(
                   src + ch.base + (ch.c0 + t) * ch.step + c0)
             : make_uint4(0u, 0u, 0u, 0u);
  }
  template <typename Op>
  __device__ __forceinline__ void store(float (*dst)[K], float fill,
                                        Op op) const {
    if (threadIdx.x >= Q * kPerRow) return;
    float v[kVec];
    widen(raw, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[t][c0 + e] = op(in ? v[e] : fill);
  }
};

struct Same {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};
struct LogDecay {
  __device__ __forceinline__ float operator()(float x) const {
    return log_decay(x);
  }
};

// (1) L_c = sum_s (k_s exp(sum_{j>s} lw_j))^T v_s and total_c = sum_j lw_j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_local_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, float* __restrict__ l_state,
                  float* __restrict__ l_total, int S, int H, int n_chunks) {
  __shared__ __align__(16) float vs[Q][K];
  __shared__ float ks[Q][K], lw[Q][K], kdec[Q][K];
  const int tid = threadIdx.x;
  const Chunk ch = chunk_of(S, H, n_chunks);

  {
    Rows<T> kr, vr;
    Rows<float> wr;
    kr.load(k, ch, S);
    vr.load(v, ch, S);
    wr.load(w, ch, S);
    kr.store(ks, 0.f, Same());
    vr.store(vs, 0.f, Same());
    wr.store(lw, 1.f, LogDecay());
  }
  __syncthreads();
  if (tid < K) {                   // suffix sums, direct, from the end
    float suf = 0.f;
#pragma unroll
    for (int s = Q - 1; s >= 0; --s) {
      kdec[s][tid] = ks[s][tid] * expf(suf);
      suf += lw[s][tid];
    }
    l_total[static_cast<long long>(blockIdx.x) * K + tid] = suf;
  }
  __syncthreads();

  // L[key][value]: each thread 4 keys x 4 values.
  const int k0 = (tid / 16) * 4, v0 = (tid % 16) * 4;
  float acc[4][4] = {};
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const float4 vv = *reinterpret_cast<const float4*>(&vs[s][v0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float kd = kdec[s][k0 + i];
      acc[i][0] += kd * vv.x;
      acc[i][1] += kd * vv.y;
      acc[i][2] += kd * vv.z;
      acc[i][3] += kd * vv.w;
    }
  }
  float* out = l_state + static_cast<long long>(blockIdx.x) * KK;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&out[(k0 + i) * K + v0]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// (2) S <- exp(total_c) S + L_c along the chunks, one thread per state
// element; L_c is overwritten with the state that enters chunk c.
__global__ void __launch_bounds__(kStateThreads)
wkv6_state_kernel(float* __restrict__ l_state,
                  const float* __restrict__ l_total,
                  float* __restrict__ s_out, long long n, int n_chunks) {
  const long long i = static_cast<long long>(blockIdx.x) * kStateThreads
      + threadIdx.x;
  if (i >= n) return;
  const long long bh = i / KK;
  const int e = static_cast<int>(i % KK), key = e / K;
  float* l = l_state + bh * n_chunks * KK + e;
  const float* tot = l_total + bh * n_chunks * K + key;
  float st = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += kAhead) {
    float lc[kAhead], dec[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (c0 + j < n_chunks) {
        lc[j] = l[static_cast<long long>(c0 + j) * KK];
        dec[j] = tot[static_cast<long long>(c0 + j) * K];
      }
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (c0 + j < n_chunks) {
        l[static_cast<long long>(c0 + j) * KK] = st;
        st = expf(dec[j]) * st + lc[j];
      }
  }
  s_out[i] = st;
}

// (3) y of one chunk: intra-chunk scores and bonus, plus the inter-chunk
// term from the state that enters the chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_output_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const T* __restrict__ u,
                   const float* __restrict__ s_enter, float* __restrict__ y,
                   int S, int H, int n_chunks) {
  __shared__ __align__(16) float vs[Q][K];
  __shared__ __align__(16) float st[K][K];    // state entering the chunk
  __shared__ float rs[Q][K], ks[Q][K], lw[Q][K];
  __shared__ float rdec[Q][K + 4];            // r exp(prefix); padded rows
  __shared__ float att[Q][Q + 1];             // scores, diagonal = bonus
  const int tid = threadIdx.x;
  const Chunk ch = chunk_of(S, H, n_chunks);
  const bool first = blockIdx.x % n_chunks == 0;   // enters with S = 0
  const int sl = tid % 16;         // the scores' keys: sl + 16 j
  float uv[4];                     // u at those keys
  {
    const T* uh = u + ((blockIdx.x / n_chunks) % H) * K;
#pragma unroll
    for (int j = 0; j < 4; ++j) uv[j] = to_f32(uh[sl + 16 * j]);
  }
  {
    constexpr int kSt = KK / 4 / kThreads;   // float4s of the state a thread
    const float4* src = reinterpret_cast<const float4*>(
        s_enter + static_cast<long long>(blockIdx.x) * KK);
    float4 sv[kSt];
    if (!first) {
#pragma unroll
      for (int j = 0; j < kSt; ++j) sv[j] = src[tid + j * kThreads];
    }
    Rows<T> rr, kr, vr;
    Rows<float> wr;
    rr.load(r, ch, S);
    kr.load(k, ch, S);
    vr.load(v, ch, S);
    wr.load(w, ch, S);
    rr.store(rs, 0.f, Same());
    kr.store(ks, 0.f, Same());
    vr.store(vs, 0.f, Same());
    wr.store(lw, 1.f, LogDecay());
    if (!first) {
#pragma unroll
      for (int j = 0; j < kSt; ++j)
        reinterpret_cast<float4*>(&st[0][0])[tid + j * kThreads] = sv[j];
    }
  }
  __syncthreads();

  if (tid < K) {                   // prefix sums, direct, from the start
    float pre = 0.f;
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      rdec[t][tid] = rs[t][tid] * expf(pre);
      pre += lw[t][tid];
    }
  }
  {
    // Scores att[t][s] = sum_key r_t k_s exp(sum_{s<j<t} lw_j) for s < t,
    // att[s][s] = sum_key r_s u k_s: thread (s, slice) takes keys
    // slice + 16 j and walks t, carrying the pairwise sums.
    const int s = tid / 16;
    float kv[4], d[4];
    float diag = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = sl + 16 * j;
      kv[j] = ks[s][key];
      d[j] = 0.f;
      diag += rs[s][key] * (uv[j] * kv[j]);
    }
    float acc[Q];
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      float a = 0.f;
      if (t > s) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = sl + 16 * j;
          a += rs[t][key] * kv[j] * expf(d[j]);
          d[j] += lw[t][key];
        }
      }
      acc[t] = t == s ? diag : a;
    }
#pragma unroll
    for (int t = 0; t < Q; ++t)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
    if (sl == 0) {
#pragma unroll
      for (int t = 0; t < Q; ++t) att[t][s] = acc[t];
    }
  }
  __syncthreads();

  // y[t][v0 .. v0 + 3].
  const int t = tid / 16, v0 = (tid % 16) * 4, pos = ch.c0 + t;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s <= t; ++s) {
    const float a = att[t][s];
    const float4 vv = *reinterpret_cast<const float4*>(&vs[s][v0]);
    acc.x += a * vv.x;
    acc.y += a * vv.y;
    acc.z += a * vv.z;
    acc.w += a * vv.w;
  }
  if (!first) {
#pragma unroll 8
    for (int key = 0; key < K; ++key) {
      const float rd = rdec[t][key];
      const float4 sv = *reinterpret_cast<const float4*>(&st[key][v0]);
      acc.x += rd * sv.x;
      acc.y += rd * sv.y;
      acc.z += rd * sv.z;
      acc.w += rd * sv.w;
    }
  }
  if (pos < S)
    *reinterpret_cast<float4*>(&y[ch.base + pos * ch.step + v0]) = acc;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const void* u, float* y, float* s_out, float* scratch, int B,
           int S, int H, int n_chunks, cudaStream_t stream) {
  const int blocks = B * H * n_chunks;
  // The scratch: [B,H,n_chunks,K,K] local states, [B,H,n_chunks,K] totals.
  float* l_state = scratch;
  float* l_total = scratch + static_cast<long long>(blocks) * KK;
  wkv6_local_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), w, l_state,
      l_total, S, H, n_chunks);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * H * KK;
  wkv6_state_kernel<<<static_cast<unsigned>((n + kStateThreads - 1)
                                            / kStateThreads),
                      kStateThreads, 0, stream>>>(l_state, l_total, s_out, n,
                                                  n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_output_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, static_cast<const T*>(u), l_state, y, S, H,
      n_chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the three passes on `stream`; allocates nothing and does not
// synchronize.  r, k, v and u are bfloat16 where `is_bf16` is nonzero, else
// float32; w, y, s_out and scratch are float32, all contiguous; r, k, v and
// w start on 16-byte boundaries (the kernels load 16 bytes a thread).
// `scratch` holds `scratch_floats` floats, at least
// B H ceil(S / 16) (64 * 64 + 64).  Returns the cudaError_t of the
// launches.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const float* w, const void* u, int is_bf16, float* y,
                      float* s_out, float* scratch, long long scratch_floats,
                      int B, int S, int H, int head_size, void* stream) {
  if (head_size != K || B < 0 || S < 0 || H < 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k)
       | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w))
      % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (B == 0 || H == 0 || S == 0) return cudaSuccess;
  const int n_chunks = (S + Q - 1) / Q;
  if (static_cast<long long>(B) * H * n_chunks > 0x7fffffffLL
      || scratch_floats
          < static_cast<long long>(B) * H * n_chunks * (KK + K))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, y, s_out, scratch, B, S, H,
                                 n_chunks, st);
  return launch<float>(r, k, v, w, u, y, s_out, scratch, B, S, H, n_chunks,
                       st);
}

const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
