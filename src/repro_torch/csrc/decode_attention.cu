// One-token (decode) attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel decode_attention_pallas / _kernel in
// src/repro/kernels/decode_attention/decode_attention.py.  For q [B,1,H,D],
// caches k, v [B,T,KV,D] (row-major, contiguous, float32 or bfloat16; H a
// multiple of KV; D in {64, 128, 256}) and cache_len [B] int32 it computes,
// for every batch row b and query head h, attending KV head h / (H / KV):
//
//   s_t = softcap(q . k_t * scale), masked to -1e30 where t >= cache_len[b]
//   out = sum_t round_v(p_t) v_t / max(sum_t p_t, 1e-30),  p_t = exp(s_t - m)
//
// with float32 m, l and acc, p rounded to v's dtype before the P.V product
// (the TPU kernel's p.astype(v.dtype)).  The engine relies on the per-row
// length mask for partly filled slots.
//
// What bounds it on this card: bytes.  A call reads each valid cache row of
// k and v once (2 * D * 2 bytes per slot and head in bfloat16) and does
// 4 * D flops per query head for it: a few flops per byte, far below the
// ridge point.
//
// Design (simple first; split-K over the cache comes later):
// - One block of 8 warps per (KV head, batch row, group of up to 8 query
//   heads), so the G query heads that share a KV head read its rows once.
//   At B = 4 and KV = 36 that is 144 blocks, about one per SM: the grid
//   underfills the card, and each block streams its whole cache alone.
// - Each warp walks its own keys (4 or 2 per step, all loads issued before
//   any use), each lane holding D/32 elements of the row in one vector load;
//   q . k is reduced across the warp with shuffles and every lane keeps the
//   warp's online-softmax state.  The warps' (m, l, acc) are merged in
//   shared memory at the end.
// - Only slots below cache_len are read: a masked slot adds exp(-1e30 - m)
//   = 0 once any valid slot is seen, so skipping them changes nothing.  A
//   row with cache_len <= 0 has no valid slot; it reads all T slots, each
//   masked, and gets their plain mean, as the unskipped softmax does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// E contiguous elements at p (aligned to their total size, or to 16 bytes
// when larger) into float registers.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[E]) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* tv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) f[c * kPer + i] = to_f(tv[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* tv = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = to_f(tv[i]);
  } else if constexpr (kBytes == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* tv = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = to_f(tv[i]);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = to_f(p[i]);
  }
}

template <int D, int MAXG>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kWarps) * MAXG * (2 + D);
}

template <typename T, int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ cache_len,
              T* __restrict__ out, int Tn, int H, int KV, float scale,
              float softcap) {
  constexpr int E = D / 32;                          // elements per lane
  constexpr int U = (MAXG * E >= 32) ? 2 : 4;        // keys per warp step
  extern __shared__ float smem[];
  float* wm = smem;                                  // [kWarps][MAXG]
  float* wl = wm + kWarps * MAXG;                    // [kWarps][MAXG]
  float* wacc = wl + kWarps * MAXG;                  // [kWarps][MAXG][D]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int g0 = blockIdx.z * MAXG;
  const int ng = min(MAXG, G - g0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  const T* qb = q + (static_cast<long long>(b) * H + kvh * G + g0) * D;
  float qr[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < ng) {
      load_vec<T, E>(qb + g * D + lane * E, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = 0.f;
    }
  }

  const int len = cache_len[b];
  const int n = len >= 1 ? min(len, Tn) : Tn;
  const long long row = static_cast<long long>(KV) * D;
  const T* kb = kc + (static_cast<long long>(b) * Tn * KV + kvh) * D + lane * E;
  const T* vb = vc + (static_cast<long long>(b) * Tn * KV + kvh) * D + lane * E;

  float m[MAXG], l[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = warp * U; t0 < n; t0 += kWarps * U) {
    float kf[U][E], vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < n) {
        load_vec<T, E>(kb + (t0 + u) * row, kf[u]);
        load_vec<T, E>(vb + (t0 + u) * row, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[U][MAXG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qr[g][e], kf[u][e], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        float x = part * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[u][g] = (t0 + u < len) ? x : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (t0 + u < n) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t0 + u < n) {
          const float p = expf(s[u][g] - mx);
          sum += p;
          const float pr = round_to<T>(p);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pr, vf[u][e], acc[g][e]);
        }
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (lane == 0) {
      wm[warp * MAXG + g] = m[g];
      wl[warp * MAXG + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      wacc[(warp * MAXG + g) * D + lane * E + e] = acc[g][e];
  }
  __syncthreads();

  T* ob = out + (static_cast<long long>(b) * H + kvh * G + g0) * D;
  for (int idx = threadIdx.x; idx < ng * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * MAXG + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * MAXG + g] - mx);
      lsum += wl[w * MAXG + g] * f;
      a += wacc[(w * MAXG + g) * D + d] * f;
    }
    ob[g * D + d] = from_f<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int MAXG>
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, int B, int Tn, int H, int KV, float scale, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D, MAXG>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, MAXG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const dim3 grid(static_cast<unsigned>(KV), static_cast<unsigned>(B),
                  static_cast<unsigned>((G + MAXG - 1) / MAXG));
  decode_kernel<T, D, MAXG><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(out), Tn, H, KV, scale,
      softcap);
  return cudaGetLastError();
}

template <typename T, int D>
int by_group(const void* q, const void* k, const void* v, const int* lens,
             void* out, int B, int Tn, int H, int KV, float scale,
             float softcap, cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1)
    return launch<T, D, 1>(q, k, v, lens, out, B, Tn, H, KV, scale, softcap,
                           stream);
  if (G <= 2)
    return launch<T, D, 2>(q, k, v, lens, out, B, Tn, H, KV, scale, softcap,
                           stream);
  if (G <= 4)
    return launch<T, D, 4>(q, k, v, lens, out, B, Tn, H, KV, scale, softcap,
                           stream);
  return launch<T, D, 8>(q, k, v, lens, out, B, Tn, H, KV, scale, softcap,
                         stream);
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const int* lens, void* out, int B, int Tn, int H, int KV,
             float scale, float softcap, cudaStream_t stream) {
  switch (D) {
    case 64:
      return by_group<T, 64>(q, k, v, lens, out, B, Tn, H, KV, scale,
                             softcap, stream);
    case 128:
      return by_group<T, 128>(q, k, v, lens, out, B, Tn, H, KV, scale,
                              softcap, stream);
    case 256:
      return by_group<T, 256>(q, k, v, lens, out, B, Tn, H, KV, scale,
                              softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing and does not synchronize.
// is_bf16 selects bfloat16 (1) or float32 (0) for q, the caches and out.
// Pointers must be 16-byte aligned.  Returns the cudaError_t of the launch.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* cache_len, void* out, int B, int Tn,
                            int H, int KV, int D, int is_bf16, float scale,
                            float softcap, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (Tn <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, cache_len, out, B, Tn, H, KV,
                                   scale, softcap, st);
  return dispatch<float>(D, q, k, v, cache_len, out, B, Tn, H, KV, scale,
                         softcap, st);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
