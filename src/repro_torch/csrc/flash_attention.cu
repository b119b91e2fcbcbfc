// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas / _fa_kernel in
// src/repro/kernels/flash_attention/flash_attention.py.  For q [B,S,H,D] and
// k, v [B,T,KV,D] (row-major, contiguous, float32 or bfloat16; H a multiple
// of KV; D in {64, 128, 256}) it computes, for every query row i of head h,
// attending KV head h / (H / KV):
//
//   s_j = softcap(q_i . k_j * scale)     masked to -1e30 where
//         j >= T, or (causal) i - j < 0, or (causal, window > 0) i - j >= window
//   out_i = sum_j round_v(p_j) v_j / max(sum_j p_j, 1e-30),  p_j = exp(s_j - m)
//
// with the online softmax (running max m, running sum l, accumulator acc, all
// float32) taken over tiles of 64 keys, as the TPU kernel does.  round_v
// rounds p to v's dtype before the P.V product, as the TPU kernel does
// (p.astype(v.dtype)); the running sum l takes p unrounded.  The output is
// written in q's dtype.
//
// What bounds it on this card: operations.  Each (query row, key) pair costs
// 4*D flops (two length-D dot products) against reading each of q, k, v once,
// so at S = T = 700, D = 64 it sits far above the ridge point; this version
// runs them on CUDA cores in float32 (no tensor cores, no TF32), so its bound
// is the float32 CUDA-core peak.
//
// Design (a simple kernel that is right; wgmma, TMA and a deeper pipeline
// come later):
// - One block of 256 threads owns a tile of 64 query rows of one (batch,
//   head) and loops over the key tiles inside, keeping m, l in shared memory
//   and acc in registers.  The TPU kernel's sequential key grid axis becomes
//   that loop: blocks run in no order on Hopper, so nothing carries between
//   them.
// - Per key tile: K is staged transposed in shared memory and each thread
//   computes a 4 x 4 register tile of scores (rows ty + 16 i, keys
//   tx + 16 j); scores go to shared memory, 4 threads per row take the
//   online-softmax update; V is then staged in the buffer K used and each
//   thread accumulates 4 rows x D/16 output columns.
// - Masked scores are -1e30, not -inf: a fully masked tile gives exp(0)
//   terms that the next valid tile's alpha = exp(-1e30 - m) = 0 wipes out.
//   Tiles that lie wholly after the tile's last query row (causal), or
//   wholly before the window of its first row, are skipped: the first kind
//   adds exp(-1e30 - m) = 0 terms, the second kind is wiped out as above,
//   so skipping leaves every row that sees any key unchanged.
// - Ragged S and T are masked here, not padded in device memory.
// - Query tiles are scheduled last-first, so the longest causal rows start
//   first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;
constexpr int kQS = kBQ + 1;   // row stride of the transposed q tile
constexpr int kKS = kBK + 1;   // row stride of the transposed k tile and of p
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

// p rounded to the element type of v (round to nearest even), as float.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(D) * kQS      // q tile, transposed [D][kQS]
         + static_cast<size_t>(D) * kKS    // k tile [D][kKS], then v [kBK][D]
         + static_cast<size_t>(kBQ) * kKS  // scores, then p [kBQ][kKS]
         + 3 * kBQ;                        // m, l, alpha
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tn,
                 int H, int KV, float scale, int causal, int window,
                 float softcap) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* kvs = qs + D * kQS;
  float* ps = kvs + D * kKS;
  float* m_s = ps + kBQ * kKS;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                 // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int rows = min(kBQ, S - q0);

  const long long q_stride = static_cast<long long>(H) * D;    // next s
  const long long kv_stride = static_cast<long long>(KV) * D;  // next t
  const T* qb = q + (static_cast<long long>(b) * S * H + h) * D;
  const T* kb = k + (static_cast<long long>(b) * Tn * KV + kvh) * D;
  const T* vb = v + (static_cast<long long>(b) * Tn * KV + kvh) * D;
  T* ob = out + (static_cast<long long>(b) * S * H + h) * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    qs[d * kQS + r] = r < rows ? to_f(qb[(q0 + r) * q_stride + d]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  int k_lo = 0, k_hi = Tn;
  if (causal) {
    k_hi = min(Tn, q0 + rows);
    if (window > 0) k_lo = max(0, q0 - window + 1) / kBK * kBK;
  }

  const int tx = tid % 16, ty = tid / 16;
  constexpr int kCols = D / 16;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    const int keys = min(kBK, Tn - k0);
    __syncthreads();   // the previous tile is done with kvs and ps
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      kvs[d * kKS + r] = r < keys ? to_f(kb[(k0 + r) * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[d * kQS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kvs[d * kKS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int diff = (q0 + r) - (k0 + c);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = c < keys;
        if (causal) {
          ok = ok && diff >= 0;
          if (window > 0) ok = ok && diff < window;
        }
        ps[r * kKS + c] = ok ? x : kNegInf;
      }
    }
    __syncthreads();   // every read of the k tile is done; ps is complete

    // Stage v in the buffer k used; the softmax below does not touch it.
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      kvs[r * D + d] = r < keys ? to_f(vb[(k0 + r) * kv_stride + d]) : 0.f;
    }
    {
      // Online softmax: 4 neighbouring lanes share a row, 16 keys each.
      const int r = tid / 4, part = tid % 4;
      float* prow = ps + r * kKS + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        sum += p;
        prow[c] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();    // all four lanes have read m_s[r]
      if (part == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kKS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = kvs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();   // l_s final (also when no tile ran)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      ob[(q0 + r) * q_stride + tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tn, int H, int KV, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tn, H, KV, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* out,
             int B, int S, int Tn, int H, int KV, float scale, int causal,
             int window, float softcap, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, Tn, H, KV, scale, causal,
                           window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, Tn, H, KV, scale, causal,
                            window, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, S, Tn, H, KV, scale, causal,
                            window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing and does not synchronize.
// is_bf16 selects bfloat16 (1) or float32 (0) for q, k, v and out.
// Returns the cudaError_t of the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int Tn, int H, int KV,
                           int D, int is_bf16, float scale, int causal,
                           int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (Tn <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, B, S, Tn, H, KV, scale,
                                   causal, window, softcap, st);
  return dispatch<float>(D, q, k, v, out, B, S, Tn, H, KV, scale, causal,
                         window, softcap, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
