// One-token (decode) attention over a KV cache, split over the cache
// (flash-decoding), for Hopper (sm_90a).
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
// (the TPU kernel's p.astype(v.dtype)) and the unrounded sum as divisor.
// The engine relies on the per-row length mask for partly filled slots.
//
// What bounds it on this card: bytes.  A call reads each valid cache row of
// k and v once, 2 * D * itemsize bytes a slot and KV head (256 bytes at
// D = 64 in bfloat16), and does 4 * D flops a slot and query head for it:
// G / itemsize flops a byte, far below the ridge point (~295 in bf16).
// At the LM paths' decode shapes that is 10.7 MB (MiniCPM-2B: B 4, 36 KV
// heads, lengths 129-418) and ~5 MB (Hymba-1.5B: 5 KV heads, up to 1,316
// slots), 3.2 and ~1.6 us at 3.35 TB/s.  Reading them at that rate needs
// tens of KB in flight on every SM at once, with a cold L2: no layer's
// cache is in L2 when its decode step reaches it.
//
// What the first design (one block per KV head, batch row and group of up to
// 8 query heads, walking the whole cache) lost, and what this one does:
// 1. Too few blocks: 144 at MiniCPM's shape, 20 at Hymba's (132 SMs), each
//    streaming its cache alone.  Here the cache is cut into splits of 64
//    slots (split_layout in kernels/decode_attention/decode_attention.py;
//    longer only past 2,048 slots): a block per (split, KV head, tile of
//    <= 8 query heads, batch row), 2,304 blocks at MiniCPM's shape (most
//    of them past their row's length: they write an empty partial and
//    exit) and 320 / 640 at Hymba's ring / global caches.
// 2. A five-shuffle warp reduction of q.k for every key and query head.
//    Here a thread owns a key: it reads the row from shared memory and q
//    from shared memory (a broadcast), and sums the whole dot product in
//    registers.  The one warp reduction left is a max and a sum per query
//    head and split.
// 3. Arithmetic on padding rows (G = 5 ran as 8).  Here every loop over
//    query heads stops at the real count.
// 4. q and acc for all heads in registers (128 registers at D = 256, G 8).
//    Here q lives in shared memory, and a thread accumulates 16 bytes' worth
//    of V columns (8 bf16 or 4 f32) for each head.
// 5. Plain loads, issued one step ahead.  Here the split's K and V tiles
//    stream through a ring of 4 stages of 8 KB with cp.async (16 bytes a
//    thread, L1 bypassed), so up to 32 KB a block are in flight; rows are
//    stored with the 16-byte chunk c of row r at chunk c ^ (r % 8), so the
//    8 threads of a shared-memory phase that read one chunk of 8 rows, or 8
//    chunks of one row, hit 32 distinct banks.
//
// Two kernels on the caller's stream:
// - decode_split_kernel: a block of 128 threads takes one split's valid
//   slots [start, min(start + split_len, n)) for its query heads.  It
//   streams the K tiles and then the V tiles through the ring.  Scores go
//   to shared memory (split_len <= 512 slots); once the last K tile is
//   scored, one warp a head takes the split's max m and p = exp(s - m),
//   stores round_v(p) and sums l = sum p; the V tiles then accumulate
//   round_v(p) v.  The block writes its float32 partial (m, l, acc[D]) a
//   query head to the scratch.  A split that starts at or past the row's
//   n writes the empty partial (m = -1e30, l = 0) and reads nothing.
// - decode_combine_kernel: a block per (b, h), a thread per column (and
//   per group of splits): in a fixed order, M = max m_s of the non-empty
//   splits (l_s > 0), then
//   out = sum_s exp(m_s - M) acc_s / max(sum_s exp(m_s - M) l_s, 1e-30),
//   an empty split taking weight 0 (its acc is never read).
//   The combine is a second kernel, not a last-block ticket in the first:
//   a ticket needs a counter that is zero before every call, which the
//   caller's fresh torch.empty scratch is not, so it would need a zeroing
//   launch or a counter kept alive between calls (shared by every stream
//   and graph that calls the kernel).  The second launch adds a few us of
//   host time a layer to a step that CUDA graphs will capture whole.
// The split count and length are fixed by T, never by cache_len: the wrapper reads no length on the host, a call can be
// captured in a CUDA graph and replayed with new lengths, and a row's
// result depends only on its own q, cache and length.
//
// Masked slots: only slots below n = cache_len (clamped to T) are read; a
// masked slot adds exp(-1e30 - m) = 0 once any valid slot is seen, so
// skipping them changes nothing.  A row with cache_len <= 0 has no valid
// slot; every split reads all its slots, each masked to -1e30, so each
// split's m is -1e30, its p all 1 and the combine's weights all 1: the
// plain mean over all T slots, as the unskipped softmax gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;            // ring stages
constexpr int kStageBytes = 8192;     // one K or V tile
constexpr int kMaxSplit = 512;        // slots a split holds at most
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   sm90::smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One 16-byte chunk of a row in shared memory, widened to float.
template <typename T>
__device__ __forceinline__ void load_chunk(const char* p,
                                           float (&f)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* tv = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(T)); ++i) f[i] = to_f(tv[i]);
}

template <typename T, int D>
struct Tiles {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kRows = kStageBytes / kRowBytes;   // slots a stage
  static constexpr int kChunks = kRowBytes / 16;          // chunks a row
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  static_assert(kChunks >= 8, "the swizzle needs 8 chunks a row");
  static_assert(kThreads % kRows == 0 && kThreads % kChunks == 0, "tiling");
};

template <int D, int GT>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kStages) * kStageBytes +
         sizeof(float) * GT * (D + kMaxSplit);
}

// Block (split, KV head x head tile, batch row).  Partials: ml [B,H,S,2]
// and acc [B,H,S,D] float32, S = n_splits.  (A minimum of one block an SM
// in the launch bounds: without it ptxas capped the registers of some
// instantiations near 72 and spilled a few bytes.)
template <typename T, int D, int GT>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const int* __restrict__ cache_len,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int Tn, int H, int KV, int n_splits, int split_len,
                    float scale, float softcap) {
  using Tl = Tiles<T, D>;
  constexpr int kRows = Tl::kRows, kChunks = Tl::kChunks;
  constexpr int kElems = Tl::kElems, kRowBytes = Tl::kRowBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  char* ring = reinterpret_cast<char*>(smem);
  float* qs = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  float* ps = qs + GT * D;                          // [GT][kMaxSplit]

  const int G = H / KV;
  const int gtiles = (G + GT - 1) / GT;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / gtiles;
  const int g0 = (blockIdx.y % gtiles) * GT;
  const int b = blockIdx.z;
  const int ng = min(GT, G - g0);
  const int h0 = kvh * G + g0;
  const int tid = threadIdx.x;
  // partial of query head g of this block
  const long long pbase = (static_cast<long long>(b) * H + h0) * n_splits +
                          split;

  const int len = cache_len[b];
  const int n = len >= 1 ? min(len, Tn) : Tn;
  const int start = split * split_len;
  const int hi = min(start + split_len, n);
  if (start >= hi) {
    if (tid < ng) {
      part_ml[2 * (pbase + static_cast<long long>(tid) * n_splits)] = kNegInf;
      part_ml[2 * (pbase + static_cast<long long>(tid) * n_splits) + 1] = 0.f;
    }
    return;
  }
  const int cnt = hi - start;
  const int ntiles = (cnt + kRows - 1) / kRows;
  const int total = 2 * ntiles;                     // K tiles, then V tiles
  const long long row_stride = static_cast<long long>(KV) * D;
  const long long base =
      (static_cast<long long>(b) * Tn + start) * row_stride +
      static_cast<long long>(kvh) * D;

  auto load = [&](int i) {
    if (i < total) {
      const T* src = (i < ntiles ? kc : vc) + base;
      const int r0 = (i < ntiles ? i : i - ntiles) * kRows;
      const int rows = min(kRows, cnt - r0);
      char* dst = ring + (i % kStages) * kStageBytes;
      for (int x = tid; x < rows * kChunks; x += kThreads) {
        const int r = x / kChunks, c = x % kChunks;
        cp_async16(dst + r * kRowBytes + ((c ^ (r & 7)) << 4),
                   src + (r0 + r) * row_stride + c * kElems);
      }
    }
    cp_async_commit();               // empty groups keep the count uniform
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load(i);
  const T* qb = q + (static_cast<long long>(b) * H + h0) * D;
  for (int x = tid; x < ng * D; x += kThreads) qs[x] = to_f(qb[x]);

  // Scores: kR threads a key, each for the heads g = sub, sub + kR, ...
  constexpr int kR = kThreads / kRows;
  constexpr int kHP = (GT + kR - 1) / kR;
  const int j = tid % kRows, sub = tid / kRows;
  for (int i = 0; i < ntiles; ++i) {
    load(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int t = i * kRows + j;                    // slot - start
    if (t < cnt && sub < ng) {
      float s[kHP];
#pragma unroll
      for (int u = 0; u < kHP; ++u) s[u] = 0.f;
      const char* row = ring + (i % kStages) * kStageBytes + j * kRowBytes;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float kf[kElems];
        load_chunk<T>(row + ((c ^ (j & 7)) << 4), kf);
#pragma unroll
        for (int u = 0; u < kHP; ++u) {
          const int g = sub + u * kR;
          if (g < ng) {
            const float4* qv =
                reinterpret_cast<const float4*>(qs + g * D + c * kElems);
#pragma unroll
            for (int e4 = 0; e4 < kElems / 4; ++e4) {
              const float4 qq = qv[e4];
              s[u] = fmaf(qq.x, kf[4 * e4], s[u]);
              s[u] = fmaf(qq.y, kf[4 * e4 + 1], s[u]);
              s[u] = fmaf(qq.z, kf[4 * e4 + 2], s[u]);
              s[u] = fmaf(qq.w, kf[4 * e4 + 3], s[u]);
            }
          }
        }
      }
      const bool valid = start + t < len;
#pragma unroll
      for (int u = 0; u < kHP; ++u) {
        const int g = sub + u * kR;
        if (g < ng) {
          float x = s[u] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          ps[g * kMaxSplit + t] = valid ? x : kNegInf;
        }
      }
    }
    __syncthreads();                 // the stage is refilled next step
  }

  // The split's softmax, one warp a head: m, round_v(p) in place, l.  The
  // next __syncthreads (in the P.V loop) publishes p.
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < ng; g += kWarps) {
      float* sg = ps + g * kMaxSplit;
      float mx = kNegInf;
      for (int t = lane; t < cnt; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int t = lane; t < cnt; t += 32) {
        const float p = expf(sg[t] - mx);
        sum += p;
        sg[t] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const long long pi = pbase + static_cast<long long>(g) * n_splits;
        part_ml[2 * pi] = mx;
        part_ml[2 * pi + 1] = sum;
      }
    }
  }

  // P.V: column chunk vc_chunk of D, keys kg, kg + kKG, ... of each tile.
  constexpr int kKG = kThreads / kChunks;
  const int vc_chunk = tid % kChunks, kg = tid / kChunks;
  float acc[GT][kElems];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[g][e] = 0.f;
  for (int i = ntiles; i < total; ++i) {
    load(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const char* st = ring + (i % kStages) * kStageBytes;
    const int r0 = (i - ntiles) * kRows;
    const int rows = min(kRows, cnt - r0);
    for (int jj = kg; jj < rows; jj += kKG) {
      float vf[kElems];
      load_chunk<T>(st + jj * kRowBytes + ((vc_chunk ^ (jj & 7)) << 4), vf);
      const float* pj = ps + r0 + jj;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < ng) {
          const float p = pj[g * kMaxSplit];
#pragma unroll
          for (int e = 0; e < kElems; ++e)
            acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();
  }

  // Sum the key groups' accumulators through the (now idle) ring.
  cp_async_wait<0>();
  float* red = reinterpret_cast<float*>(ring);      // [kKG][GT][D]
  static_assert(sizeof(float) * kKG * GT * D <= kStages * kStageBytes,
                "the reduction fits in the ring");
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < ng) {
      float4* dst = reinterpret_cast<float4*>(
          red + (kg * GT + g) * D + vc_chunk * kElems);
#pragma unroll
      for (int e4 = 0; e4 < kElems / 4; ++e4)
        dst[e4] = make_float4(acc[g][4 * e4], acc[g][4 * e4 + 1],
                              acc[g][4 * e4 + 2], acc[g][4 * e4 + 3]);
    }
  }
  __syncthreads();
  for (int x = tid; x < ng * D; x += kThreads) {
    const int g = x / D, d = x % D;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < kKG; ++k) a += red[(k * GT + g) * D + d];
    part_acc[(pbase + static_cast<long long>(g) * n_splits) * D + d] = a;
  }
}

// Block per (b, h): kCombineThreads / D groups of D threads, a thread per
// column; group j sums the splits j, j + groups, ..., then the groups are
// summed in order.  The splits' (m, l) and weights sit in shared memory
// ([n_splits] each), so the only loads from device memory are the acc
// rows, all independent.
constexpr int kCombineThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int D, int n_splits) {
  extern __shared__ float cs[];
  float* ws = cs;                                   // [n_splits] weights
  float* ls = ws + n_splits;                        // [n_splits] l
  float* red = ls + n_splits;                       // [groups][D]
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int groups = kCombineThreads / D;
  const int d = tid % D, grp = tid / D;
  const float* ml = part_ml + row * n_splits * 2;
  for (int s = tid; s < n_splits; s += kCombineThreads) {
    ws[s] = ml[2 * s];
    ls[s] = ml[2 * s + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s)
    if (ls[s] > 0.f) mx = fmaxf(mx, ws[s]);
  __syncthreads();
  for (int s = tid; s < n_splits; s += kCombineThreads)
    ws[s] = ls[s] > 0.f ? expf(ws[s] - mx) : 0.f;
  __syncthreads();
  const float* acc = part_acc + row * n_splits * D + d;
  float a = 0.f;
#pragma unroll 4
  for (int s = grp; s < n_splits; s += groups)
    if (ws[s] > 0.f) a += ws[s] * acc[static_cast<long long>(s) * D];
  red[grp * D + d] = a;
  __syncthreads();
  if (grp == 0) {
    float l = 0.f;
    for (int s = 0; s < n_splits; ++s) l += ws[s] * ls[s];
    a = 0.f;
    for (int j = 0; j < groups; ++j) a += red[j * D + d];
    out[row * D + d] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D, int GT>
int launch(const void* q, const void* k, const void* v, const int* lens,
           void* out, float* ml, float* acc, int B, int Tn, int H, int KV,
           int n_splits, int split_len, float scale, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D, GT>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, D, GT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const dim3 grid(static_cast<unsigned>(n_splits),
                  static_cast<unsigned>(KV * ((G + GT - 1) / GT)),
                  static_cast<unsigned>(B));
  decode_split_kernel<T, D, GT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, ml, acc, Tn, H, KV, n_splits,
      split_len, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t cs = sizeof(float) * (2 * n_splits + kCombineThreads);
  decode_combine_kernel<T>
      <<<static_cast<unsigned>(B * H), kCombineThreads, cs, stream>>>(
          ml, acc, static_cast<T*>(out), D, n_splits);
  return cudaGetLastError();
}

template <typename T, int D>
int by_group(const void* q, const void* k, const void* v, const int* lens,
             void* out, float* ml, float* acc, int B, int Tn, int H, int KV,
             int n_splits, int split_len, float scale, float softcap,
             cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1)
    return launch<T, D, 1>(q, k, v, lens, out, ml, acc, B, Tn, H, KV,
                           n_splits, split_len, scale, softcap, stream);
  if (G <= 2)
    return launch<T, D, 2>(q, k, v, lens, out, ml, acc, B, Tn, H, KV,
                           n_splits, split_len, scale, softcap, stream);
  if (G <= 4)
    return launch<T, D, 4>(q, k, v, lens, out, ml, acc, B, Tn, H, KV,
                           n_splits, split_len, scale, softcap, stream);
  return launch<T, D, 8>(q, k, v, lens, out, ml, acc, B, Tn, H, KV,
                         n_splits, split_len, scale, softcap, stream);
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const int* lens, void* out, float* ml, float* acc, int B, int Tn,
             int H, int KV, int n_splits, int split_len, float scale,
             float softcap, cudaStream_t stream) {
  switch (D) {
    case 64:
      return by_group<T, 64>(q, k, v, lens, out, ml, acc, B, Tn, H, KV,
                             n_splits, split_len, scale, softcap, stream);
    case 128:
      return by_group<T, 128>(q, k, v, lens, out, ml, acc, B, Tn, H, KV,
                              n_splits, split_len, scale, softcap, stream);
    case 256:
      return by_group<T, 256>(q, k, v, lens, out, ml, acc, B, Tn, H, KV,
                              n_splits, split_len, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; allocates nothing and does not
// synchronize.  is_bf16 selects bfloat16 (1) or float32 (0) for q, the
// caches and out.  `scratch` holds B*H*n_splits*(D + 2) float32
// (`scratch_floats`): the partials' (m, l), then their acc.  The splits
// cover [0, Tn): n_splits * split_len >= Tn > (n_splits - 1) * split_len,
// split_len <= 512.  Pointers must be 16-byte aligned.  Returns the
// cudaError_t of the launches.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* cache_len, void* out, void* scratch,
                            long long scratch_floats, int B, int Tn, int H,
                            int KV, int D, int is_bf16, int n_splits,
                            int split_len, float scale, float softcap,
                            void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (Tn <= 0 || KV <= 0 || H % KV != 0 || n_splits <= 0 || split_len <= 0 ||
      split_len > kMaxSplit ||
      static_cast<long long>(n_splits) * split_len < Tn ||
      static_cast<long long>(n_splits - 1) * split_len >= Tn)
    return cudaErrorInvalidValue;
  const long long parts = static_cast<long long>(B) * H * n_splits;
  if (scratch_floats < parts * (D + 2)) return cudaErrorInvalidValue;
  float* ml = static_cast<float*>(scratch);
  float* acc = ml + 2 * parts;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, cache_len, out, ml, acc, B, Tn,
                                   H, KV, n_splits, split_len, scale, softcap,
                                   st);
  return dispatch<float>(D, q, k, v, cache_len, out, ml, acc, B, Tn, H, KV,
                         n_splits, split_len, scale, softcap, st);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
