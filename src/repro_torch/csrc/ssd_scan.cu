// Chunk-parallel Mamba-2 SSD scan (Hymba's SSM heads) for Hopper (sm_90a).
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
// Chunk math (chunks of Q = 64 steps), with c_t = sum_{j<=t} dt_j a
// (inclusive, within the chunk; dt a <= 0):
//   y_t = sum_{s<=t} (C_t . B_s) exp(min(c_t - c_s, 0)) dt_s x_s
//       + exp(min(c_t, 0)) h_{c-1} C_t
//   h_c = exp(min(c_last, 0)) h_{c-1} + L_c,
//   L_c = sum_s exp(min(c_last - c_s, 0)) dt_s x_s B_s^T
// Every exponent is clamped at 0 before exp, as the TPU kernel clamps its
// masked ones: nothing can overflow.  B and C are read straight from their
// [B,S,N] rows, shared by the heads of a batch row; the per-head broadcast
// of the TPU wrapper is never materialized.  Steps past S in the last
// chunk are loaded as x = dt = B = C = 0: their decay is exp(0) and their
// update 0, so the state is untouched; their y is not written.  The chunk
// is 64 steps, not the TPU kernel's 128: the intra-chunk work a head, about
// S Q P / 2, halves.  The cumsum c and the differences c_t - c_s are taken
// in float64 (Q scalars a chunk, converted to float32 before exp): under
// strong decay (dt a down to ~-2,000 a step) |c| reaches ~1e4 within a
// chunk, and a float32 difference of two such sums is off by ~1e-3 in the
// exponent, 0.1% of a decay factor that need not be small.  On the card
// that put the final state of the (2, 1100, 3, 64, 16) strong-decay case
// 0.023 from the per-step recurrence, past the 3e-4 tolerance; in float64
// the exponent is exact to its own float32 rounding.
//
// What bounds it on this card: bytes.  A call reads x, dt, a, B and C once
// and writes y and the state once; y (float32) and x dominate: on the
// Hymba prefill (x, dt, B, C bfloat16; B 1, S 1300, H 50, P 64) 25.4 MB,
// 7.6 us at 3.35 TB/s.  The recurrence needs 5 P N float32 flops a step
// and head (0.33 GFLOP there, 5 us at the float32 peak); the chunked form
// below does about 3x that at Q = 64.
//
// Design: the state enters the next chunk linearly with a scalar decay, so
// every chunk's local work runs in parallel and only the recurrence
// h_c = exp(c_last) h_{c-1} + L_c per state element is serial.
// ssd_scan_launch runs three kernels back to back on the caller's stream:
//   (1) ssd_local_kernel, one block of 256 threads per (b, h, chunk): the
//       chunk's cumsum (a warp scan), L_c and c_last into the scratch.
//       1,050 blocks at the Hymba prefill (B 1, H 50, 21 chunks).
//   (2) ssd_state_kernel, one thread per (b, h, p, n): walks the chunks with
//       h <- exp(min(c_last, 0)) h + L_c, overwrites L_c with the state that
//       enters chunk c, and writes the final state.  51,200 threads.
//   (3) ssd_output_kernel, one block of 256 threads per (b, h, chunk): the
//       weights W[t][s] = (C_t . B_s) exp(min(c_t - c_s, 0)) dt_s once per
//       (t, s) for all channels (a 4 x 4 tile of (t, s) a thread), then
//       y = W x + exp(min(c_t, 0)) C_t h_{c-1}.  Each thread takes the rows
//       2q, 2q + 1, Q - 2 - 2q and Q - 1 - 2q and 4 channels, so every
//       thread walks the same Q + 2 steps of the triangle.  1,050 blocks.
// Blocks load x, B and C 16 bytes a thread where every row starts on a
// 16-byte boundary and P and N are whole vectors, as the LM path's views
// are (else one value a thread), all loads in flight before any is stored.
// Scratch (allocated by the caller): B H n_chunks (P N + 1) float32, 4.3
// MB at the Hymba prefill.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W, Hymba prefill
// shape): 0.052 ms of device time a call, 6.6x faster than PR 15's design
// and ~7x the bound: (1) 0.016 ms, (2) 0.006 ms, (3) 0.030 ms.  (3) lost
// much of its time to shared-memory bank conflicts until each quarter-warp
// read one contiguous 128-byte run of x, and the load phases to requests
// of one value a thread until they read 16 bytes.  PR 15's design, one
// block per (b, h) walking 11 chunks of 128 in order, ran 50 blocks on 132
// SMs and spent ~31 us a chunk: thread 0 alone ran the cumsum, the warps
// of the triangle's long rows set the pace, and every score and exp was
// computed twice (once per half of the channels).
// Float32 on CUDA cores throughout, float64 for the cumsum (no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int Q = 64;            // chunk length
constexpr int kMaxP = 64;        // head width (channels)
constexpr int kMaxN = 16;        // state size
constexpr int kThreads = 256;
constexpr int kStateThreads = 128;
constexpr int kAhead = 8;        // chunks the state pass loads ahead
constexpr int kPer = Q / 32;     // steps a lane sums in the warp scan
constexpr int kHLoads = kMaxP * kMaxN / kThreads;  // a thread's part of h

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The block's chunk: blockIdx.x = (b * H + h) * n_chunks + chunk.
struct Chunk {
  int h, c0;
  long long row0;         // b's first token
};

__device__ __forceinline__ Chunk chunk_of(int S, int H, int n_chunks) {
  const int blk = blockIdx.x;
  const int c = blk % n_chunks, bh = blk / n_chunks;
  Chunk ch;
  ch.h = bh % H;
  ch.c0 = c * Q;
  ch.row0 = static_cast<long long>(bh / H) * S;
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

// This thread's part of a chunk's [Q][kMax] rows of one input (x with kMax
// = kMaxP, B or C with kMaxN), widened, zero past S and past `width`: row
// s of the chunk starts at src[(row0 + c0 + s) row + off].  With kVec the
// rows are read 16 bytes a thread (every row starts on a 16-byte boundary
// and `width` is a whole number of vectors), else one value a thread.
// load() issues every load; put(f) then calls f(s, column, value).
template <typename T, int kMax, bool kVec>
struct Tile {
  static constexpr int kPerVec = kVec ? 16 / sizeof(T) : 1;
  static constexpr int kPerRow = kMax / kPerVec;
  static constexpr int kN = (Q * kPerRow + kThreads - 1) / kThreads;
  using Raw = typename std::conditional<kVec, uint4, float>::type;
  Raw raw[kN];

  __device__ __forceinline__ void load(const T* __restrict__ src,
                                       long long row, long long off,
                                       const Chunk& ch, int S, int width) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int s = i / kPerRow, c = (i % kPerRow) * kPerVec;
      const int pos = ch.c0 + s;
      const bool in = i < Q * kPerRow && pos < S && c < width;
      const T* at = src + (ch.row0 + pos) * row + off + c;
      if constexpr (kVec)
        raw[j] = in ? *reinterpret_cast<const uint4*>(at)
                    : make_uint4(0u, 0u, 0u, 0u);
      else
        raw[j] = in ? to_f32(*at) : 0.f;
    }
  }
  template <typename F>
  __device__ __forceinline__ void put(F f) const {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i >= Q * kPerRow) continue;
      const int s = i / kPerRow, c = (i % kPerRow) * kPerVec;
      if constexpr (kVec) {
        float v[kPerVec];
        widen(raw[j], v);
#pragma unroll
        for (int e = 0; e < kPerVec; ++e) f(s, c + e, v[e]);
      } else {
        f(s, c, raw[j]);
      }
    }
  }
};

// This thread's dt (threads below Q; zero past S).
template <typename T>
__device__ __forceinline__ float load_dt(const T* __restrict__ dt,
                                         const Chunk& ch, int S, int H) {
  const int pos = ch.c0 + threadIdx.x;
  return threadIdx.x < Q && pos < S
      ? to_f32(dt[(ch.row0 + pos) * H + ch.h]) : 0.f;
}

// Decay exponent c_t - c_s (c_t alone where c_s = 0), clamped at 0.
__device__ __forceinline__ float exponent(double c_t, double c_s) {
  return fminf(static_cast<float>(c_t - c_s), 0.f);
}

// Inclusive cumsum of dts[s] * ah (float32 products) into cs[], by warp 0,
// in float64.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float ah,
                                             double* cs) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 32) return;
  double part[kPer];
  double run = 0.0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    run += static_cast<double>(dts[lane * kPer + j] * ah);
    part[j] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) cs[lane * kPer + j] = excl + part[j];
}

// (1) L_c = sum_s exp(min(c_last - c_s, 0)) dt_s x_s B_s^T and c_last.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_local_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 long long x_row, long long b_row,
                 float* __restrict__ l_state, float* __restrict__ l_last,
                 int S, int H, int P, int N, int n_chunks) {
  __shared__ float xs[Q][kMaxP];                    // zero past P
  __shared__ __align__(16) float brem[Q][kMaxN];    // B_s rem_s, zero past N
  __shared__ float dts[Q];
  __shared__ double cs[Q];
  const int tid = threadIdx.x;
  const Chunk ch = chunk_of(S, H, n_chunks);
  const float ah = a[ch.h];        // loaded with the chunk, before a barrier

  {
    Tile<T, kMaxP, kVec> xt;
    Tile<T, kMaxN, kVec> bt;
    xt.load(x, x_row, ch.h * P, ch, S, P);
    bt.load(bm, b_row, 0, ch, S, N);
    const float dv = load_dt(dt, ch, S, H);
    xt.put([&](int s, int p, float v) { xs[s][p] = v; });
    bt.put([&](int s, int n, float v) { brem[s][n] = v; });
    if (tid < Q) dts[tid] = dv;
  }
  __syncthreads();
  chunk_cumsum(dts, ah, cs);
  __syncthreads();
  const double last = cs[Q - 1];
  for (int i = tid; i < Q * kMaxN; i += kThreads) {
    const int s = i / kMaxN, n = i % kMaxN;
    brem[s][n] *= expf(exponent(last, cs[s])) * dts[s];
  }
  if (tid == 0) l_last[blockIdx.x] = static_cast<float>(last);
  __syncthreads();

  // L[p][n0 .. n0 + 3].
  const int p = tid / 4, n0 = (tid % 4) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int s = 0; s < Q; ++s) {
    const float xv = xs[s][p];
    const float4 b4 = *reinterpret_cast<const float4*>(&brem[s][n0]);
    acc[0] += xv * b4.x;
    acc[1] += xv * b4.y;
    acc[2] += xv * b4.z;
    acc[3] += xv * b4.w;
  }
  if (p < P) {
    float* out = l_state + static_cast<long long>(blockIdx.x) * P * N
        + p * N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + j < N) out[n0 + j] = acc[j];
  }
}

// (2) h <- exp(min(c_last, 0)) h + L_c along the chunks, one thread per
// state element; L_c is overwritten with the state that enters chunk c.
__global__ void __launch_bounds__(kStateThreads)
ssd_state_kernel(float* __restrict__ l_state,
                 const float* __restrict__ l_last,
                 float* __restrict__ h_out, long long n, int pn,
                 int n_chunks) {
  const long long i = static_cast<long long>(blockIdx.x) * kStateThreads
      + threadIdx.x;
  if (i >= n) return;
  const long long bh = i / pn;
  const int e = static_cast<int>(i % pn);
  float* l = l_state + bh * n_chunks * pn + e;
  const float* last = l_last + bh * n_chunks;
  float st = 0.f;
  for (int c0 = 0; c0 < n_chunks; c0 += kAhead) {
    float lc[kAhead], dec[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (c0 + j < n_chunks) {
        lc[j] = l[static_cast<long long>(c0 + j) * pn];
        dec[j] = last[c0 + j];
      }
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (c0 + j < n_chunks) {
        l[static_cast<long long>(c0 + j) * pn] = st;
        st = expf(fminf(dec[j], 0.f)) * st + lc[j];
      }
  }
  h_out[i] = st;
}

// y[step t of the chunk][p0 .. p0 + 3] = acc, unless the step is past S.
__device__ __forceinline__ void store_row(float* __restrict__ y,
                                          const Chunk& ch, int t, int p0,
                                          const float (&acc)[4], int S,
                                          int H, int P) {
  const int pos = ch.c0 + t;
  if (pos >= S) return;
  float* yrow = y + ((ch.row0 + pos) * H + ch.h) * P;
  if (P % 4 == 0) {            // p0 + 4 <= P, rows 16-byte aligned
    *reinterpret_cast<float4*>(&yrow[p0]) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (p0 + j < P) yrow[p0 + j] = acc[j];
  }
}

// (3) y of one chunk: the intra-chunk triangle and the inter-chunk term
// from the state that enters the chunk.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
ssd_output_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, long long x_row,
                  long long b_row, long long c_row,
                  const float* __restrict__ h_enter, float* __restrict__ y,
                  int S, int H, int P, int N, int n_chunks) {
  __shared__ __align__(16) float xs[Q][kMaxP];   // zero past P
  __shared__ __align__(16) float wt[Q][Q];       // W transposed: [s][t]
  __shared__ __align__(16) float ht[kMaxN][kMaxP];  // h_{c-1} transposed
  __shared__ __align__(16) float bt[kMaxN][Q];   // B transposed
  __shared__ __align__(16) float ct[kMaxN][Q];   // C transposed
  __shared__ float dts[Q], ec[Q];
  __shared__ double cs[Q];
  const int tid = threadIdx.x;
  const Chunk ch = chunk_of(S, H, n_chunks);
  const float ah = a[ch.h];        // loaded with the chunk, before a barrier
  const bool first = blockIdx.x % n_chunks == 0;   // enters with h = 0

  {
    Tile<T, kMaxP, kVec> xt;
    Tile<T, kMaxN, kVec> btile, ctile;
    xt.load(x, x_row, ch.h * P, ch, S, P);
    btile.load(bm, b_row, 0, ch, S, N);
    ctile.load(cm, c_row, 0, ch, S, N);
    const float dv = load_dt(dt, ch, S, H);
    const float* src = h_enter + static_cast<long long>(blockIdx.x) * P * N;
    float hv[kHLoads];                  // h [kMaxP][kMaxN], zero past P, N
#pragma unroll
    for (int j = 0; j < kHLoads; ++j) {
      const int i = tid + j * kThreads, p = i / kMaxN, n = i % kMaxN;
      hv[j] = (!first && p < P && n < N) ? src[p * N + n] : 0.f;
    }
    xt.put([&](int s, int p, float v) { xs[s][p] = v; });
    btile.put([&](int s, int n, float v) { bt[n][s] = v; });
    ctile.put([&](int s, int n, float v) { ct[n][s] = v; });
#pragma unroll
    for (int j = 0; j < kHLoads; ++j) {
      const int i = tid + j * kThreads;
      ht[i % kMaxN][i / kMaxN] = hv[j];
    }
    if (tid < Q) dts[tid] = dv;
  }
  __syncthreads();
  chunk_cumsum(dts, ah, cs);
  __syncthreads();
  if (tid < Q) ec[tid] = expf(exponent(cs[tid], 0.0));

  // W[t][s] = (C_t . B_s) exp(min(c_t - c_s, 0)) dt_s for s <= t, 0 above
  // the diagonal: each thread a 4 x 4 tile, t0 = 4 (tid % 16) and
  // s0 = 4 (tid / 16); the tiles above the diagonal are never read.
  {
    const int t0 = 4 * (tid % 16), s0 = 4 * (tid / 16);
    if (s0 <= t0) {
      float g[4][4] = {};
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        const float4 c4 = *reinterpret_cast<const float4*>(&ct[n][t0]);
        const float4 b4 = *reinterpret_cast<const float4*>(&bt[n][s0]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sj = s0 + j;
        float wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = sj <= t0 + i
              ? g[i][j] * expf(exponent(cs[t0 + i], cs[sj])) * dts[sj] : 0.f;
        *reinterpret_cast<float4*>(&wt[sj][t0]) =
            make_float4(wv[0], wv[1], wv[2], wv[3]);
      }
    }
  }
  __syncthreads();

  // y rows lo, lo + 1 and hi, hi + 1 (lo = 2 q, hi = Q - 2 - 2 q),
  // channels p0 .. p0 + 3: (lo + 2) + (hi + 2) = Q + 2 steps of the
  // triangle for every thread.  Each quarter-warp reads one contiguous
  // 128-byte run of a row of x (no bank conflicts).  W above the diagonal is
  // 0 within the diagonal tiles, so the pairs share their loop bounds.
  const int q = tid / 16, p0 = (tid % 16) * 4;
  const int lo = 2 * q, hi = Q - 2 - 2 * q;
  float acc[4][4] = {};             // rows lo, lo + 1, hi, hi + 1
  for (int s = 0; s <= hi + 1; ++s) {
    const float4 x4 = *reinterpret_cast<const float4*>(&xs[s][p0]);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
    const float2 wh = *reinterpret_cast<const float2*>(&wt[s][hi]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[2][j] += wh.x * xv[j];
      acc[3][j] += wh.y * xv[j];
    }
    if (s <= lo + 1) {
      const float2 wl = *reinterpret_cast<const float2*>(&wt[s][lo]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[0][j] += wl.x * xv[j];
        acc[1][j] += wl.y * xv[j];
      }
    }
  }
  if (!first) {
    float in[4][4] = {};
#pragma unroll 4
    for (int n = 0; n < kMaxN; ++n) {
      const float4 h4 = *reinterpret_cast<const float4*>(&ht[n][p0]);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
      const float2 cl = *reinterpret_cast<const float2*>(&ct[n][lo]);
      const float2 chh = *reinterpret_cast<const float2*>(&ct[n][hi]);
      const float cv[4] = {cl.x, cl.y, chh.x, chh.y};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) in[r][j] += cv[r] * hv[j];
    }
    const float ev[4] = {ec[lo], ec[lo + 1], ec[hi], ec[hi + 1]};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] += ev[r] * in[r][j];
  }
  if (p0 >= P) return;
  store_row(y, ch, lo, p0, acc[0], S, H, P);
  store_row(y, ch, lo + 1, p0, acc[1], S, H, P);
  store_row(y, ch, hi, p0, acc[2], S, H, P);
  store_row(y, ch, hi + 1, p0, acc[3], S, H, P);
}

template <typename T, bool kVec>
int launch_passes(const void* x, const void* dt, const float* a,
                  const void* bm, const void* cm, long long x_row,
                  long long b_row, long long c_row, float* y, float* h_out,
                  float* scratch, int B, int S, int H, int P, int N,
                  int n_chunks, cudaStream_t stream) {
  const int blocks = B * H * n_chunks;
  // The scratch: [B,H,n_chunks,P,N] local states, [B,H,n_chunks] c_last.
  float* l_state = scratch;
  float* l_last = scratch + static_cast<long long>(blocks) * P * N;
  ssd_local_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), x_row, b_row, l_state, l_last, S, H, P, N,
      n_chunks);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * H * P * N;
  ssd_state_kernel<<<static_cast<unsigned>((n + kStateThreads - 1)
                                           / kStateThreads),
                     kStateThreads, 0, stream>>>(l_state, l_last, h_out, n,
                                                 P * N, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_output_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), x_row, b_row,
      c_row, l_state, y, S, H, P, N, n_chunks);
  return cudaGetLastError();
}

// 16-byte loads where every row of x, B and C starts on a 16-byte boundary
// and P and N are whole vectors (the LM path's views are), else one value a
// thread.
template <typename T>
int launch(const void* x, const void* dt, const float* a, const void* bm,
           const void* cm, long long x_row, long long b_row, long long c_row,
           float* y, float* h_out, float* scratch, int B, int S, int H,
           int P, int N, int n_chunks, cudaStream_t stream) {
  constexpr int kPerVec = 16 / sizeof(T);
  const bool vec =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm)
       | reinterpret_cast<uintptr_t>(cm)) % 16 == 0
      && (x_row | b_row | c_row | P | N) % kPerVec == 0;
  return (vec ? launch_passes<T, true> : launch_passes<T, false>)(
      x, dt, a, bm, cm, x_row, b_row, c_row, y, h_out, scratch, B, S, H, P,
      N, n_chunks, stream);
}

}  // namespace

extern "C" {

// Launches the three passes on `stream`; allocates nothing and does not
// synchronize.  x, dt, bm and cm are bfloat16 where `is_bf16` is nonzero,
// else float32; x_row, b_row and c_row are the element strides from one
// token to the next of x, bm and cm; a, y, h_out and scratch are float32,
// y and h_out contiguous.  `scratch` holds `scratch_floats` floats, at
// least B H ceil(S / 64) (P N + 1).  Returns the cudaError_t of the
// launches.
int ssd_scan_launch(const void* x, const void* dt, const float* a,
                    const void* bm, const void* cm, int is_bf16,
                    long long x_row, long long b_row, long long c_row,
                    float* y, float* h_out, float* scratch,
                    long long scratch_floats, int B, int S, int H, int P,
                    int N, void* stream) {
  if (B < 0 || S < 0 || H < 0 || P < 1 || P > kMaxP || N < 1 || N > kMaxN
      || x_row < static_cast<long long>(H) * P || b_row < N || c_row < N)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || S == 0) return cudaSuccess;
  const int n_chunks = (S + Q - 1) / Q;
  if (static_cast<long long>(B) * H * n_chunks > 0x7fffffffLL
      || scratch_floats
          < static_cast<long long>(B) * H * n_chunks * (P * N + 1))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, x_row, b_row, c_row, y,
                                 h_out, scratch, B, S, H, P, N, n_chunks, st);
  return launch<float>(x, dt, a, bm, cm, x_row, b_row, c_row, y, h_out,
                       scratch, B, S, H, P, N, n_chunks, st);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
