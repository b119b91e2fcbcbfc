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
// float32) taken over tiles of 64 keys, as the TPU kernel does.  Where the
// caller passes an lse buffer (float32 [B,H,S], which is the JAX package's
// [B,KV,G,S] read flat), each row's natural-log log-sum-exp
// m + log(max(l, 1e-30)) goes there too, for the attention backward; a null
// pointer writes nothing, so inference pays nothing for it.  round_v
// rounds p to v's dtype before the P.V product, as the TPU kernel does
// (p.astype(v.dtype)); the running sum l takes p unrounded.  The output is
// written in q's dtype.
//
// What bounds it on this card: at the LM path's shape (S = T = 699, 36
// heads of 64, causal) the bytes, 12.9 MB of q, k, v and out against 6.5
// GFLOP, which the bf16 tensor cores do in ~6.6 us.
//
// Two kernels, one per input type:
//
// bfloat16: flash_wgmma_kernel, built on Hopper's tensor cores.
// - A block is one consumer warpgroup (128 threads) that owns 64 query rows
//   of one (batch, head), and one producer warp.  The producer's lane 0
//   loads Q once by TMA, then keeps K and V tiles (64 keys x D) in flight
//   through a ring of kStages stages, each guarded by mbarriers: full_k and
//   full_v (TMA bytes landed), empty (the consumer is done with the stage).
// - Tensor maps are 3-d views (D-contiguous columns, rows, batch) of the
//   [B*S, H*D] and [B*T, KV*D] row-major arrays, so the row stride is H*D*2
//   or KV*D*2 bytes (a multiple of 128) and a tile that runs past S or T is
//   zero-filled within its own batch.  Boxes are 64 columns x 64 rows with
//   128-byte swizzle; the wgmma descriptors use the same swizzle (sm90.cuh).
// - S = Q.K^T by wgmma m64n64k16 (bf16 in, f32 accumulator), both operands
//   K-major in shared memory, D/16 steps.
// - The softmax runs on the accumulator fragment in registers: a thread
//   holds 2 rows x 16 keys, and the 4 lanes that share a row take its max
//   and sum with __shfl_xor_sync.  Scaling and soft-capping are applied to
//   the fragment, into the log2 domain (exp2 of scaled scores, one multiply
//   an element); the masks only on tiles that cross T, the causal diagonal
//   or the window's edge.
// - P.V by wgmma m64n64k16 with P as the A operand from registers: the
//   accumulator fragment of S is the A-fragment layout, so p is rounded to
//   bf16 in place (the TPU kernel's rounding) and packed in pairs.  V is
//   the B operand, MN-major, transposed by the descriptor; D/64 column
//   panels, one accumulator of 32 floats each.
//
// float32: flash_fwd_kernel on CUDA cores.  TF32 would round q, k, v and p
// to 10 mantissa bits, past the float32 tolerance (2e-5), so this path
// stays in float32 FMAs:
// - One block of 256 threads owns a tile of 64 query rows of one (batch,
//   head) and loops over the key tiles inside, keeping m, l in shared memory
//   and acc in registers.
// - Per key tile: K is staged transposed in shared memory and each thread
//   computes a 4 x 4 register tile of scores (rows ty + 16 i, keys
//   tx + 16 j); scores go to shared memory, 4 threads per row take the
//   online-softmax update; V is then staged in the buffer K used and each
//   thread accumulates 4 rows x D/16 output columns.
//
// Both kernels:
// - The TPU kernel's sequential key grid axis becomes a loop inside the
//   block: blocks run in no order on Hopper, so nothing carries between
//   them.
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

#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The key range [k_lo, k_hi) that rows q0 .. q0 + rows - 1 can see.
__device__ __forceinline__ void key_range(int q0, int rows, int Tn,
                                          int causal, int window, int* k_lo,
                                          int* k_hi) {
  *k_lo = 0;
  *k_hi = Tn;
  if (causal) {
    *k_hi = min(Tn, q0 + rows);
    if (window > 0) *k_lo = max(0, q0 - window + 1) / kBK * kBK;
  }
}

// -- bfloat16: wgmma + TMA -------------------------------------------------

constexpr int kStages = 2;               // K/V ring depth
constexpr int kWgThreads = 160;          // one consumer warpgroup + producer warp

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // Q, then kStages K tiles and kStages V tiles (D/64 panels of 8 KB each),
  // then the barriers; 1 KB of slack to align the tiles to 1024 bytes.
  return 1024 + static_cast<size_t>(1 + 2 * kStages) * (D / 64) *
                    sm90::kPanelBytes +
         8 * (1 + 3 * kStages);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int S, int Tn, int H, int KV, float scale, int causal,
                   int window, float softcap) {
  constexpr int kPanels = D / 64;
  constexpr int kTileBytes = kPanels * sm90::kPanelBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;
  unsigned char* k_s = q_s + kTileBytes;                 // [kStages] tiles
  unsigned char* v_s = k_s + kStages * kTileBytes;       // [kStages] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * kTileBytes);
  uint64_t* q_bar = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                 // b * H + h
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int rows = min(kBQ, S - q0);
  int k_lo, k_hi;
  key_range(q0, rows, Tn, causal, window, &k_lo, &k_hi);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  if (tid == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty[s], 4);   // one arrival a consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // Producer: one lane starts every TMA load.
    if (tid == 128) {
      sm90::mbar_expect_tx(q_bar, kTileBytes);
      for (int p = 0; p < kPanels; ++p)
        sm90::tma_load_3d(q_s + p * sm90::kPanelBytes, &tq, q_bar,
                          h * D + p * 64, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int k0 = k_lo + it * kBK;
        unsigned char* kt = k_s + s * kTileBytes;
        unsigned char* vt = v_s + s * kTileBytes;
        sm90::mbar_expect_tx(&full_k[s], kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          sm90::tma_load_3d(kt + p * sm90::kPanelBytes, &tk, &full_k[s],
                            kvh * D + p * 64, k0, b);
        sm90::mbar_expect_tx(&full_v[s], kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          sm90::tma_load_3d(vt + p * sm90::kPanelBytes, &tv, &full_v[s],
                            kvh * D + p * 64, k0, b);
      }
    }
    return;
  }

  // Consumer warpgroup.  Accumulator fragment of a 64 x 64 tile: element
  // 4 j + e of a thread sits at row r0 + 8 (e / 2), column 8 j + cq + e % 2.
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  float o[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  // running max (log2 domain) and sum of the two rows a thread holds
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;

  sm90::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int k0 = k_lo + it * kBK;
    const unsigned char* kt = k_s + s * kTileBytes;
    const unsigned char* vt = v_s + s * kTileBytes;

    // S = Q . K^T
    float sc[32];
    sm90::mbar_wait(&full_k[s], ph);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * sm90::kPanelBytes + (kk % 4) * 32;
      sm90::wgmma_bf16_ss(sc, sm90::desc_sw128(q_s + off, 0),
                          sm90::desc_sw128(kt + off, 0), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::reg_fence(sc);

    // Scale and soft-cap into the log2 domain (exp(s - m) is taken as
    // exp2((s - m) log2 e)); mask only a tile that crosses T, the causal
    // diagonal or the window's edge; row maxima over the 4 lanes of a row.
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = softcap > 0.f ? softcap * tanhf(sc[i] * scale / softcap) * kLog2e
                            : sc[i] * scale_log2;
    const bool inside =
        k0 + kBK <= Tn &&
        (!causal || (q0 >= k0 + kBK - 1 &&
                     (window <= 0 || q0 + kBQ - 1 - k0 < window)));
    if (!inside) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i / 4) + cq + (i & 1);
        const int diff = q0 + r0 + 8 * ((i >> 1) & 1) - key;
        bool ok = key < Tn;
        if (causal) {
          ok = ok && diff >= 0;
          if (window > 0) ok = ok && diff < window;
        }
        if (!ok) sc[i] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    // p, unrounded into the row sums, rounded to bf16 into the A fragment:
    // pa[2 j + r] holds row r0 + 8 r, keys 8 j + cq, +1.
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(sc[4 * j + 0] - m_run[0]);
      const float p1 = exp2f(sc[4 * j + 1] - m_run[0]);
      const float p2 = exp2f(sc[4 * j + 2] - m_run[1]);
      const float p3 = exp2f(sc[4 * j + 3] - m_run[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pa[2 * j] = pack_bf16(p0, p1);
      pa[2 * j + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i >> 1) & 1];

    // O += P . V: 16 keys a step; the A fragment of keys 16 kk .. +15 is
    // (row r0, keys 16 kk + cq), (r0 + 8, same), (r0, +8), (r0 + 8, +8).
    sm90::mbar_wait(&full_v[s], ph);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        sm90::wgmma_bf16_rs(
            o[p], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
            sm90::desc_sw128(vt + p * sm90::kPanelBytes + kk * 16 * 128,
                             1024),
            1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < kPanels; ++p) sm90::reg_fence(o[p]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);   // the warp is done with s
  }

  const long long q_stride = static_cast<long long>(H) * D;
  __nv_bfloat16* ob = out + (static_cast<long long>(b) * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= rows) continue;
    const float denom = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* orow = ob + (q0 + row) * q_stride;
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + p * 64 + 8 * j + cq) =
            __floats2bfloat162_rn(o[p][4 * j + 2 * r] / denom,
                                  o[p][4 * j + 2 * r + 1] / denom);
    // m_run is in the log2 domain: lse = m ln 2 + ln l.  A row that saw no
    // key keeps m = -1e30 (unscaled), which is the lse the plain version
    // gives it (-1e30 + log l rounds to -1e30 in float32).
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<long long>(bh) * S + q0 + row] =
          m_run[r] == kNegInf ? kNegInf
                              : m_run[r] * kLn2 + logf(denom);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int S, int Tn, int H, int KV,
                 float scale, int causal, int window, float softcap,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const cuuint32_t box[3] = {64, kBQ, 1};
  const cuuint64_t q_dims[3] = {static_cast<cuuint64_t>(H) * D,
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t q_strides[2] = {static_cast<cuuint64_t>(H) * D * 2,
                                   static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint64_t kv_dims[3] = {static_cast<cuuint64_t>(KV) * D,
                                 static_cast<cuuint64_t>(Tn),
                                 static_cast<cuuint64_t>(B)};
  const cuuint64_t kv_strides[2] = {static_cast<cuuint64_t>(KV) * D * 2,
                                    static_cast<cuuint64_t>(Tn) * KV * D * 2};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t err =
      sm90::encode_tensor_map(&tq, bf16, 3, q, q_dims, q_strides, box);
  if (err == cudaSuccess)
    err = sm90::encode_tensor_map(&tk, bf16, 3, k, kv_dims, kv_strides, box);
  if (err == cudaSuccess)
    err = sm90::encode_tensor_map(&tv, bf16, 3, v, kv_dims, kv_strides, box);
  if (err != cudaSuccess) return err;
  const size_t smem = wgmma_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, S, Tn, H, KV, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

// -- float32: CUDA cores ---------------------------------------------------

constexpr int kThreads = 256;
constexpr int kQS = kBQ + 1;   // row stride of the transposed q tile
constexpr int kKS = kBK + 1;   // row stride of the transposed k tile and of p

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(D) * kQS      // q tile, transposed [D][kQS]
         + static_cast<size_t>(D) * kKS    // k tile [D][kKS], then v [kBK][D]
         + static_cast<size_t>(kBQ) * kKS  // scores, then p [kBQ][kKS]
         + 3 * kBQ;                        // m, l, alpha
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int Tn, int H, int KV,
                 float scale, int causal, int window, float softcap) {
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
  const float* qb = q + (static_cast<long long>(b) * S * H + h) * D;
  const float* kb = k + (static_cast<long long>(b) * Tn * KV + kvh) * D;
  const float* vb = v + (static_cast<long long>(b) * Tn * KV + kvh) * D;
  float* ob = out + (static_cast<long long>(b) * S * H + h) * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    qs[d * kQS + r] = r < rows ? qb[(q0 + r) * q_stride + d] : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  int k_lo, k_hi;
  key_range(q0, rows, Tn, causal, window, &k_lo, &k_hi);

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
      kvs[d * kKS + r] = r < keys ? kb[(k0 + r) * kv_stride + d] : 0.f;
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
      kvs[r * D + d] = r < keys ? vb[(k0 + r) * kv_stride + d] : 0.f;
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
        prow[c] = p;
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
      ob[(q0 + r) * q_stride + tx + 16 * j] = acc[i][j] / denom;
  }
  if (lse != nullptr)
    for (int r = tid; r < rows; r += kThreads)
      lse[static_cast<long long>(bh) * S + q0 + r] =
          m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int Tn, int H, int KV, float scale,
               int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Tn, H,
      KV, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <int D>
int launch(int is_bf16, const void* q, const void* k, const void* v,
           void* out, float* lse, int B, int S, int Tn, int H, int KV,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  return is_bf16 ? launch_wgmma<D>(q, k, v, out, lse, B, S, Tn, H, KV, scale,
                                   causal, window, softcap, stream)
                 : launch_f32<D>(q, k, v, out, lse, B, S, Tn, H, KV, scale,
                                 causal, window, softcap, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch at head dim D needs, in bytes (0 for a D
// the kernels do not take).
size_t flash_attention_smem_bytes(int D, int is_bf16) {
  switch (D) {
    case 64:
      return is_bf16 ? wgmma_smem_bytes<64>() : smem_floats<64>() * 4;
    case 128:
      return is_bf16 ? wgmma_smem_bytes<128>() : smem_floats<128>() * 4;
    case 256:
      return is_bf16 ? wgmma_smem_bytes<256>() : smem_floats<256>() * 4;
    default:
      return 0;
  }
}

// Launches on `stream`; allocates nothing and does not synchronize.
// is_bf16 selects bfloat16 (1: the wgmma kernel; q, k, v 16-byte aligned)
// or float32 (0: the CUDA-core kernel) for q, k, v and out.  lse, where
// not null, receives each row's log-sum-exp, float32 [B,H,S].
// Returns the cudaError_t of the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int S, int Tn, int H,
                           int KV, int D, int is_bf16, float scale,
                           int causal, int window, float softcap,
                           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (Tn <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch<64>(is_bf16, q, k, v, out, l, B, S, Tn, H, KV, scale,
                        causal, window, softcap, st);
    case 128:
      return launch<128>(is_bf16, q, k, v, out, l, B, S, Tn, H, KV, scale,
                         causal, window, softcap, st);
    case 256:
      return launch<256>(is_bf16, q, k, v, out, l, B, S, Tn, H, KV, scale,
                         causal, window, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
