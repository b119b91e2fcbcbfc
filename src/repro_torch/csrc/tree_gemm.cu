// Tree-ensemble GEMM inference (Hummingbird strategy) for Hopper, sm_90a, on
// the int8 tensor cores.
//
// Replaces the TPU kernel tree_gemm_pallas / tree_gemm_kernel in
// src/repro/kernels/tree_gemm/tree_gemm.py.  For every row and every tree,
// in tree order:
//
//   gates = (x[feat[t]] <= b[t])    [I]   which internal-node conditions hold
//   S     = gates . c[t]            [L]   signed count of satisfied path edges
//   match = (S == d[t])             [L]   exactly one leaf matches
//   out  += match . e[t]            [O]   its payout
//
// The TPU kernel gates by the one-hot product x . a[t]; for the finite x the
// wrapper passes (kernels/tree_gemm/ops.py maps NaN/+inf to fmax and -inf to
// -fmax) that product is exactly x[feat[t]], so the gather gives the same
// booleans without the F x I multiply-adds.
//
// Operands (built once per ensemble by ops.kernel_operands): x [N,F] f32;
// feat [T,Ip] int32 and b [T,Ip] f32; ct [T,Lp,Ip] int8, c transposed (the
// K-major B operand), values in {-1, 0, +1}; d [T,Lp] int32 (padded leaves
// carry INT32_MAX, which no sum reaches); e [T,L,O] f32; out [N,O] f32.  Ip
// is a multiple of 128 and Lp of 64; padded nodes and leaves have zero rows
// and columns of c, so they add nothing.
//
// Exactness: gates are {0,1} and c is {-1,0,+1}, so S is an exact small
// integer in int8 x int8 -> int32, as it was in float32; the payout adds one
// leaf value to an exact zero (0 + e, as match . e would) and the trees are
// summed strictly in tree order, so the result is bitwise that of ref.py
// and of traversal.
//
// What bounds it on this card: the gates . c product, 2 N T Ip Lp int8
// operations at 1,979 TOP/s (4.3 ms at N = 1M, T = 64, I = L = 256), above
// the bytes (x once, 28 MB: 8.4 us).  In the way of that: every row block
// streams all of c from L2 (T Ip Lp bytes, 4 MB at the main shape), and
// shared memory feeds both the product and the gathers.
//
// Design:
// - A block owns 128 rows: two warpgroups of 64 rows each; two blocks
//   share an SM while Ip <= 256 (one above, for registers), and being
//   independent, one block's gate step overlaps the other's product.
//   Blocks run in no order, so the TPU kernel's sequential tree grid axis
//   (which accumulates into a revisited output block) becomes a loop over
//   trees inside the block: no atomics, no split across trees, and the
//   ragged last tile is masked here.
// - Thread 0 streams c in chunks of 64 leaves x Ip (tree by tree, chunk by
//   chunk) by TMA through a ring of kStages stages guarded by mbarriers,
//   kStages - 1 chunks ahead of its own warpgroup, so the next tree's c is
//   in flight while this one's product runs.  Every chunk is read by both
//   warpgroups.  There is no producer warp: with one, a ninth warp a block
//   would cap a thread at 96 registers and spill the gates.
// - Gate step: each thread computes the gates of the two rows it holds in
//   the wgmma A fragment straight into registers (Ip/32 x 4 s8x4), by
//   gathering x from a [F, 128] tile staged once per block.  The gates
//   never touch shared memory.
// - Product: S chunk [64, 64] = gates . c chunk by wgmma m64n64k32 (s8 in,
//   s32 accumulator), Ip/32 steps unrolled, A from registers, B K-major in
//   shared memory.
// - Match on the s32 fragment against d; the matching leaf of each row is
//   recorded in shared memory (two buffers, by tree parity); after the tree
//   each thread adds 0 + e[leaf] into the rows' float32 sums that it alone
//   owns (tree 0 assigns).

#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kLeaves = 64;     // leaves per chunk of c (the wgmma's N)
constexpr int kStages = 4;      // depth of the ring of c chunks
constexpr int kWG = 2;          // warpgroups a block, 64 rows each
constexpr int kRows = kWG * 64;

// Blocks an SM holds: two (128 registers a thread) while the gates, Ip / 8
// registers, leave room for the rest; one above Ip = 256.
__host__ __device__ constexpr int blocks_per_sm(int ni_p) {
  return ni_p <= 256 ? 2 : 1;
}

struct Layout {
  size_t ring, xs, acc, leaf, bars, total;
  int xs_stride;   // floats from one feature's row of the x tile to the next
};

// Shared memory of a block: the ring [kStages][64][ni_p] int8 (1024-byte
// aligned, from an aligned base: 1 KB of slack is added), x tile
// [nf][kRows + 8] f32 (the 8 spread a warp's gathers over the banks), sums
// [kRows][no] f32, leaf [2][kRows] int, barriers.
__host__ __device__ inline Layout layout(int nf, int ni_p, int no) {
  const size_t rows = kRows;
  Layout s;
  s.xs_stride = kRows + 8;
  s.ring = 0;
  s.xs = s.ring + kStages * static_cast<size_t>(kLeaves) * ni_p;
  s.acc = s.xs + sizeof(float) * static_cast<size_t>(nf) * s.xs_stride;
  s.leaf = s.acc + sizeof(float) * rows * no;
  s.bars = (s.leaf + sizeof(int) * 2 * rows + 7) & ~size_t(7);
  s.total = 1024 + s.bars + 8 * 2 * kStages;
  return s;
}

__device__ __forceinline__ uint32_t gates4(const float* xr, int stride,
                                           int4 f, float4 b) {
  return (xr[f.x * stride] <= b.x ? 1u : 0u) |
         (xr[f.y * stride] <= b.y ? 1u << 8 : 0u) |
         (xr[f.z * stride] <= b.z ? 1u << 16 : 0u) |
         (xr[f.w * stride] <= b.w ? 1u << 24 : 0u);
}

// ni_p (internal nodes, padded) is a template argument so that the gates
// stay in registers and the wgmma steps unroll into one sequence.
template <int ni_p>
__global__ void __launch_bounds__(kWG * 128, blocks_per_sm(ni_p))
tree_gemm_kernel(const __grid_constant__ CUtensorMap tc,
                 const float* __restrict__ x, const int* __restrict__ feat,
                 const float* __restrict__ b, const int* __restrict__ d,
                 const float* __restrict__ e, float* __restrict__ out, int n,
                 int nf, int nt, int nl_p, int nl, int no) {
  constexpr int kSteps = ni_p / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout lay = layout(nf, ni_p, no);
  unsigned char* ring = base + lay.ring;
  float* xs = reinterpret_cast<float*>(base + lay.xs);
  float* acc = reinterpret_cast<float*>(base + lay.acc);
  int* leaf = reinterpret_cast<int*>(base + lay.leaf);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows =
      static_cast<int>(min(static_cast<long long>(kRows), n - row0));
  const int chunk_bytes = kLeaves * ni_p;
  const int n_chunks = nl_p / kLeaves;

  for (int idx = tid; idx < nf * kRows; idx += blockDim.x) {
    const int r = idx % kRows, f = idx / kRows;
    xs[f * lay.xs_stride + r] =
        r < rows ? x[(row0 + r) * nf + f] : 0.f;   // ragged: never stored
  }
  for (int r = tid; r < 2 * kRows; r += blockDim.x) leaf[r] = 0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWG * 4);   // one arrival a warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 streams every chunk of c, in tree order: the first kStages
  // now, and chunk it - 1 + kStages once every consumer has released chunk
  // it - 1 (it waits for that at the top of chunk it).
  const int n_loads = nt * n_chunks;
  auto load = [&](int it) {
    const int s = it % kStages;
    if (it >= kStages) sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
    const int t = it / n_chunks, lc = it % n_chunks;
    sm90::mbar_expect_tx(&full[s], chunk_bytes);
#pragma unroll
    for (int p = 0; p < ni_p / 128; ++p)
      sm90::tma_load_2d(ring + s * chunk_bytes + p * sm90::kPanelBytes, &tc,
                        &full[s], p * 128, t * nl_p + lc * kLeaves);
  };
  if (tid == 0)
    for (int it = 0; it < min(kStages, n_loads); ++it) load(it);

  // Consumer warpgroup w owns block rows 64 w .. 64 w + 63.  In the wgmma
  // fragments a thread holds rows r0 and r0 + 8 of them: of the
  // accumulator, element 4 j + e at row r0 + 8 (e / 2), column
  // 8 j + cq + e % 2; of the gates (A), for step k, nodes 32 k + 4 c + i
  // (registers 0, 1) and 32 k + 16 + 4 c + i (registers 2, 3), i < 4.
  const int w = tid / 128, tw = tid % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c4 = (lane % 4) * 4, cq = (lane % 4) * 2;
  const int xstride = lay.xs_stride;
  const float* xr = xs + 64 * w + r0;

  for (int t = 0; t < nt; ++t) {
    const int* ft = feat + static_cast<size_t>(t) * ni_p;
    const float* bt = b + static_cast<size_t>(t) * ni_p;
    uint32_t ga[kSteps][4];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int node = 32 * k + 16 * half + c4;
        const int4 f4 = __ldg(reinterpret_cast<const int4*>(ft + node));
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(bt + node));
        ga[k][2 * half] = gates4(xr, xstride, f4, b4);
        ga[k][2 * half + 1] = gates4(xr + 8, xstride, f4, b4);
      }
    }

    int* lt = leaf + (t & 1) * kRows;      // this tree's leaves
    const int* dt = d + static_cast<size_t>(t) * nl_p;
    for (int lc = 0; lc < n_chunks; ++lc) {
      const int it = t * n_chunks + lc;
      const int s = it % kStages;
      const unsigned char* ct = ring + s * chunk_bytes;
      if (tid == 0 && it >= 1 && it - 1 + kStages < n_loads)
        load(it - 1 + kStages);
      int sacc[32];
      sm90::mbar_wait(&full[s], (it / kStages) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        sm90::wgmma_s8_rs(
            sacc, ga[k][0], ga[k][1], ga[k][2], ga[k][3],
            sm90::desc_sw128(ct + (k / 4) * sm90::kPanelBytes + (k % 4) * 32,
                             0),
            k > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::reg_fence(sacc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);   // the warp is done with s
      // match: exactly one leaf of the tree matches each row
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = lc * kLeaves + 8 * j + cq;
        const int2 dl = __ldg(reinterpret_cast<const int2*>(dt + col));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 64 * w + r0 + 8 * r;
          if (sacc[4 * j + 2 * r] == dl.x) lt[row] = col;
          if (sacc[4 * j + 2 * r + 1] == dl.y) lt[row] = col + 1;
        }
      }
    }
    // lt is complete; the next tree writes the other buffer, and the one
    // after it this one only once every thread has passed this barrier
    // again, after its payout below
    sm90::warpgroup_sync(1 + w);
    const float* et = e + static_cast<size_t>(t) * nl * no;
    for (int idx = tw; idx < 64 * no; idx += 128) {
      const int row = 64 * w + idx / no, o = idx % no;
      const float p = 0.f + et[static_cast<size_t>(lt[row]) * no + o];
      acc[row * no + o] = t == 0 ? p : acc[row * no + o] + p;
    }
  }

  for (int idx = tw; idx < 64 * no; idx += 128) {
    const int row = 64 * w + idx / no;
    if (row < rows) out[(row0 + row) * no + idx % no] = acc[row * no + idx % no];
  }
}

template <int ni_p>
cudaError_t launch(const CUtensorMap& tc, const float* x, const int* feat,
                   const float* b, const int* d, const float* e, float* out,
                   int n, int nf, int nt, int nl_p, int nl, int no,
                   cudaStream_t stream) {
  const size_t smem = layout(nf, ni_p, no).total;
  cudaError_t err = cudaFuncSetAttribute(
      tree_gemm_kernel<ni_p>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  tree_gemm_kernel<ni_p><<<blocks, kWG * 128, smem, stream>>>(
      tc, x, feat, b, d, e, out, n, nf, nt, nl_p, nl, no);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes.
size_t tree_gemm_smem_bytes(int nf, int ni_p, int no) {
  return layout(nf, ni_p, no).total;
}

// Launches on `stream`; allocates nothing and does not synchronize.  ni_p
// must be 128, 256, 384 or 512, nl_p a multiple of 64, and ct 16-byte
// aligned.  Returns the cudaError_t of the launch (0 on success).
int tree_gemm_launch(const float* x, const int* feat, const float* b,
                     const void* ct, const int* d, const float* e, float* out,
                     int n, int nf, int nt, int ni_p, int nl_p, int nl,
                     int no, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (nt <= 0 || nl_p % kLeaves != 0 || nl_p <= 0)
    return cudaErrorInvalidValue;
  CUtensorMap tc;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ni_p),
                              static_cast<cuuint64_t>(nt) * nl_p};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ni_p)};
  const cuuint32_t box[2] = {128, kLeaves};
  cudaError_t err = sm90::encode_tensor_map(
      &tc, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ct, dims, strides, box);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ni_p) {
    case 128:
      return launch<128>(tc, x, feat, b, d, e, out, n, nf, nt, nl_p, nl, no,
                         st);
    case 256:
      return launch<256>(tc, x, feat, b, d, e, out, n, nf, nt, nl_p, nl, no,
                         st);
    case 384:
      return launch<384>(tc, x, feat, b, d, e, out, n, nf, nt, nl_p, nl, no,
                         st);
    case 512:
      return launch<512>(tc, x, feat, b, d, e, out, n, nf, nt, nl_p, nl, no,
                         st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tree_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
