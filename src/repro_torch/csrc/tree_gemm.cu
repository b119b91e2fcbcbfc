// Tree-ensemble GEMM inference (Hummingbird strategy) for Hopper, sm_90a.
//
// Replaces the TPU kernel tree_gemm_pallas / tree_gemm_kernel in
// src/repro/kernels/tree_gemm/tree_gemm.py.  For every row and every tree,
// in tree order:
//
//   gates = (x . a[t] <= b[t])      [I]   which internal-node conditions hold
//   S     = gates . c[t]            [L]   signed count of satisfied path edges
//   match = (S == d[t])             [L]   exactly one leaf matches
//   out  += match . e[t]            [O]   its payout
//
// Shapes: x [N,F], a [T,F,I], b [T,I], c [T,I,L], d [T,L], e [T,L,O], out
// [N,O], all float32, row-major and contiguous.  The wrapper
// (kernels/tree_gemm/ops.py) maps NaN/+inf to fmax and -inf to -fmax before
// the launch and averages after it.
//
// What bounds it on this card: operations.  Per row and tree the kernel does
// F*I + I*L + L*O multiply-adds (I*L dominates: 65,536 at I = L = 256)
// against F + O floats of row data, so it sits far above the ridge point of
// float32 on CUDA cores; every tree's matrices (256 KB for c at I = L = 256)
// are re-read by each row tile from L2.
//
// Design:
// - Blocks run in no order, so the TPU kernel's sequential tree grid axis
//   (which accumulates into a revisited output block) becomes a loop inside
//   the block.  One block owns a 128-row tile and walks the trees in order,
//   keeping the tile's [128, O] accumulator in shared memory: no atomics, no
//   split across trees, so the sum is taken in exactly the reference's
//   order, and the ragged last tile is masked here, not padded in memory.
// - S = gates . c is a register-tiled float32 product on CUDA cores: each
//   thread holds an 8-row x 8-leaf tile of S (leaves in two runs of 4, 64
//   apart, so a quarter-warp's float4 reads of c hit distinct banks);
//   gates (as [k][row]) and a 32 x 128 chunk of c are staged in shared
//   memory per step of 32 internal nodes.  Two blocks fit on an SM (128
//   registers a thread), so one block's loads overlap the other's FMAs.  No tensor cores and no TF32: the
//   result must be bitwise equal to traversal.  It is, because x . a with
//   one-hot a and finite x is exact, every partial sum of S is a small
//   integer (products of {0,1} and {-1,0,+1}), and the payout adds one leaf
//   value to exact zeros.
// - The payout is taken by index: the matching leaf of each row is recorded
//   in shared memory and its row of e added (0 + e, as the product would).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;     // rows per block (tile)
constexpr int kLeaves = 128;   // leaves per pass over S
constexpr int kStep = 32;      // internal nodes per step of the product
constexpr int kThreads = 256;
constexpr int kTm = 8;         // rows of S per thread
constexpr int kTn = 8;         // leaves of S per thread: 2 runs of 4
constexpr int kLeafGroups = kLeaves / kTn;   // 16
constexpr int kHalf = kLeaves / 2;           // offset of a thread's 2nd run
constexpr int kGateCols = kStep * kRows / kThreads;  // 16 gates per thread
constexpr int kGateRun = 8;    // gates summed together (registers allow 8)

static_assert(kRows / kTm * kLeafGroups == kThreads, "thread tiling");
static_assert(kThreads % kRows == 0, "gate tiling: one row per thread");

// Leaf (within the pass) of a thread's j-th column of S.
__device__ __forceinline__ int leaf_of(int tc, int j) {
  return (j < 4 ? 0 : kHalf) + tc * 4 + (j & 3);
}

__global__ void __launch_bounds__(kThreads, 2)
tree_gemm_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ b, const float* __restrict__ c,
                 const float* __restrict__ d, const float* __restrict__ e,
                 float* __restrict__ out, int n, int nf, int nt, int ni,
                 int nl, int no) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [nf][kRows]  x tile, transposed
  float* gs = xs + nf * kRows;                  // [kStep][kRows] gates
  float* cs = gs + kStep * kRows;               // [kStep][kLeaves] chunk of c
  float* acc = cs + kStep * kLeaves;            // [kRows][no] ensemble sums
  int* leaf = reinterpret_cast<int*>(acc + kRows * no);  // [kRows]

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n - row0));

  for (int idx = tid; idx < nf * kRows; idx += kThreads) {
    const int r = idx % kRows, f = idx / kRows;
    xs[idx] = r < rows ? x[(row0 + r) * nf + f] : 0.f;   // ragged rows: never stored
  }

  const int tr = tid / kLeafGroups;   // row group: rows tr*kTm .. +kTm
  const int tc = tid % kLeafGroups;   // leaf group: see leaf_of()

  for (int t = 0; t < nt; ++t) {
    const float* at = a + static_cast<size_t>(t) * nf * ni;
    const float* bt = b + static_cast<size_t>(t) * ni;
    const float* ct = c + static_cast<size_t>(t) * ni * nl;
    const float* dt = d + static_cast<size_t>(t) * nl;
    const float* et = e + static_cast<size_t>(t) * nl * no;

    for (int r = tid; r < kRows; r += kThreads) leaf[r] = -1;

    for (int l0 = 0; l0 < nl; l0 += kLeaves) {
      float s[kTm][kTn];
#pragma unroll
      for (int m = 0; m < kTm; ++m)
#pragma unroll
        for (int j = 0; j < kTn; ++j) s[m][j] = 0.f;

      for (int k0 = 0; k0 < ni; k0 += kStep) {
        __syncthreads();   // the previous step is done with gs and cs
        // gates: each thread takes one row and kGateCols internal nodes, 8
        // at a time, with the feature loop outside so that the 8 sums are
        // independent FMAs (a sum per node in turn stalls on every load)
        const int r = tid % kRows;
        const int kc_end = (tid / kRows + 1) * kGateCols;
        for (int kc = kc_end - kGateCols; kc < kc_end; kc += kGateRun) {
          float xa[kGateRun];
#pragma unroll
          for (int j = 0; j < kGateRun; ++j) xa[j] = 0.f;
          for (int f = 0; f < nf; ++f) {
            const float xv = xs[f * kRows + r];
            const float* af = at + static_cast<size_t>(f) * ni + k0 + kc;
#pragma unroll
            for (int j = 0; j < kGateRun; ++j)
              if (k0 + kc + j < ni) xa[j] = fmaf(xv, af[j], xa[j]);
          }
#pragma unroll
          for (int j = 0; j < kGateRun; ++j) {
            const int i = k0 + kc + j;
            gs[(kc + j) * kRows + r] = (i < ni && xa[j] <= bt[i]) ? 1.f : 0.f;
          }
        }
        for (int idx = tid; idx < kStep * kLeaves; idx += kThreads) {
          const int i = k0 + idx / kLeaves, l = l0 + idx % kLeaves;
          cs[idx] = (i < ni && l < nl) ? ct[static_cast<size_t>(i) * nl + l] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kStep; ++k) {
          const float4 g0 = *reinterpret_cast<const float4*>(gs + k * kRows + tr * kTm);
          const float4 g1 = *reinterpret_cast<const float4*>(gs + k * kRows + tr * kTm + 4);
          const float4 c0 = *reinterpret_cast<const float4*>(cs + k * kLeaves + tc * 4);
          const float4 c1 = *reinterpret_cast<const float4*>(cs + k * kLeaves + kHalf + tc * 4);
          const float gv[kTm] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          const float cw[kTn] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
          for (int m = 0; m < kTm; ++m)
#pragma unroll
            for (int j = 0; j < kTn; ++j) s[m][j] = fmaf(gv[m], cw[j], s[m][j]);
        }
      }
      // match: exactly one leaf of the tree matches each row
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const int l = l0 + leaf_of(tc, j);
        if (l < nl) {
          const float dl = dt[l];
#pragma unroll
          for (int m = 0; m < kTm; ++m)
            if (s[m][j] == dl) leaf[tr * kTm + m] = l;
        }
      }
    }
    __syncthreads();
    // payout, accumulated in tree order (tree 0 assigns)
    for (int idx = tid; idx < kRows * no; idx += kThreads) {
      const int r = idx / no, o = idx % no, l = leaf[r];
      const float p = l >= 0 ? 0.f + et[static_cast<size_t>(l) * no + o] : 0.f;
      acc[idx] = t == 0 ? p : acc[idx] + p;
    }
    __syncthreads();   // leaf[] is reset by the next tree
  }

  for (int idx = tid; idx < kRows * no; idx += kThreads) {
    const int r = idx / no;
    if (r < rows) out[(row0 + r) * no + idx % no] = acc[idx];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes.
size_t tree_gemm_smem_bytes(int nf, int no) {
  return sizeof(float) * (static_cast<size_t>(nf) * kRows + kStep * kRows +
                          kStep * kLeaves + static_cast<size_t>(kRows) * no) +
         sizeof(int) * kRows;
}

// Launches on `stream`; allocates nothing and does not synchronize.
// Returns the cudaError_t of the launch (0 on success).
int tree_gemm_launch(const float* x, const float* a, const float* b,
                     const float* c, const float* d, const float* e,
                     float* out, int n, int nf, int nt, int ni, int nl, int no,
                     void* stream) {
  if (n <= 0) return cudaSuccess;
  const size_t smem = tree_gemm_smem_bytes(nf, no);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  tree_gemm_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, a, b, c, d, e, out, n, nf, nt, ni, nl, no);
  return cudaGetLastError();
}

const char* tree_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
