// A linear model's logit straight from a row's raw input columns, for
// Hopper (sm_90a): the one-hot featurizer, the standard scaler and the
// row-wise fold of ml/linear.py::rowwise_matmul in one pass.
//
// Replaces no TPU kernel: the JAX package leaves featurize -> matmul_bias to
// XLA.  It exists because on the card the two plain-PyTorch nodes were 29 ms
// of a 32 ms flights query: one compare kernel a one-hot feature and a
// torch.cat into a [rows, features] float32 matrix (1.96 GB at 5,819,079
// rows and 84 features), then 84 strided column products and 84 adds over
// it.  Here the matrix never exists.
//
// For every row r, with acc starting at -0.0 (the identity of IEEE addition,
// so the first term enters exactly as the fold's first product does):
//
//   for each block j, in the featurize node's column order:
//     one-hot column: acc = acc + table[off_j + code - base_j]   (code kept)
//                     acc = acc + zero_j                          (otherwise)
//     scaler column:  acc = acc + ((float(x) - mean_j) * inv_std_j) * w_j
//   out[r] = acc + bias
//
// Exactness: every product and sum is one float32 operation in round-to-
// nearest (__fmul_rn / __fadd_rn, never contracted into an FMA), in the
// fold's order, so the logit is bitwise that of the unfused plan and of
// ref.py.  A one-hot block of the fold adds 1 * w_k for the one category
// that matches (categories are unique) and 0 * w_i for the others; adding
// signed zeros to a sum leaves it as it is, except that a zero sum stays
// -0 only while every zero added is -0.  So the block adds exactly w_k, or,
// where nothing matches or w_k is a zero, the zero whose sign is that of
// every 0 * w_i: -0 if each weight of the block has its sign bit set, else
// +0 (zero_j).  ops.prepare builds the tables that way, once per plan and
// device; a code outside the table reads zero_j.  Weights are finite (the
// fusion rule, ops.fusable), so no 0 * w_i is a NaN.
//
// What bounds it on this card: bytes.  Each input column is read once and
// the logit written once: at 5,819,079 flights with five 4-byte columns,
// 116.4 MB in and 23.3 MB out, 0.042 ms at 3.35 TB/s.  The arithmetic, a
// few float32 operations a column and row, is far below the float32 peak.
//
// Columns: one-hot codes are int32 or bool, scaled columns float32 or int32
// (the port keeps 32-bit columns; codegen fuses no other plan, and the
// wrapper refuses any other column).
//
// Design: one thread scores four consecutive rows.  Where every column and
// the output are aligned for it (the wrapper checks), each column is read
// with one 16-byte load (a 4-byte load for bool), so a warp reads 512
// contiguous bytes of a column per load; the ragged last rows,
// and every row of a misaligned call (a slice at an odd row), read one
// element at a time.  The tables (82 floats for the flights model) are read
// through the read-only path and stay in L1.  The loop over blocks is
// unrolled over kMaxBlocks, so each block's descriptor is read from the
// kernel's parameters at a fixed offset.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxBlocks = 16;  // columns a call scores (ops.MAX_BLOCKS)
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

enum Dtype : int { kFloat32 = 0, kInt32 = 1, kBool = 2 };
enum Kind : int { kOneHot = 0, kScaler = 1 };

// One input column and what it adds to the logit.  The layout is mirrored
// by featurized_linear.py's ctypes structure.
struct Block {
  const void* col;
  int dtype;
  int kind;
  int table_off;  // one-hot: its table's first entry in `table`
  int base;       // one-hot: the code of that entry
  int size;       // one-hot: entries in its table
  float zero;     // one-hot: what a code outside its categories adds
  float mean;     // scaler
  float inv_std;  // scaler
  float weight;   // scaler
};

struct Params {
  Block blocks[kMaxBlocks];
  const float* table;
  float* out;
  long long n;
  int nb;
  float bias;
};

__device__ __forceinline__ float lookup(const Block& b, const float* table,
                                        long long code) {
  const long long idx = code - b.base;
  return (idx >= 0 && idx < b.size) ? __ldg(table + b.table_off + idx)
                                    : b.zero;
}

__device__ __forceinline__ float scaled(const Block& b, float x) {
  return __fmul_rn(__fmul_rn(__fsub_rn(x, b.mean), b.inv_std), b.weight);
}

// A float32 column is scaled, a bool one holds codes (the launch checks).
__device__ __forceinline__ float term(const Block& b, const float*, float x) {
  return scaled(b, x);
}

__device__ __forceinline__ float term(const Block& b, const float* table,
                                      int x) {
  return b.kind == kScaler ? scaled(b, __int2float_rn(x))
                           : lookup(b, table, x);
}

__device__ __forceinline__ float term(const Block& b, const float* table,
                                      bool x) {
  return lookup(b, table, static_cast<int>(x));
}

// The four rows' values of one column: vector loads where `full` (all four
// rows exist and the column is aligned for them), else element by element.
template <typename T>
__device__ __forceinline__ void load_rows(const void* col, long long row0,
                                          long long n, bool full,
                                          T (&v)[kRowsPerThread]) {
  const T* src = static_cast<const T*>(col) + row0;
  constexpr int kBytes = static_cast<int>(sizeof(T)) * kRowsPerThread;
  if (full) {
    if constexpr (kBytes == 16) {
      const int4 chunk = __ldg(reinterpret_cast<const int4*>(src));
      memcpy(v, &chunk, kBytes);
    } else {
      const unsigned word = __ldg(reinterpret_cast<const unsigned*>(src));
      memcpy(v, &word, kBytes);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      v[r] = row0 + r < n ? src[r] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void add_block(const Block& b, const float* table,
                                          long long row0, long long n,
                                          bool full,
                                          float (&acc)[kRowsPerThread]) {
  T v[kRowsPerThread];
  load_rows<T>(b.col, row0, n, full, v);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
    acc[r] = __fadd_rn(acc[r], term(b, table, v[r]));
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
    featurized_linear_kernel(const Params p) {
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
      kRowsPerThread;
  if (row0 >= p.n) return;
  const bool full = kAligned && row0 + kRowsPerThread <= p.n;
  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = -0.0f;
#pragma unroll
  for (int j = 0; j < kMaxBlocks; ++j) {
    if (j >= p.nb) break;
    const Block& b = p.blocks[j];
    switch (b.dtype) {
      case kFloat32:
        add_block<float>(b, p.table, row0, p.n, full, acc);
        break;
      case kInt32:
        add_block<int>(b, p.table, row0, p.n, full, acc);
        break;
      default:
        add_block<bool>(b, p.table, row0, p.n, full, acc);
        break;
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = __fadd_rn(acc[r], p.bias);
  if (full) {
    *reinterpret_cast<float4*>(p.out + row0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      if (row0 + r < p.n) p.out[row0 + r] = acc[r];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing and does not synchronize.
// `blocks` is a host array of `nb` descriptors (1 <= nb <= kMaxBlocks), each
// naming a contiguous column of `n` rows on the card (one-hot: int32 or
// bool; scaler: float32 or int32); `table` holds the
// one-hot blocks' tables; `out` receives n float32 logits.  `aligned` says
// that every column is aligned to four of its elements (at most 16 bytes)
// and `out` to 16 bytes.  Returns the cudaError_t of the launch (0 on
// success).
int featurized_linear_launch(const void* blocks, int nb, const float* table,
                             float bias, float* out, long long n, int aligned,
                             void* stream) {
  if (nb < 1 || nb > kMaxBlocks || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Params p;
  memset(&p, 0, sizeof(p));
  memcpy(p.blocks, blocks, sizeof(Block) * nb);
  for (int j = 0; j < nb; ++j) {
    const Block& b = p.blocks[j];
    const bool codes =
        b.kind == kOneHot && (b.dtype == kInt32 || b.dtype == kBool);
    const bool values =
        b.kind == kScaler && (b.dtype == kInt32 || b.dtype == kFloat32);
    if (!codes && !values) return cudaErrorInvalidValue;
  }
  p.table = table;
  p.out = out;
  p.n = n;
  p.nb = nb;
  p.bias = bias;
  const long long threads = (n + kRowsPerThread - 1) / kRowsPerThread;
  const long long grid = (threads + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned)
    featurized_linear_kernel<true>
        <<<static_cast<unsigned>(grid), kThreads, 0, st>>>(p);
  else
    featurized_linear_kernel<false>
        <<<static_cast<unsigned>(grid), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// Bytes of one descriptor, for the binding to check its mirror.
int featurized_linear_block_bytes() { return static_cast<int>(sizeof(Block)); }

const char* featurized_linear_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
