// Block-wide scans over one row, shared by the kernels of this directory.
//
// Every kernel here runs one block of NT threads per row and walks the row
// in tiles of NT positions; a scan carries its running value from tile to
// tile.  Within a tile: a warp scan with shuffles, a scan of the 32 warp
// totals by warp 0, then each thread combines.  `op(a, b)` means "a, then
// b", so non-commutative operators (the affine hash step) work too.
//
// Every thread of the block must call block_scan the same number of times
// (it synchronises); threads past the row's end pass the identity.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 1024
#define FULL_MASK 0xffffffffu
#define BIG_POS 0x7fffffff

struct Aff2 {  // two affine maps x -> a * x + c over uint32, side by side
  unsigned a1, c1, a2, c2;
};

__device__ __forceinline__ int shfl_up(int x, int d) {
  return __shfl_up_sync(FULL_MASK, x, d);
}
__device__ __forceinline__ long long shfl_up(long long x, int d) {
  return __shfl_up_sync(FULL_MASK, x, d);
}
__device__ __forceinline__ Aff2 shfl_up(Aff2 x, int d) {
  Aff2 y;
  y.a1 = __shfl_up_sync(FULL_MASK, x.a1, d);
  y.c1 = __shfl_up_sync(FULL_MASK, x.c1, d);
  y.a2 = __shfl_up_sync(FULL_MASK, x.a2, d);
  y.c2 = __shfl_up_sync(FULL_MASK, x.c2, d);
  return y;
}

struct MinOp {
  template <class T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a < b ? a : b; }
};
struct MaxOp {
  template <class T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct AddOp {
  template <class T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct AffOp {  // apply p, then q
  __device__ __forceinline__ Aff2 operator()(Aff2 p, Aff2 q) const {
    Aff2 r;
    r.a1 = p.a1 * q.a1;
    r.c1 = p.c1 * q.a1 + q.c1;
    r.a2 = p.a2 * q.a2;
    r.c2 = p.c2 * q.a2 + q.c2;
    return r;
  }
};

// Inclusive scan of one tile (x: this thread's element, in thread order),
// continuing from `carry`, which is updated to include the whole tile.
// `wt` is a __shared__ array of 32 T.
template <typename T, typename Op>
__device__ __forceinline__ T block_scan(T x, Op op, T* wt, T& carry) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = shfl_up(x, d);
    if (lane >= d) x = op(y, x);
  }
  if (lane == 31) wt[w] = x;
  __syncthreads();
  if (w == 0) {
    T t = wt[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T y = shfl_up(t, d);
      if (lane >= d) t = op(y, t);
    }
    wt[lane] = t;
  }
  __syncthreads();
  T pre = (w > 0) ? op(carry, wt[w - 1]) : carry;
  x = op(pre, x);
  carry = op(carry, wt[31]);
  __syncthreads();
  return x;
}

// Number of NT-wide tiles covering a row of C positions.
__device__ __forceinline__ int n_tiles(int C) { return (C + NT - 1) / NT; }
