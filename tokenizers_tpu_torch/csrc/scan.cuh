// Block-wide scans over one row, shared by the kernels of this directory.
//
// block_scan: a block of NT threads walks the row in tiles of NT
// positions; a scan carries its running value from tile to tile.  Within a
// tile: a warp scan with shuffles, a scan of the 32 warp totals by warp 0,
// then each thread combines.  `op(a, b)` means "a, then b", so
// non-commutative operators (the affine hash step) work too.  Every thread
// of the block must call block_scan the same number of times (it
// synchronises); threads past the row's end pass the identity.
//
// row_scan_exclusive (below): the scans of a row held in registers.
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

// ---- scans of a row held in registers --------------------------------------
//
// A block whose thread t owns the contiguous positions [t*K, t*K + K) of a
// row scans it in three steps: each thread folds its K values, the block
// scans those per-thread aggregates (row_scan_exclusive below), and each
// thread walks its K values again from the aggregate of everything before
// it.  A forward scan (in position order) and a reverse one (from the row's
// end) share the block step, so one __syncthreads serves both.
//
// A scanned type S has `static S id()`, `static S op(S a, S b)` ("a, then b"
// in scan order: for a reverse scan, a covers the later positions) and
// `S xfer(G g)`, which applies g to each 32-bit field (for the shuffles).

template <class S>
__device__ __forceinline__ S shfl_up_s(const S& x, int d) {
  return x.xfer([d](int v) { return __shfl_up_sync(FULL_MASK, v, d); });
}
template <class S>
__device__ __forceinline__ S shfl_down_s(const S& x, int d) {
  return x.xfer([d](int v) { return __shfl_down_sync(FULL_MASK, v, d); });
}
template <class S>
__device__ __forceinline__ S shfl_idx_s(const S& x, int lane) {
  return x.xfer([lane](int v) { return __shfl_sync(FULL_MASK, v, lane); });
}

struct NoScan {  // the empty scan, for a round that runs one direction only
  __device__ static NoScan id() { return {}; }
  __device__ static NoScan op(NoScan, NoScan) { return {}; }
  template <class G>
  __device__ NoScan xfer(G) const { return {}; }
};

struct LastPos {  // last marked position so far, or -1
  int p;
  __device__ static LastPos id() { return {-1}; }
  __device__ static LastPos op(LastPos a, LastPos b) { return {a.p > b.p ? a.p : b.p}; }
  template <class G>
  __device__ LastPos xfer(G g) const { return {g(p)}; }
};

struct FirstPos {  // first marked position from here on, or BIG_POS
  int p;
  __device__ static FirstPos id() { return {BIG_POS}; }
  __device__ static FirstPos op(FirstPos a, FirstPos b) { return {a.p < b.p ? a.p : b.p}; }
  template <class G>
  __device__ FirstPos xfer(G g) const { return {g(p)}; }
};

// In: f and b, this thread's forward and reverse aggregates.  Out: f, the
// forward combination of every thread before this one; b, the reverse
// combination of every thread after it (identities at the ends).  Called by
// every thread of the block; blockDim.x is a multiple of 32 and at most
// 1024; wf and wb are __shared__ arrays of 32.  One __syncthreads: the warp
// totals go through shared memory, and every warp scans them itself.
template <class F, class B>
__device__ __forceinline__ void row_scan_exclusive(F& f, B& b, F* wf, B* wb) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  F fi = f;
  B bi = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const F y = shfl_up_s(fi, d);
    if (lane >= d) fi = F::op(y, fi);
    const B z = shfl_down_s(bi, d);
    if (lane + d < 32) bi = B::op(z, bi);
  }
  if (lane == 31) wf[w] = fi;
  if (lane == 0) wb[w] = bi;
  F fe = shfl_up_s(fi, 1);  // exclusive within the warp
  if (lane == 0) fe = F::id();
  B be = shfl_down_s(bi, 1);
  if (lane == 31) be = B::id();
  __syncthreads();
  F tf = lane < nw ? wf[lane] : F::id();
  B tb = lane < nw ? wb[lane] : B::id();
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const F y = shfl_up_s(tf, d);
    if (lane >= d) tf = F::op(y, tf);
    const B z = shfl_down_s(tb, d);
    if (lane + d < 32) tb = B::op(z, tb);
  }
  F pf = shfl_idx_s(tf, (w + 31) & 31);  // warps 0 .. w-1
  if (w == 0) pf = F::id();
  B pb = shfl_idx_s(tb, (w + 1) & 31);   // warps w+1 .. nw-1
  if (w + 1 >= nw) pb = B::id();
  f = F::op(pf, fe);
  b = B::op(pb, be);
}
