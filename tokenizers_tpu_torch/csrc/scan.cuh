// Scans of a row held in registers, shared by the kernels of this
// directory.
//
// row_scan_exclusive (below): the scans of a row whose positions a block's
// threads hold in registers; cluster_scan_exclusive: the same over a row
// split across the CTAs of a thread-block cluster, the carries exchanged
// through distributed shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define BIG_POS 0x7fffffff

// the global timer in ns (the phase-timing builds' stamps)
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

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

// The block step of row_scan_exclusive and cluster_scan_exclusive.  In: f
// and b, this thread's forward and reverse aggregates.  Out: f, the forward
// combination of every thread of the block before this one; b, the reverse
// combination of every thread after it (identities at the ends); tf and tb,
// the whole block's forward and reverse combinations.  Called by every
// thread of the block; blockDim.x is a multiple of 32 and at most 1024; wf
// and wb are __shared__ arrays of 32.  One __syncthreads: the warp totals
// go through shared memory, and every warp scans them itself.
template <class F, class B>
__device__ __forceinline__ void block_scan_exclusive(F& f, B& b, F* wf, B* wb,
                                                     F& tf_all, B& tb_all) {
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
  tf_all = shfl_idx_s(tf, nw - 1);
  tb_all = shfl_idx_s(tb, 0);
}

// The scans of a row held by one block (see block_scan_exclusive).
template <class F, class B>
__device__ __forceinline__ void row_scan_exclusive(F& f, B& b, F* wf, B* wb) {
  F tf;
  B tb;
  block_scan_exclusive(f, b, wf, wb, tf, tb);
}

// ---- rows split across a thread-block cluster ------------------------------
//
// CTA r of a cluster of n holds the r-th slice of a row.  A scan over the
// row is the block scan of each slice, then a carry: every CTA publishes
// its slice's totals in its own shared memory, the cluster synchronises,
// and each warp reads the totals of every rank (lane q reads rank q, through
// distributed shared memory) and composes those before its rank (forward)
// and after it (reverse) with a warp scan.  n <= 32.
//
// A CTA must not exit while another may still read its shared memory: a
// kernel that reads remote shared memory calls cluster_arrive() after its
// last remote read and cluster_wait() before it exits.

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// every thread of every CTA of the cluster; orders shared memory across it
__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ int cluster_rank() {  // this CTA's rank, 0 .. n-1
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {  // n
  unsigned r;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return (int)r;
}

// `p` (an address in this CTA's shared memory) in the shared memory of
// cluster rank `rank`, as a generic address
template <class T>
__device__ __forceinline__ T* at_rank(T* p, int rank) {
  unsigned long long q;
  asm("mapa.u64 %0, %1, %2;" : "=l"(q) : "l"(reinterpret_cast<unsigned long long>(p)),
      "r"(rank));
  return reinterpret_cast<T*>(q);
}

// f, b as row_scan_exclusive, over the whole row of the cluster; cf, cb:
// __shared__ slots of this CTA for its totals, one pair per call site (a
// later scan must not overwrite totals another CTA may still be reading).
// rank, n: this CTA's rank and the cluster's size.  One __syncthreads and one
// cluster barrier.
template <class F, class B>
__device__ __forceinline__ void cluster_scan_exclusive(F& f, B& b, F* wf, B* wb,
                                                       F* cf, B* cb, int rank,
                                                       int n) {
  F tf;
  B tb;
  block_scan_exclusive(f, b, wf, wb, tf, tb);
  if (threadIdx.x == 0) {
    *cf = tf;
    *cb = tb;
  }
  cluster_sync_all();
  const int lane = threadIdx.x & 31;
  F xf = F::id();
  B xb = B::id();
  if (lane < n) {
    xf = *at_rank(cf, lane);
    xb = *at_rank(cb, lane);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {  // lane q: ranks 0..q and q..n-1
    const F y = shfl_up_s(xf, d);
    if (lane >= d) xf = F::op(y, xf);
    const B z = shfl_down_s(xb, d);
    if (lane + d < 32) xb = B::op(z, xb);
  }
  F pre = shfl_idx_s(xf, (rank + 31) & 31);
  if (rank == 0) pre = F::id();
  B post = shfl_idx_s(xb, (rank + 1) & 31);
  if (rank + 1 >= n) post = B::id();
  f = F::op(pre, f);
  b = B::op(post, b);
}
