// Pre-merge layout of ASCII chunks for the GPT-2 split (kernel B3).
//
// Replaces tokenizers_tpu/ops/layout_pallas.py::layout_fused (_kernel):
// per row of packed bytes,
//   * the GPT-2 pre-split boundaries over ASCII classes, including the
//     's|'t|'re|'ve|'m|'ll|'d contractions and \s+(?!\S);
//   * each position's next boundary position (BIG_POS if none);
//   * the two rolling word hashes h = h * M + (b + 1) mod 2^32,
//     M = 0x01000193 and 0xC597, restarting at each boundary, delivered
//     from each word's last byte back to the word through a fill that
//     reaches 2^9 positions (0 beyond, as in the JAX kernel).
// Plain version: ops/layout_kernels.py (layout_fused_plain).
//
// Bound on an H100 (3.35 TB/s): it reads 4 B (the byte as int32) and
// writes 13 B (bnd as bool; nxt, h1, h2 as int32) per position: a
// [256, 8192] chunk must move 36 MB, 10.6 us.  It is bound by bytes.
//
// Two kernels, chosen by row width in the wrapper:
//
// tt_layout_row (rows of up to LROW_MAX_L = 8192 positions, the whole main
// path) keeps the row on the SM.  The bytes are read once with int4 loads
// and kept in shared memory as uint8; thread t owns LROW_K = 16 contiguous
// positions.  From a 24-byte window of shared memory held in registers it
// computes the byte classes four bytes at a time as bit masks, the
// contractions only at apostrophes, and the boundary rule for all its
// positions at once in bitwise operations on those masks.  One fused scan
// round (scan.cuh's row_scan_exclusive, one __syncthreads) carries forward
// the two hashes as affine maps and in reverse the next boundary and the
// nearest word end together with the maps from a position up to that end,
// so each word's hash reaches every position of the word through the scan
// itself: no raw-hash or word-end plane exists, in global or shared memory.
// The only per-position scratch is thread-private: the local hash at each
// of the thread's own word ends (striped in shared memory, so a thread's
// reads at run-time indices stay conflict-free).  Outputs are stored as
// int4 (bnd as one 16-byte store a thread).  512 threads at L = 8192 with
// __launch_bounds__(512, 2), so two rows share an SM and 256 rows take one
// wave of 132 SMs; dynamic shared memory lrow_smem_bytes(L) = 73,744 B at
// L = 8192.  Measured on an H100 at [256, 8192]: about 0.027 ms against
// 0.103 for the first, tiled design, 2.6x the bound.  What holds it is one
// SM's work on two rows: the blocks start together, the second on an SM
// finishes about 9 us after the first, and the store phase alone runs at
// the card's write rate (phase stamps: tools/b3_phases.py, built with
// -DTT_LAYOUT_PHASES).
//
// tt_layout_wide (rows of LROW_MAX_L < L <= LWIDE_MAX_L positions: every
// long-document chunk, [128, 16384], [64, 32768] and [32, 65536] under the
// 2M-position budget) is the same body over a thread-block cluster: a row
// is cut into n slices of S <= LROW_MAX_L positions, one CTA each (the
// wrapper's layout_kernels.wide_geometry: S = 8192, 4096 at L = 32768,
// so 2, 8 and 8 CTAs of 512 or 256 threads at 73,744 or 36,880 B, two or
// four CTAs an SM).  Each CTA loads its slice and the window's bytes
// across both edges; the scan's carries cross the slices through
// scan.cuh's cluster_scan_exclusive (forward: both hash maps; reverse: the
// next boundary and the nearest word end with its maps), so the hash
// delivery is the same 2^9 cut wherever the slices fall.  No global
// scratch.  A slice past a row's length still writes its outputs.
// Measured on an H100: about 0.031, 0.035 and 0.044 ms at those shapes,
// against 0.14, 0.27 and 0.51 for the tiled kernel it replaced (bound
// 0.0106).  What holds it beyond [128, 16384]: the card holds 62 clusters
// spanning two SMs and 30 spanning four at once
// (cudaOccupancyMaxActiveClusters), not 64 and 32, so the last rows run in
// a second wave; and a cluster's CTAs wait at the scan's cluster barrier
// for its slowest CTA (tools/b3_phases.py --wide).
#include "scan.cuh"

#define H1_MULT 0x01000193u
#define H2_MULT 0x0000C597u
#define HASH_REACH 512

// ---- B3: a row (or a cluster's slice of one) stays on the SM --------------

#define LROW_K 16         // positions a thread owns
#define LROW_MAX_L 8192
#define LWIDE_MAX_L 65536  // the widest chunk engine_base makes: MAX_L / 2
#define LWIDE_MAX_N 16     // CTAs a cluster of the wide kernel may have (above 8: non-portable)
#define LROW_THREADS (LROW_MAX_L / LROW_K)
#define LROW_FRONT 4      // bytes before the slice in shared memory (0 before the row)
#define LROW_BACK 12      // and after it (0 after the row)

#ifdef TT_LAYOUT_PHASES
// Phase-timing build (tools/b3_phases.py): thread 0 of each of the first
// LROW_TIMED blocks stamps the SM clock at the start, after the load's
// barrier, before and after the scan's, and at the end, and the global
// timer at the start and the end.
#define LROW_TIMED 256
#define LROW_STAMPS 5
// per block: the SM clock at each stamp, then the global timer (ns) at the
// first and the last
__device__ long long tt_layout_stamps[LROW_TIMED * (LROW_STAMPS + 2)];
#define LROW_STAMP(n)                                                             \
  do {                                                                            \
    if (threadIdx.x == 0 && blockIdx.x < LROW_TIMED) {                            \
      long long* st = tt_layout_stamps + blockIdx.x * (LROW_STAMPS + 2);          \
      st[n] = clock64();                                                          \
      if ((n) == 0 || (n) == LROW_STAMPS - 1)                                     \
        st[LROW_STAMPS + ((n) != 0)] = global_ns();                               \
    }                                                                             \
  } while (0)
extern "C" int tt_layout_stamps_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, tt_layout_stamps, sizeof(tt_layout_stamps));
}
#else
#define LROW_STAMP(n) \
  do {                \
  } while (0)
#endif

__host__ __device__ __forceinline__ int lrow_threads(int L) {
  return ((L + LROW_K - 1) / LROW_K + 31) / 32 * 32;
}

// the striped local hashes (two uint32 per owned position), then the bytes
// of a slice of S positions
__host__ __device__ __forceinline__ size_t lrow_smem_bytes(int S, int nth) {
  return 2 * sizeof(unsigned) * (size_t)nth * LROW_K + LROW_FRONT + (size_t)S +
         LROW_BACK;
}

__host__ __device__ constexpr unsigned mpow(unsigned m, int k) {  // m^k mod 2^32
  unsigned r = 1u;
  for (; k; k >>= 1, m *= m)
    if (k & 1) r *= m;
  return r;
}

// Bytes four at a time: a flag is 0x80 in its byte.  x: bytes of 0..127.
__device__ __forceinline__ unsigned rep4(unsigned v) { return v * 0x01010101u; }
__device__ __forceinline__ unsigned ge4(unsigned x, unsigned lo) {  // byte >= lo
  return (x + rep4(0x80u - lo)) & 0x80808080u;
}
__device__ __forceinline__ unsigned gt4(unsigned x, unsigned hi) {  // byte > hi
  return (x + rep4(0x7fu - hi)) & 0x80808080u;
}
__device__ __forceinline__ unsigned eq4(unsigned w, unsigned v) {  // byte == v
  const unsigned t = w ^ rep4(v);
  return ~(((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t) & 0x80808080u;
}
__device__ __forceinline__ unsigned nib4(unsigned f) {  // four flags to four bits
  return (f * 0x00204081u) >> 28;
}

struct HashMaps {  // both rolling hashes as affine maps x -> a * x + c
  unsigned a1, c1, a2, c2;
  __device__ static HashMaps id() { return {1u, 0u, 1u, 0u}; }
  __device__ static HashMaps op(HashMaps p, HashMaps q) {  // p, then q
    return {p.a1 * q.a1, p.c1 * q.a1 + q.c1, p.a2 * q.a2, p.c2 * q.a2 + q.c2};
  }
  template <class G>
  __device__ HashMaps xfer(G g) const {
    return {(unsigned)g((int)a1), (unsigned)g((int)c1), (unsigned)g((int)a2),
            (unsigned)g((int)c2)};
  }
};

struct NextEnd {  // reverse scan: first boundary, first word end, and the
  int nb;         // hash maps from the span's first position up to that end
  int end;        // (over the whole span if it holds no end)
  HashMaps f;
  __device__ static NextEnd id() { return {BIG_POS, BIG_POS, HashMaps::id()}; }
  __device__ static NextEnd op(NextEnd a, NextEnd b) {  // a: the later span
    const bool closed = b.end != BIG_POS;
    return {a.nb < b.nb ? a.nb : b.nb, closed ? b.end : a.end,
            closed ? b.f : HashMaps::op(b.f, a.f)};
  }
  template <class G>
  __device__ NextEnd xfer(G g) const {
    return {g(nb), g(end), f.xfer(g)};
  }
};

// CL false: one block per row (S = L).  CL true: cluster rank r of n holds
// the slice [r * S, min(L, (r + 1) * S)) of row blockIdx.x / n.  Positions
// are the row's throughout.  vec: the byte rows and the int32 outputs are
// 16-byte aligned.
template <bool CL>
__global__ void __launch_bounds__(LROW_THREADS, 2)
layout_kernel(const int* __restrict__ bytes, const int* __restrict__ lengths,
              unsigned char* bnd_o, int* nxt_o, int* h1_o, int* h2_o, int L, int S,
              int vec) {
  extern __shared__ __align__(16) unsigned lsmem[];
  const int nth = blockDim.x;
  unsigned* s_c1 = lsmem;                // striped: local h1 at own word ends
  unsigned* s_c2 = s_c1 + nth * LROW_K;  // and h2
  unsigned* s_bw = s_c2 + nth * LROW_K;  // bytes from position s0 - LROW_FRONT, 4 a word
  __shared__ HashMaps w_f[32];
  __shared__ NextEnd w_b[32];
  int rank = 0, n = 1;
  if constexpr (CL) {
    rank = cluster_rank();
    n = cluster_size();
  }
  const int row = CL ? blockIdx.x / n : blockIdx.x;
  const int s0 = rank * S;  // this block's positions: [s0, iend)
  const int iend = min(L, s0 + S);
  const int t = threadIdx.x;
  const size_t off = (size_t)row * L;
  const int len = max(0, min(lengths[row], L));
  const int i0 = s0 + t * LROW_K;

  // ---- load the slice's bytes, 0 outside [0, len) -----------------------
  // S / 4 int4 for nth >= S / LROW_K threads: at most LROW_K / 4 a thread,
  // all issued before the first is used
  LROW_STAMP(0);
  int4 x[LROW_K / 4];
#pragma unroll
  for (int j = 0; j < LROW_K / 4; ++j) {
    const int v = t + j * nth;
    const int p = s0 + 4 * v;
    if (v >= S / 4) continue;
    if (p >= L) {  // the last slice of a cluster may end before S
      x[j] = make_int4(0, 0, 0, 0);
    } else if (vec) {
      x[j] = __ldg(reinterpret_cast<const int4*>(bytes + off + p));
    } else {
      const int* g = bytes + off + p;
      x[j] = make_int4(__ldg(g), __ldg(g + 1), __ldg(g + 2), __ldg(g + 3));
    }
  }
#pragma unroll
  for (int j = 0; j < LROW_K / 4; ++j) {
    const int v = t + j * nth;
    if (v >= S / 4) continue;
    const int p = s0 + 4 * v;
    s_bw[LROW_FRONT / 4 + v] = (p < len ? (unsigned)x[j].x & 0xffu : 0u) |
                               (p + 1 < len ? ((unsigned)x[j].y & 0xffu) << 8 : 0u) |
                               (p + 2 < len ? ((unsigned)x[j].z & 0xffu) << 16 : 0u) |
                               (p + 3 < len ? ((unsigned)x[j].w & 0xffu) << 24 : 0u);
  }
  if (t < (LROW_FRONT + LROW_BACK) / 4) {  // the window's bytes past the slice
    const int p = t < LROW_FRONT / 4 ? s0 - LROW_FRONT + 4 * t : s0 + S + 4 * (t - 1);
    unsigned w = 0u;  // a row's own ends: zero pads
    if (CL && p >= 0) {
      const int* g = bytes + off + p;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (p + k < len) w |= ((unsigned)__ldg(g + k) & 0xffu) << (8 * k);
    }
    s_bw[t < LROW_FRONT / 4 ? t : S / 4 + t] = w;
  }
  __syncthreads();
  LROW_STAMP(1);

  // ---- own positions: boundaries, word ends, local hashes ----------------
  // bit k of bmask: bnd at i0 + k (k <= 16); of emask: word end at i0 + k
  unsigned bmask = 0, emask = 0;
  unsigned x1 = 0, x2 = 0;          // local hashes: the maps from i0 applied to 0
  int e0 = -1;                      // first own word end
  unsigned fc1 = 0, fc2 = 0;        // local hashes there
  unsigned fa1 = 0, fa2 = 0;        // the maps' factors from i0 to e0
  HashMaps fwd = HashMaps::id();
  NextEnd rev = NextEnd::id();
  if (i0 < iend) {
    // the window: bytes at i0 - 4 .. i0 + 19, bit q of a mask for i0 - 4 + q
    const uint4 u = *reinterpret_cast<const uint4*>(s_bw + (i0 - s0) / 4);
    const uint2 u2 = *reinterpret_cast<const uint2*>(s_bw + (i0 - s0) / 4 + 4);
    const unsigned wv[6] = {u.x, u.y, u.z, u.w, u2.x, u2.y};
    unsigned m_l = 0, m_n = 0, m_sp = 0, m_ws = 0, m_apo = 0;  // ascii_cls, and '
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const unsigned w = wv[j], x = w & 0x7f7f7f7fu, ascii = ~w & 0x80808080u;
      const unsigned y = x | 0x20202020u;
      m_l |= nib4(ge4(y, 'a') & ~gt4(y, 'z') & ascii) << (4 * j);
      m_n |= nib4(ge4(x, '0') & ~gt4(x, '9') & ascii) << (4 * j);
      m_ws |= nib4(ge4(x, 9) & ~gt4(x, 13) & ascii) << (4 * j);
      m_sp |= nib4(eq4(w, ' ')) << (4 * j);
      m_apo |= nib4(eq4(w, '\'')) << (4 * j);
    }
    // contractions starting at q = 1 .. 19, visited only at apostrophes
    // after L, N, WS or at position 0: c3 're 've 'll, c2 's 't 'm 'd
    const unsigned char* s_b8 = reinterpret_cast<const unsigned char*>(s_bw);
    const unsigned at0 = i0 == 0 ? 1u << 4 : 0u;
    unsigned c2 = 0, c3 = 0;
    for (unsigned am = m_apo & 0x000ffffeu & (((m_l | m_n | m_ws) << 1) | at0); am;
         am &= am - 1) {
      const int q = __ffs(am) - 1;
      const unsigned b1 = s_b8[i0 - s0 + q + 1], b2 = s_b8[i0 - s0 + q + 2];
      const bool is3 = (b2 == 'e' && (b1 == 'r' || b1 == 'v')) || (b1 == 'l' && b2 == 'l');
      const bool is2 = b1 == 's' || b1 == 't' || b1 == 'm' || b1 == 'd';
      c3 |= is3 ? 1u << q : 0u;
      c2 |= (!is3 && is2) ? 1u << q : 0u;
    }
    // the boundary rule (bpe_encode.gpt2_boundaries), all positions at once
    const int lr = len - i0;
    const unsigned inlen = lr + 4 >= 32 ? ~0u : (lr + 4 <= 0 ? 0u : (1u << (lr + 4)) - 1u);
    const unsigned interior = ((c2 | c3) << 1) | (c3 << 2);
    const unsigned contr_end = (c2 << 2) | (c3 << 3);
    const unsigned m_w = m_sp | m_ws;
    const unsigned n_nonws = (inlen >> 1) & ~(m_w >> 1);
    const unsigned b_nonws = (m_ws << 1) | ((m_l << 1) & ~m_l) | ((m_n << 1) & ~m_n) |
                             (~((m_w | m_l | m_n) << 1) & (m_l | m_n));
    const unsigned b_ws = ~(m_w << 1) | n_nonws;
    const unsigned out = (m_w & b_ws) | (~m_w & b_nonws) | at0 | contr_end;
    bmask = ((out & ~interior & inlen) >> 4) & 0x1ffffu;
    // a word ends where the next position is a boundary or past the text
    emask = ((bmask >> 1) | (lr >= 1 && lr <= LROW_K ? 1u << (lr - 1) : 0u)) & 0xffffu;
#pragma unroll
    for (int k = 0; k < LROW_K; ++k) {  // the hash steps
      const bool bd = (bmask >> k) & 1u;
      const unsigned cb = ((wv[1 + k / 4] >> (8 * (k & 3))) & 0xffu) + 1u;
      x1 = bd ? cb : x1 * H1_MULT + cb;
      x2 = bd ? cb : x2 * H2_MULT + cb;
      if ((emask >> k) & 1u) {
        s_c1[k * nth + t] = x1;
        s_c2[k * nth + t] = x2;
      }
    }
    // the maps from i0 to the first end: a = M^(e0 + 1) if no boundary came first
    e0 = emask ? __ffs(emask) - 1 : -1;
    if (e0 >= 0) {
      fc1 = s_c1[e0 * nth + t];
      fc2 = s_c2[e0 * nth + t];
      if (!(bmask & ((2u << e0) - 1u))) {
        fa1 = mpow(H1_MULT, e0 + 1);
        fa2 = mpow(H2_MULT, e0 + 1);
      }
    }
    const bool seen = bmask & 0xffffu;  // a boundary among the own positions
    fwd = {seen ? 0u : mpow(H1_MULT, LROW_K), x1, seen ? 0u : mpow(H2_MULT, LROW_K), x2};
    const unsigned b16 = bmask & 0xffffu;
    rev.nb = b16 ? i0 + __ffs(b16) - 1 : BIG_POS;
    if (e0 >= 0) {
      rev.end = i0 + e0;
      rev.f = {fa1, fc1, fa2, fc2};
    } else {
      rev.f = fwd;
    }
  }

  // ---- one fused scan round: fwd becomes the maps of the row before i0,
  //      rev the first boundary and word end after i0 + LROW_K - 1 --------
  LROW_STAMP(2);
  if constexpr (CL) {
    __shared__ HashMaps c_f;
    __shared__ NextEnd c_b;
    cluster_scan_exclusive(fwd, rev, w_f, w_b, &c_f, &c_b, rank, n);
    cluster_arrive();  // no remote read after this
  } else {
    row_scan_exclusive(fwd, rev, w_f, w_b);
  }
  LROW_STAMP(3);

  // the hashes at i0 - 1 (fwd applied to 0), and from them the true hash at
  // this thread's first end (the one end whose word may start before i0),
  // at its last position, and at the first end after it
  const unsigned in1 = fwd.c1, in2 = fwd.c2;
  if (i0 < L && e0 >= 0) {
    s_c1[e0 * nth + t] = fa1 * in1 + fc1;
    s_c2[e0 * nth + t] = fa2 * in2 + fc2;
  }
  const bool seen = bmask & 0xffffu;
  const unsigned last1 = (seen ? 0u : mpow(H1_MULT, LROW_K)) * in1 + x1;
  const unsigned last2 = (seen ? 0u : mpow(H2_MULT, LROW_K)) * in2 + x2;
  const int tail_end = rev.end;
  const unsigned tail1 = rev.f.a1 * last1 + rev.f.c1;
  const unsigned tail2 = rev.f.a2 * last2 + rev.f.c2;
  const unsigned b16 = bmask & 0xffffu;

  // ---- outputs: a reverse walk carrying the next boundary and the nearest
  //      word end with its hashes; four positions to a store ---------------
  if (i0 < iend) {
    int nb = rev.nb, ep = tail_end;
    unsigned v1 = tail1, v2 = tail2;
#pragma unroll
    for (int g = LROW_K / 4 - 1; g >= 0; --g) {
      int on[4], o1[4], o2[4];
#pragma unroll
      for (int kk = 3; kk >= 0; --kk) {
        const int k = 4 * g + kk;
        const int i = i0 + k;
        on[kk] = nb;
        nb = (b16 >> k) & 1u ? i : nb;
        const bool end = (emask >> k) & 1u;
        const unsigned e1 = s_c1[k * nth + t], e2 = s_c2[k * nth + t];
        ep = end ? i : ep;
        v1 = end ? e1 : v1;
        v2 = end ? e2 : v2;
        const bool ok = ep - i <= HASH_REACH;  // ep >= i; BIG_POS is never ok
        o1[kk] = ok ? (int)v1 : 0;
        o2[kk] = ok ? (int)v2 : 0;
      }
      if (vec) {
        *reinterpret_cast<int4*>(nxt_o + off + i0 + 4 * g) = make_int4(on[0], on[1], on[2], on[3]);
        *reinterpret_cast<int4*>(h1_o + off + i0 + 4 * g) = make_int4(o1[0], o1[1], o1[2], o1[3]);
        *reinterpret_cast<int4*>(h2_o + off + i0 + 4 * g) = make_int4(o2[0], o2[1], o2[2], o2[3]);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          nxt_o[off + i0 + 4 * g + kk] = on[kk];
          h1_o[off + i0 + 4 * g + kk] = o1[kk];
          h2_o[off + i0 + 4 * g + kk] = o2[kk];
        }
      }
    }
    // bnd: four bits to four bytes by one multiply
    uint4 bb;
    bb.x = ((b16 & 0xfu) * 0x204081u) & 0x01010101u;
    bb.y = (((b16 >> 4) & 0xfu) * 0x204081u) & 0x01010101u;
    bb.z = (((b16 >> 8) & 0xfu) * 0x204081u) & 0x01010101u;
    bb.w = (((b16 >> 12) & 0xfu) * 0x204081u) & 0x01010101u;
    if (vec) {
      *reinterpret_cast<uint4*>(bnd_o + off + i0) = bb;
    } else {
#pragma unroll
      for (int k = 0; k < LROW_K; ++k) bnd_o[off + i0 + k] = (b16 >> k) & 1u;
    }
  }
#ifdef TT_LAYOUT_PHASES
  __syncthreads();
  LROW_STAMP(4);
#endif
  if constexpr (CL) cluster_wait();  // no CTA leaves while another reads it
}

extern "C" int tt_layout_row_max_l() { return LROW_MAX_L; }

extern "C" long long tt_layout_row_smem(int L) {
  return (long long)lrow_smem_bytes(L, lrow_threads(L));
}

// Allow the row kernel and the cluster kernel their dynamic shared memory
// at LROW_MAX_L, and the cluster kernel clusters of more than 8 CTAs, on
// the current device; needed once per device before the first launch.
extern "C" int tt_layout_row_init() {
  const int bytes = (int)lrow_smem_bytes(LROW_MAX_L, LROW_THREADS);
  cudaError_t st = cudaFuncSetAttribute(
      layout_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (st != cudaSuccess) return (int)st;
  st = cudaFuncSetAttribute(layout_kernel<true>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (st != cudaSuccess) return (int)st;
  return (int)cudaFuncSetAttribute(layout_kernel<true>,
                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Blocks of the row kernel resident on one SM at width L (0 on error).
extern "C" int tt_layout_row_blocks_per_sm(int L) {
  int n = 0;
  const int nth = lrow_threads(L);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, layout_kernel<false>, nth,
                                                    lrow_smem_bytes(L, nth)) != cudaSuccess)
    return 0;
  return n;
}

// vec: bytes, nxt, h1, h2 16-byte aligned (with L % 16 == 0, every row is)
extern "C" int tt_layout_row(void* bytes, void* lengths, void* bnd, void* nxt,
                             void* h1, void* h2, int B, int L, int vec,
                             void* stream) {
  if (L < 1 || L > LROW_MAX_L || L % LROW_K) return (int)cudaErrorInvalidValue;
  const int nth = lrow_threads(L);
  layout_kernel<false><<<B, nth, lrow_smem_bytes(L, nth), (cudaStream_t)stream>>>(
      (const int*)bytes, (const int*)lengths, (unsigned char*)bnd, (int*)nxt,
      (int*)h1, (int*)h2, L, L, vec);
  return (int)cudaGetLastError();
}

// ---- the cluster kernel ----------------------------------------------------

static bool wide_shape_ok(int L, int S, int n) {
  return L >= 1 && L <= LWIDE_MAX_L && n >= 1 && n <= LWIDE_MAX_N && S >= LROW_K &&
         S <= LROW_MAX_L && S % LROW_K == 0 && (n - 1) * S < L && L <= n * S;
}

static cudaLaunchConfig_t wide_config(int B, int S, int n, cudaLaunchAttribute* attr,
                                      void* stream) {
  cudaLaunchConfig_t cfg = {};
  const int nth = lrow_threads(S);
  cfg.gridDim = dim3((unsigned)(B * n), 1, 1);
  cfg.blockDim = dim3((unsigned)nth, 1, 1);
  cfg.dynamicSmemBytes = lrow_smem_bytes(S, nth);
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

extern "C" int tt_layout_wide_max_l() { return LWIDE_MAX_L; }
extern "C" int tt_layout_wide_max_n() { return LWIDE_MAX_N; }

// Clusters of n CTAs with slices of S that can be resident at once on the
// current device (cudaOccupancyMaxActiveClusters); minus the cudaError on
// failure.  Needs tt_layout_row_init first.
extern "C" int tt_layout_wide_max_clusters(int S, int n) {
  if (!wide_shape_ok((n - 1) * S + 1, S, n)) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wide_config(n, S, n, attr, nullptr);
  int num = 0;
  const cudaError_t st = cudaOccupancyMaxActiveClusters(&num, layout_kernel<true>, &cfg);
  return st == cudaSuccess ? num : -(int)st;
}

// Rows of L positions in slices of S, n CTAs a cluster ((n - 1) * S < L <=
// n * S, n <= LWIDE_MAX_N, S <= LROW_MAX_L, S % 16 == 0); vec as
// tt_layout_row, with S % 16 == 0 too.
extern "C" int tt_layout_wide(void* bytes, void* lengths, void* bnd, void* nxt,
                              void* h1, void* h2, int B, int L, int S, int n,
                              int vec, void* stream) {
  if (!wide_shape_ok(L, S, n) || L % LROW_K) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wide_config(B, S, n, attr, stream);
  const cudaError_t st = cudaLaunchKernelEx(
      &cfg, layout_kernel<true>, (const int*)bytes, (const int*)lengths,
      (unsigned char*)bnd, (int*)nxt, (int*)h1, (int*)h2, L, S, vec);
  if (st != cudaSuccess) return (int)st;
  return (int)cudaGetLastError();
}
