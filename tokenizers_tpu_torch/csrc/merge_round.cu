// Merge-round kernels of the byte-level BPE encode (kernels B1, B2, B4).
//
// Replaces, from tokenizers_tpu/ops/merge_pallas.py:
//   B2 tt_keys        <- keys_pallas (_keys_kernel): each position's next
//                        alive id within 2^k_steps, and both cuckoo slot
//                        hashes of (id, next id).
//   B1 <- merge_round_fused (_apply_keys_kernel, with the merge-table row
//         reads of _select_rows moved into the kernel): one safe-set merge
//         round, then the next round's keys.  Two kernels from one body,
//         chosen by row width: tt_merge_round_row for C <= ROW_MAX_C = 4096
//         (every launch of the dedup branch), tt_merge_round for wider
//         rows (the full-width branch: C up to 65,536), the row split over
//         a thread-block cluster.
//   B4 <- merge_round_pallas (_keys_kernel, the row reads of _select_rows,
//         then _apply_kernel): one round that computes its own keys and
//         carries none out.  B1's two kernels with the keys computed in the
//         kernel (merge_round_kernel<CL, false>), launched by the same
//         entries, tt_merge_round_row and tt_merge_round, with carry 0.
// Plain versions: ops/merge_kernels.py (keys_plain, merge_round_fused_plain,
// merge_round_standalone_plain).
//
// Bound on an H100 (3.35 TB/s): B2 reads ids and writes h0, h1, nid, 16 B
// per position (4.9 MB, 1.4 us at the main path's unique buffer
// [74, 4096]); B1 reads ids, own_l, own_r, wid, h0, h1, nid and writes ids,
// own_l, own_r, h0, h1, nid and the bool f, 53 B per position (16 MB at
// [74, 4096]), plus the merge-table rows the round must read, 32 B each:
// table 0's row of each pair inside one word, table 1's where table 0 does
// not hold the pair, each distinct row once (tools/timing.table_bytes; 4.8
// us there on gpt2's tables).  B4 reads ids, own_l, own_r, wid and writes
// ids, own_l, own_r and f, 29 B per position, plus the table rows as B1.
// All are bound by bytes.  The table-row reads mostly hit L1 and L2.
//
// B4 is B1's body without carried keys (CARRY false): it reads no h0, h1
// or nid and writes none.  Round (a) already finds each position's next
// alive position within reach; B4 keeps the ids in shared memory (in s_q,
// dead until round (b)), takes the id there, hashes the pair and reads the
// two table rows after round (a) instead of before it, and skips round (c)
// and its barrier; it reads the table rows only for pairs inside one word.
// Both widths as B1: the row kernel for C <= 4096, the cluster kernel up to
// 65,536; 64 registers, no spills in either (ptxas).  Measured on an H100
// (tools/wide_ab.py, the parent's kernel in the same call): 0.0176 ms at
// the llama-3 unique buffer [74, 4096] (6.6x a bound of 0.00266), 0.0167
// at [8, 8192] and 0.0493 at [32, 16384], against 0.041, 0.075 and 0.165
// for the first design it replaced, which walked the row in 1024-wide
// tiles with 16 global scratch planes and 32 block scans of three
// __syncthreads each at C = 4096.  The phase that holds the row kernel
// (tools/b1_phases.py --standalone) is round (b)'s flags and scan, as in
// B1; the table-row reads after barrier 1 come second.
//
// B2 (keys_kernel, below) reads only a bounded window: tiles of 1024
// positions and the 512 after them, no scan and no scratch.
//
// The row B1 (tt_merge_round_row, below) keeps the row on the SM: thread t
// owns ROW_K = 4 contiguous positions in registers, what neighbors read
// lives in shared memory, and the round's scans are three fused scan rounds
// (a sequential walk over the thread's positions, a warp-shuffle scan, one
// cross-warp step) with six __syncthreads in all; no global scratch.  1024
// threads at C = 4096, 64 registers, no spills (ptxas); dynamic shared
// memory row_smem_bytes(C) = 184,344 B at C = 4096, plus 1,152 B static, so
// one block per SM (74 rows fill 74 of 132 SMs).  Measured on an H100 at
// [74, 4096]: about 0.021 ms, 4.3x the bound.  What holds it there is the
// one SM a row runs on: its L2 traffic (about one 32 B sector a cycle: the
// arrays, the table rows of every alive position, the stores) and its
// instruction issue; the phase times come from tools/b1_phases.py (built
// with -DTT_ROW_PHASES).
//
// The wide B1 (tt_merge_round) is that body over a thread-block
// cluster: CTA r of n holds the slice [r * S, (r + 1) * S) of a row in its
// shared memory (S a power of two, 512-4096 positions; the wrapper picks S
// and n from (R, C) so that the clusters fill the card where the rows
// allow it).  Reads of another position go to the CTA that holds it,
// through distributed shared memory: the bounded ones (next and previous
// alive within 2^k_steps, the segment edges) reach at most the neighbour,
// the unbounded ones (the run start, the first tail, the segment end of a
// word that spans slices) any rank.  The three scan rounds carry across the
// slices through scan.cuh's cluster_scan_exclusive, and the three
// __syncthreads between them become cluster barriers.  No global scratch.
// At C = 65,536 a cluster is 16 CTAs of 4096 (non-portable): the wrapper
// asks cudaOccupancyMaxActiveClusters first and raises where it is 0.
// Measured on an H100: about 0.019 ms at [8, 8192] (slices of 1024)
// against 0.085 for the tiled kernel it replaced, 18x a bound of 0.0011;
// 0.057 at [32, 16384] (slices of 2048) against 0.194, 6.8x a bound of
// 0.0083.  What holds it (tools/b1_phases.py --wide): a CTA's cycles per
// position are twice the row kernel's, the phases that end at a cluster
// barrier or read other slices longest (the reads' rank test, the wait for
// the cluster's slowest CTA); and at [32, 16384] the card holds 30
// clusters of 8 at once, so 2 of the 32 rows run in a second wave.
//
// Semantics that must stay bit-equal to the JAX package:
//   * next/prev alive is searched only 2^k_steps positions away; beyond,
//     the value is 0 and "found" is false (so nid, h0, h1 carry the 0);
//   * a segment starts where wid differs from its left neighbor, and at
//     column 0; segmented sums and mins are unbounded;
//   * INF = 0x7FFFFFFF; tail safety clamps MCR to BIG = 0x3FFFFFF0 first;
//   * a hit in table 0 takes precedence over table 1;
//   * the hash is uint32 arithmetic; mask = rows.shape[0] - 1.
#include <type_traits>

#include "scan.cuh"

#define INF_RANK 0x7fffffff
#define BIG_MCR 0x3ffffff0

__device__ __forceinline__ int pair_hash(int a, int b, unsigned seed,
                                         unsigned mask, int which) {
  const unsigned c1 = which == 0 ? 0x9E3779B1u : 0x85EBCA77u;
  const unsigned c2 = which == 0 ? 0x85EBCA77u : 0xC2B2AE3Du;
  unsigned h = (unsigned)a * c1 + (unsigned)b * c2 + seed;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return (int)(h & mask);
}

// ---- B2: the keys in bounded windows -------------------------------------
//
// nid[i] is the id at the first alive position in (i, i + reach], so a
// block needs only its tile of KEYS_P positions and the KEYS_HALO after it:
// no scan.  It loads them into shared memory (int4, KEYS_K positions a
// thread), builds an alive bitmap (each thread's KEYS_K bits, eight lanes
// to a 32-bit word by three shuffles), and after one __syncthreads finds
// the next alive after each thread's run with __ffs over at most
// reach / 32 + 1 words.
// 256 threads a block: at [74, 4096] 296 blocks, all resident at once on
// 132 SMs.  A reach above KEYS_HALO is refused (cudaErrorInvalidValue).
// Measured on an H100 at [74, 4096]: about 0.0038 ms against 0.0059 for
// the row scan it replaced, 2.6x its bound; an empty kernel among
// back-to-back launches takes about 0.0018 ms of that.

#define KEYS_P 1024
#define KEYS_HALO 512  // the widest reach the kernel takes (2^FILL_K)
#define KEYS_K 4
#define KEYS_THREADS (KEYS_P / KEYS_K)
#define KEYS_W (KEYS_P + KEYS_HALO)

// vec: C % 4 == 0 and ids, h0, h1, nid 16-byte aligned
__global__ void __launch_bounds__(KEYS_THREADS)
keys_kernel(const int* __restrict__ ids, int* h0, int* h1, int* nid, int C,
            int tiles, int reach, unsigned seed, unsigned mask, int vec) {
  __shared__ __align__(16) int s_ids[KEYS_W];
  __shared__ unsigned s_bits[KEYS_W / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const size_t off = (size_t)(blockIdx.x / tiles) * C;
  const int c0 = (blockIdx.x % tiles) * KEYS_P;

  // ---- the tile and its halo, dead (-1) past the row's end: both loads
  //      issued before either is used --------------------------------------
  int4 x[KEYS_W / KEYS_P + 1];
#pragma unroll
  for (int q = 0; q * KEYS_P < KEYS_W; ++q) {
    const int l0 = KEYS_K * t + q * KEYS_P;
    if (l0 >= KEYS_W) break;  // the halo: the first KEYS_HALO / KEYS_K threads
    const int i = c0 + l0;
    if (vec && i < C) {  // C % 4 == 0: the whole int4 is in the row
      x[q] = __ldg(reinterpret_cast<const int4*>(ids + off + i));
    } else {
      x[q].x = i < C ? __ldg(ids + off + i) : -1;
      x[q].y = i + 1 < C ? __ldg(ids + off + i + 1) : -1;
      x[q].z = i + 2 < C ? __ldg(ids + off + i + 2) : -1;
      x[q].w = i + 3 < C ? __ldg(ids + off + i + 3) : -1;
    }
  }
#pragma unroll
  for (int q = 0; q * KEYS_P < KEYS_W; ++q) {
    const int l0 = KEYS_K * t + q * KEYS_P;
    if (l0 >= KEYS_W) break;  // whole warps: KEYS_HALO / KEYS_K % 32 == 0
    *reinterpret_cast<int4*>(s_ids + l0) = x[q];
    unsigned w = ((x[q].x >= 0 ? 1u : 0u) | (x[q].y >= 0 ? 2u : 0u) |
                  (x[q].z >= 0 ? 4u : 0u) | (x[q].w >= 0 ? 8u : 0u))
                 << (KEYS_K * (lane & 7));
    w |= __shfl_xor_sync(FULL_MASK, w, 1);
    w |= __shfl_xor_sync(FULL_MASK, w, 2);
    w |= __shfl_xor_sync(FULL_MASK, w, 4);
    if ((lane & 7) == 0) s_bits[l0 / 32] = w;
  }
  __syncthreads();

  // ---- each position's next alive id within reach; the slot hashes ------
  const int l0 = KEYS_K * t;
  const int4 a4 = *reinterpret_cast<const int4*>(s_ids + l0);
  const int a[KEYS_K] = {a4.x, a4.y, a4.z, a4.w};
  // the first alive after the thread's run, within the reach of its last
  // position; each position takes the next alive of its own run or that
  // one, if within its reach
  int j;
  {
    const int s0 = l0 + KEYS_K, s1 = l0 + KEYS_K - 1 + reach;  // search [s0, s1]
    int w = s0 >> 5;
    unsigned bits = s_bits[w] & (FULL_MASK << (s0 & 31));
    while (!bits && (w + 1) * 32 <= s1) bits = s_bits[++w];
    j = bits ? w * 32 + __ffs(bits) - 1 : BIG_POS;
    j = j <= s1 ? j : BIG_POS;
  }
  int n[KEYS_K];
#pragma unroll
  for (int k = KEYS_K - 1; k >= 0; --k) {
    n[k] = j - (l0 + k) <= reach ? s_ids[j] : 0;
    if (a[k] >= 0) j = l0 + k;
  }
  const int i = c0 + l0;
  if (i >= C) return;
  int r0[KEYS_K], r1[KEYS_K];
#pragma unroll
  for (int k = 0; k < KEYS_K; ++k) {
    r0[k] = pair_hash(a[k], n[k], seed, mask, 0);
    r1[k] = pair_hash(a[k], n[k], seed, mask, 1);
  }
  if (vec) {
    *reinterpret_cast<int4*>(nid + off + i) = make_int4(n[0], n[1], n[2], n[3]);
    *reinterpret_cast<int4*>(h0 + off + i) = make_int4(r0[0], r0[1], r0[2], r0[3]);
    *reinterpret_cast<int4*>(h1 + off + i) = make_int4(r1[0], r1[1], r1[2], r1[3]);
  } else {
#pragma unroll
    for (int k = 0; k < KEYS_K; ++k) {
      if (i + k >= C) break;
      nid[off + i + k] = n[k];
      h0[off + i + k] = r0[k];
      h1[off + i + k] = r1[k];
    }
  }
}

// ---- B1 for rows of up to ROW_MAX_C positions: the row stays on the SM --
//
// Thread t owns positions [t*ROW_K, t*ROW_K + ROW_K).  Its ids, neighbor
// indices and flags stay in registers; what other positions read goes to
// shared memory.  Arrays indexed by position use the padded index sp(i),
// so the k-th positions of a warp's threads fall in 32 distinct banks;
// arrays only the owner reads are striped (k * blockDim.x + t).  Three
// fused scan rounds: (a) last alive <= i and first alive >= i; (b) the
// segmented candidate count, segment min and last run start forward, with
// the first tail and first segment end in reverse; (c) first alive >= i
// after the merges.  Six __syncthreads in all.  The wide kernel (CL) is
// the same body over a cluster's slices, six cluster barriers in place of
// the __syncthreads.  B4 (CARRY false) computes its keys after round (a)
// and has no round (c): five barriers.

#define ROW_K 4  // positions a thread owns
#define ROW_MAX_C 4096
#define ROW_THREADS (ROW_MAX_C / ROW_K)
#define WIDE_MAX_C 65536  // the widest chunk engine_base makes: MAX_L / 2
#define WIDE_MAX_N 16     // CTAs a cluster of the wide kernel may have
#define WIDE_MIN_S 512    // its slices: powers of two, 512 .. ROW_MAX_C

#ifdef TT_ROW_PHASES
// Phase-timing build (tools/b1_phases.py): thread 0 of each of the first
// ROW_TIMED blocks stamps the SM clock at the start, after each barrier and
// at the end, and the global timer at the start and the end.  B4 stamps 6
// after its stores (thread 0's, no barrier) in place of round (c).
#define ROW_TIMED 256
#define ROW_STAMPS 8
// per block: the SM clock at each stamp, then the global timer (ns) at the
// first and the last
__device__ long long tt_row_stamps[ROW_TIMED * (ROW_STAMPS + 2)];
#define ROW_STAMP(n)                                                            \
  do {                                                                          \
    if (threadIdx.x == 0 && blockIdx.x < ROW_TIMED) {                           \
      long long* st = tt_row_stamps + blockIdx.x * (ROW_STAMPS + 2);            \
      st[n] = clock64();                                                        \
      if ((n) == 0 || (n) == ROW_STAMPS - 1) st[ROW_STAMPS + ((n) != 0)] = global_ns(); \
    }                                                                           \
  } while (0)
extern "C" int tt_row_stamps_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, tt_row_stamps, sizeof(tt_row_stamps));
}
#else
#define ROW_STAMP(n) \
  do {               \
  } while (0)
#endif

enum { R_VALID = 1, R_CAND = 2, R_SEG = 4, R_SEND = 8, R_RUNSTART = 16,
       R_TAIL = 32, R_F = 64 };

struct SegRun {  // forward scan of round (b)
  int seg;  // 1 if the span holds a segment start
  int cnt;  // candidates since the span's last segment start (all, if none)
  int mn;   // min rank since then
  int rs;   // last run start of the span, or -1
  __device__ static SegRun id() { return {0, 0, INF_RANK, -1}; }
  __device__ static SegRun op(SegRun a, SegRun b) {
    return {a.seg | b.seg, b.seg ? b.cnt : a.cnt + b.cnt,
            b.seg ? b.mn : (a.mn < b.mn ? a.mn : b.mn), a.rs > b.rs ? a.rs : b.rs};
  }
  template <class G>
  __device__ SegRun xfer(G g) const { return {g(seg), g(cnt), g(mn), g(rs)}; }
};

struct TailEnd {  // reverse scan of round (b): first tail, first segment end
  int tail, end;
  __device__ static TailEnd id() { return {BIG_POS, BIG_POS}; }
  __device__ static TailEnd op(TailEnd a, TailEnd b) {
    return {a.tail < b.tail ? a.tail : b.tail, a.end < b.end ? a.end : b.end};
  }
  template <class G>
  __device__ TailEnd xfer(G g) const { return {g(tail), g(end)}; }
};

__device__ __forceinline__ int sp(int i) { return i + i / ROW_K; }

// the prev (low 16 bits) and next (high) alive position within reach of
// position i, as distances from i (0: none; a reach is at most C - 1 <
// 2^16, the wrappers clamp it)
__device__ __forceinline__ unsigned pack_pj(int i, int p, int j) {
  return ((unsigned)(j >= 0 ? j - i : 0) << 16) | (unsigned)(p >= 0 ? i - p : 0);
}
__device__ __forceinline__ int prev_of(int i, unsigned pj) {
  const int d = (int)(pj & 0xffffu);
  return d ? i - d : -1;
}
__device__ __forceinline__ int next_of(int i, unsigned pj) {
  const int d = (int)(pj >> 16);
  return d ? i + d : -1;
}

// this thread's ROW_K positions of one row; `vec`: C % 8 == 0 and the row
// is 16-byte aligned, so a thread's run is ROW_K / 4 aligned int4
__device__ __forceinline__ void load_run(const int* __restrict__ g, int i0, int C,
                                         bool vec, int (&x)[ROW_K], int fill) {
  if (vec && i0 < C) {
#pragma unroll
    for (int v = 0; v < ROW_K / 4; ++v) {
      const int4 u = __ldg(reinterpret_cast<const int4*>(g + i0 + 4 * v));
      x[4 * v] = u.x; x[4 * v + 1] = u.y; x[4 * v + 2] = u.z; x[4 * v + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ROW_K; ++k) x[k] = i0 + k < C ? __ldg(g + i0 + k) : fill;
  }
}

__device__ __forceinline__ void store_run(int* g, int i0, int C, bool vec,
                                          const int (&x)[ROW_K]) {
  if (vec && i0 < C) {
#pragma unroll
    for (int v = 0; v < ROW_K / 4; ++v)
      *reinterpret_cast<int4*>(g + i0 + 4 * v) =
          make_int4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < ROW_K; ++k)
      if (i0 + k < C) g[i0 + k] = x[k];
  }
}

// fields 0-5 of a merge-table row (key a, key b, rank, new id, MCL, MCR)
__device__ __forceinline__ void read_row(const int* __restrict__ r, bool vec,
                                         int4& p, int2& q) {
  if (vec) {
    p = __ldg(reinterpret_cast<const int4*>(r));
    q = __ldg(reinterpret_cast<const int2*>(r + 4));
  } else {
    p = make_int4(__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3));
    q = make_int2(__ldg(r + 4), __ldg(r + 5));
  }
}

// bytes of dynamic shared memory for a row of C positions and nth threads:
// six padded int arrays, three striped ones and three byte arrays
__host__ __device__ __forceinline__ size_t row_smem_bytes(int C, int nth) {
  const size_t cp = (size_t)C + C / ROW_K + 1;
  return (6 * cp + 3 * (size_t)nth * ROW_K) * 4 + 3 * (size_t)C;
}

__host__ __device__ __forceinline__ int row_threads(int C) {
  return ((C + ROW_K - 1) / ROW_K + 31) / 32 * 32;
}

// CL false: one block per row, S = C.  CL true: cluster rank r of n holds
// the slice [r * S, min(C, (r + 1) * S)) of row blockIdx.x / n, S = 2^lg_s.
// Positions are the row's throughout; shared arrays are indexed from the
// slice's start.  CARRY true: B1, the keys read from h0_g, h1_g, nid_g and
// the next round's written to h0_o, h1_o, nid_o; false: B4, those six null.
template <bool CL, bool CARRY>
__global__ void __launch_bounds__(ROW_THREADS, 1)
merge_round_kernel(const int* __restrict__ ids_g, const int* __restrict__ ol_g,
                   const int* __restrict__ or_g, const int* __restrict__ wid_g,
                   const int* __restrict__ h0_g, const int* __restrict__ h1_g,
                   const int* __restrict__ nid_g, const int* __restrict__ rows0,
                   const int* __restrict__ rows1, int* ids_o, int* ol_o,
                   int* or_o, unsigned char* f_o, int* h0_o, int* h1_o,
                   int* nid_o, int C, int S, int lg_s, int reach, unsigned seed,
                   unsigned mask, int vec_flags) {
  extern __shared__ __align__(16) int smem[];
  const int cp = S + S / ROW_K + 1;
  const int nth = blockDim.x;
  int* s_wid = smem;               // wid; the ids after the round from (c)
  int* s_ol = s_wid + cp;          // own_l
  int* s_or = s_ol + cp;           // own_r
  int* s_r = s_or + cp;            // looked-up rank, then INF where not valid
  int* s_nmcr = s_r + cp;          // MCR of the next alive; segment-min prefix from (b)
  int* s_q = s_nmcr + cp;          // segmented candidate count; B4: the ids until (b)
  int* s_newid = s_q + cp;         // striped: the hit row's new id, MCL, MCR
  int* s_mcln = s_newid + nth * ROW_K;
  int* s_mcrn = s_mcln + nth * ROW_K;
  unsigned char* s_valid = reinterpret_cast<unsigned char*>(s_mcrn + nth * ROW_K);
  unsigned char* s_ht = s_valid + S;  // bit 0 head_ok, bit 1 tail_ok
  unsigned char* s_f = s_ht + S;
  int* s_smin = s_nmcr;
  int* s_ids2 = s_wid;
  __shared__ LastPos wa_f[32];
  __shared__ FirstPos wa_b[32];
  __shared__ SegRun wb_f[32];
  __shared__ TailEnd wb_b[32];
  __shared__ NoScan wc_f[32];
  __shared__ FirstPos wc_b[32];

  ROW_STAMP(0);
  int rank = 0, n = 1;
  if constexpr (CL) {
    rank = cluster_rank();
    n = cluster_size();
  }
  const bool vec = vec_flags & 1;
  const bool tvec = vec_flags & 2;
  const size_t off = (size_t)(CL ? blockIdx.x / n : blockIdx.x) * C;
  const int s0 = rank * S;          // this block's positions: [s0, cend)
  const int cend = min(C, s0 + S);
  const int t = threadIdx.x;
  const int l0 = t * ROW_K;         // in the slice
  const int i0 = s0 + l0;           // in the row
  // a padded array (rd) or a byte array (rd8) at row position q, from the
  // block that holds it; in a cluster without a branch, so that a thread's
  // reads, local or remote, are all in flight at once
  auto rd = [&](const int* arr, int q) -> int {
    if constexpr (CL) {
      const int r = q >> lg_s;
      const int* p = arr + sp(q - (r << lg_s));
      return *(r == rank ? p : at_rank(p, r));
    }
    return arr[sp(q - s0)];
  };
  auto rd8 = [&](const unsigned char* arr, int q) -> int {
    if constexpr (CL) {
      const int r = q >> lg_s;
      const unsigned char* p = arr + (q - (r << lg_s));
      return *(r == rank ? p : at_rank(p, r));
    }
    return arr[q - s0];
  };
  // barriers 2, 4 and 5: the block's, or the cluster's
  auto barrier = []() {
    if constexpr (CL) cluster_sync_all();
    else __syncthreads();
  };

  // the merge-table rows of this thread's pairs (a[k], nid[k]) at the slot
  // hashes h0, h1: the rank where a table holds the pair (table 0 first),
  // else INF_RANK, into s_r; the new id, MCL and MCR, striped.  Only the
  // pairs of bit k of `live` are read: the others are never valid.
  int a[ROW_K];
  auto lookup = [&](const int(&h0)[ROW_K], const int(&h1)[ROW_K], const int(&nid)[ROW_K],
                    unsigned live) {
#pragma unroll
    for (int k = 0; k < ROW_K; ++k) {
      if (i0 + k >= cend) continue;
      int r = INF_RANK;
      if ((live >> k) & 1) {
        int4 p0, p1;
        int2 q0, q1;
        read_row(rows0 + 8 * (size_t)h0[k], tvec, p0, q0);
        read_row(rows1 + 8 * (size_t)h1[k], tvec, p1, q1);
        const bool hit0 = p0.x == a[k] && p0.y == nid[k];
        const bool hit1 = p1.x == a[k] && p1.y == nid[k];
        r = hit0 ? p0.z : (hit1 ? p1.z : INF_RANK);
        s_newid[k * nth + t] = hit0 ? p0.w : p1.w;
        s_mcln[k * nth + t] = hit0 ? q0.x : q1.x;
        s_mcrn[k * nth + t] = hit0 ? q0.y : q1.y;
      }
      s_r[sp(l0 + k)] = r;
    }
  };

  // ---- load; B1: the merge-table rows at the carried keys --------------
  {
    int x[ROW_K];
    load_run(wid_g + off, i0, C, vec, x, -1);
#pragma unroll
    for (int k = 0; k < ROW_K; ++k)
      if (i0 + k < cend) s_wid[sp(l0 + k)] = x[k];
    load_run(ol_g + off, i0, C, vec, x, 0);
#pragma unroll
    for (int k = 0; k < ROW_K; ++k)
      if (i0 + k < cend) s_ol[sp(l0 + k)] = x[k];
    load_run(or_g + off, i0, C, vec, x, 0);
#pragma unroll
    for (int k = 0; k < ROW_K; ++k)
      if (i0 + k < cend) s_or[sp(l0 + k)] = x[k];
  }
  load_run(ids_g + off, i0, C, vec, a, -1);
  if constexpr (CARRY) {
    int h0[ROW_K], h1[ROW_K], nid[ROW_K];
    load_run(h0_g + off, i0, C, vec, h0, 0);
    load_run(h1_g + off, i0, C, vec, h1, 0);
    load_run(nid_g + off, i0, C, vec, nid, 0);
    unsigned alive = 0;  // a dead position's pair is never valid
#pragma unroll
    for (int k = 0; k < ROW_K; ++k) alive |= (a[k] >= 0 ? 1u : 0u) << k;
    lookup(h0, h1, nid, alive);
  } else {  // B4: the ids where other threads (and CTAs) read the next id
#pragma unroll
    for (int k = 0; k < ROW_K; ++k)
      if (i0 + k < cend) s_q[sp(l0 + k)] = a[k];
  }

  // ---- round (a): prev and next alive within reach ---------------------
  unsigned pj[ROW_K];
  {
    LastPos fa = LastPos::id();
    FirstPos ba = FirstPos::id();
#pragma unroll
    for (int k = 0; k < ROW_K; ++k)
      if (a[k] >= 0) {
        fa.p = i0 + k;
        if (ba.p == BIG_POS) ba.p = i0 + k;
      }
    if constexpr (CL) {  // barrier 1
      __shared__ LastPos ca_f;
      __shared__ FirstPos ca_b;
      cluster_scan_exclusive(fa, ba, wa_f, wa_b, &ca_f, &ca_b, rank, n);
    } else {
      row_scan_exclusive(fa, ba, wa_f, wa_b);
    }
    ROW_STAMP(1);
    int p[ROW_K];
    int carry = fa.p;
#pragma unroll
    for (int k = 0; k < ROW_K; ++k) {
      const int i = i0 + k;
      p[k] = (carry >= 0 && i - carry <= reach) ? carry : -1;
      if (a[k] >= 0) carry = i;
    }
    carry = ba.p;
#pragma unroll
    for (int k = ROW_K - 1; k >= 0; --k) {
      const int i = i0 + k;
      const int j = (carry < C && carry - i <= reach) ? carry : -1;
      pj[k] = pack_pj(i, p[k], j);
      if (a[k] >= 0) carry = i;
    }
  }
  if constexpr (!CARRY) {  // B4: the keys of this round, then the table rows
    int h0[ROW_K], h1[ROW_K], nid[ROW_K];
    unsigned valid = 0;  // the rows of pairs within one word only
#pragma unroll
    for (int k = 0; k < ROW_K; ++k) {
      const int j = next_of(i0 + k, pj[k]);
      nid[k] = j >= 0 ? rd(s_q, j) : 0;
      h0[k] = pair_hash(a[k], nid[k], seed, mask, 0);
      h1[k] = pair_hash(a[k], nid[k], seed, mask, 1);
      valid |= (a[k] >= 0 && j >= 0 && rd(s_wid, j) == s_wid[sp(l0 + k)] ? 1u : 0u) << k;
    }
    lookup(h0, h1, nid, valid);
  }

  // ---- pair validity and rank; MCR of the next alive -------------------
  int fl[ROW_K];
#pragma unroll
  for (int k = 0; k < ROW_K; ++k) {
    const int i = i0 + k;
    fl[k] = 0;
    if (i >= cend) continue;
    const int j = next_of(i, pj[k]);
    const bool valid = a[k] >= 0 && j >= 0 && rd(s_wid, j) == s_wid[sp(l0 + k)];
    const int r = valid ? s_r[sp(l0 + k)] : INF_RANK;
    s_r[sp(l0 + k)] = r;
    s_nmcr[sp(l0 + k)] = j >= 0 ? rd(s_or, j) : 0;
    s_valid[l0 + k] = valid;
    fl[k] = (valid ? R_VALID : 0) | ((valid && r < INF_RANK) ? R_CAND : 0);
  }
  barrier();  // barrier 2
  ROW_STAMP(2);

  // ---- run structure, head/tail safety, segment edges ------------------
  int rk[ROW_K];
#pragma unroll
  for (int k = 0; k < ROW_K; ++k) {
    const int i = i0 + k;
    rk[k] = INF_RANK;
    if (i >= cend) continue;
    const int r = s_r[sp(l0 + k)];
    const int wi = s_wid[sp(l0 + k)];
    const bool valid = fl[k] & R_VALID;
    const bool cand = fl[k] & R_CAND;
    const int j = next_of(i, pj[k]);
    const int p = prev_of(i, pj[k]);
    const int nr = j >= 0 ? rd(s_r, j) : 0;
    const bool nvalid = j >= 0 && rd8(s_valid, j);
    const int nnmcr = j >= 0 ? rd(s_nmcr, j) : 0;
    const bool pfound = p >= 0;
    const int pr = pfound ? rd(s_r, p) : 0;
    const int pmcl = pfound ? rd(s_ol, p) : 0;
    const bool prev_in_word = pfound && rd(s_wid, p) == wi;
    const bool same_run_prev = cand && prev_in_word && pr == r;
    const bool run_start = cand && !same_run_prev;
    const bool has_next_pair = valid && j >= 0 && nvalid;
    const bool same_run_next = cand && has_next_pair && nr == r;
    const bool tail = cand && !same_run_next;
    const bool head_ok = run_start && (!prev_in_word || (r < pr && r <= pmcl));
    const int nn = nnmcr < BIG_MCR ? nnmcr : BIG_MCR;
    const bool tail_ok = tail && r < nr && (!has_next_pair || r <= nn + 1);
    s_ht[l0 + k] = (head_ok ? 1 : 0) | (tail_ok ? 2 : 0);
    const bool seg = i == 0 || rd(s_wid, i - 1) != wi;
    const bool send = i == C - 1 || rd(s_wid, i + 1) != wi;
    fl[k] |= (seg ? R_SEG : 0) | (send ? R_SEND : 0) |
             (run_start ? R_RUNSTART : 0) | (tail ? R_TAIL : 0);
    rk[k] = r;
  }

  // ---- round (b): segmented count and min, run start; first tail and
  //      first segment end ---------------------------------------------
  // te: the first tail (TE_NONE if none) in the low half, the first segment
  // end in the high half; 16 bits each in a row of at most ROW_MAX_C
  typedef typename std::conditional<CL, unsigned long long, unsigned>::type TE;
  constexpr int TE_BITS = CL ? 32 : 16;
  constexpr TE TE_NONE = CL ? 0xffffffffull : 0xffffu;
  int rs[ROW_K];
  TE te[ROW_K];
  {
    SegRun fb = SegRun::id();
    TailEnd bb = TailEnd::id();
#define SEGRUN_AT(k)                                                        \
  SegRun{(fl[k] & R_SEG) ? 1 : 0, (fl[k] & R_CAND) ? 1 : 0, rk[k],          \
         (fl[k] & R_RUNSTART) ? i0 + (k) : -1}
#define TAILEND_AT(k)                                                       \
  TailEnd{(fl[k] & R_TAIL) ? i0 + (k) : BIG_POS,                            \
          (fl[k] & R_SEND) ? i0 + (k) : BIG_POS}
#pragma unroll
    for (int k = 0; k < ROW_K; ++k)
      if (i0 + k < cend) fb = SegRun::op(fb, SEGRUN_AT(k));
#pragma unroll
    for (int k = ROW_K - 1; k >= 0; --k)
      if (i0 + k < cend) bb = TailEnd::op(bb, TAILEND_AT(k));
    if constexpr (CL) {  // barrier 3
      __shared__ SegRun cb_f;
      __shared__ TailEnd cb_b;
      cluster_scan_exclusive(fb, bb, wb_f, wb_b, &cb_f, &cb_b, rank, n);
    } else {
      row_scan_exclusive(fb, bb, wb_f, wb_b);
    }
    ROW_STAMP(3);
#pragma unroll
    for (int k = 0; k < ROW_K; ++k) {
      rs[k] = -1;
      if (i0 + k >= cend) continue;
      fb = SegRun::op(fb, SEGRUN_AT(k));
      s_q[sp(l0 + k)] = fb.cnt;
      s_smin[sp(l0 + k)] = fb.mn;
      rs[k] = fb.rs;
    }
#pragma unroll
    for (int k = ROW_K - 1; k >= 0; --k) {
      te[k] = 0;
      if (i0 + k >= cend) continue;
      bb = TailEnd::op(bb, TAILEND_AT(k));
      te[k] = (bb.tail < C ? (TE)bb.tail : TE_NONE) | ((TE)bb.end << TE_BITS);
    }
#undef SEGRUN_AT
#undef TAILEND_AT
  }
  barrier();  // barrier 4
  ROW_STAMP(4);

  // ---- parity, word min: the merge set ---------------------------------
#pragma unroll
  for (int k = 0; k < ROW_K; ++k) {
    if (i0 + k >= cend) continue;
    if (fl[k] & R_CAND) {
      const int q = s_q[sp(l0 + k)];
      int q_head = 0, hl = 0;
      if (rs[k] >= 0) {
        q_head = rd(s_q, rs[k]);
        hl = rd8(s_ht, rs[k]) & 1;
      }
      const TE tp = te[k] & TE_NONE;
      const int tl = tp < (TE)C ? (rd8(s_ht, (int)tp) >> 1) & 1 : 0;
      const int wmin = rd(s_smin, (int)(te[k] >> TE_BITS));
      const bool parity_odd = ((q - q_head) & 1) == 0;
      if (parity_odd && (rk[k] == wmin || (hl == 1 && tl == 1))) fl[k] |= R_F;
    }
    s_f[l0 + k] = (fl[k] & R_F) ? 1 : 0;
  }
  barrier();  // barrier 5
  ROW_STAMP(5);

  // ---- apply: the left member takes the merge, the right member dies ---
  {
    int ol2[ROW_K], or2[ROW_K];
#pragma unroll
    for (int k = 0; k < ROW_K; ++k) {
      const int i = i0 + k;
      ol2[k] = or2[k] = 0;
      if (i >= cend) continue;
      const bool f = fl[k] & R_F;
      const int p = prev_of(i, pj[k]);
      const bool kill = a[k] >= 0 && p >= 0 && rd8(s_f, p);
      a[k] = kill ? -1 : (f ? s_newid[k * nth + t] : a[k]);
      ol2[k] = f ? s_mcln[k * nth + t] : s_ol[sp(l0 + k)];
      or2[k] = f ? s_mcrn[k * nth + t] : s_or[sp(l0 + k)];
      if constexpr (CARRY) s_ids2[sp(l0 + k)] = a[k];
    }
    store_run(ids_o + off, i0, C, vec, a);
    store_run(ol_o + off, i0, C, vec, ol2);
    store_run(or_o + off, i0, C, vec, or2);
    if (vec && i0 < C) {
#pragma unroll
      for (int v = 0; v < ROW_K / 4; ++v) {
        unsigned w = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) w |= (unsigned)((fl[4 * v + k] & R_F) ? 1 : 0) << (8 * k);
        reinterpret_cast<unsigned*>(f_o + off + i0)[v] = w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < ROW_K; ++k)
        if (i0 + k < C) f_o[off + i0 + k] = (fl[k] & R_F) ? 1 : 0;
    }
  }

  // ---- round (c): the next round's keys (B1 only) ----------------------
  if constexpr (!CARRY) {
    if constexpr (CL) cluster_arrive();  // no remote read after this
    ROW_STAMP(6);
  } else {
    NoScan fc;
    FirstPos bc = FirstPos::id();
#pragma unroll
    for (int k = ROW_K - 1; k >= 0; --k)
      if (a[k] >= 0) bc.p = i0 + k;
    if constexpr (CL) {  // barrier 6
      __shared__ NoScan cc_f;
      __shared__ FirstPos cc_b;
      cluster_scan_exclusive(fc, bc, wc_f, wc_b, &cc_f, &cc_b, rank, n);
    } else {
      row_scan_exclusive(fc, bc, wc_f, wc_b);
    }
    ROW_STAMP(6);
    int nx[ROW_K];
    int carry = bc.p;
#pragma unroll
    for (int k = ROW_K - 1; k >= 0; --k) {
      const int i = i0 + k;
      const int j = (carry < C && carry - i <= reach) ? carry : -1;
      nx[k] = j >= 0 ? rd(s_ids2, j) : 0;
      if (a[k] >= 0) carry = i;
    }
    if constexpr (CL) cluster_arrive();  // no remote read after this
    int h[ROW_K];
    store_run(nid_o + off, i0, C, vec, nx);
#pragma unroll
    for (int k = 0; k < ROW_K; ++k) h[k] = pair_hash(a[k], nx[k], seed, mask, 0);
    store_run(h0_o + off, i0, C, vec, h);
#pragma unroll
    for (int k = 0; k < ROW_K; ++k) h[k] = pair_hash(a[k], nx[k], seed, mask, 1);
    store_run(h1_o + off, i0, C, vec, h);
  }
#ifdef TT_ROW_PHASES
  __syncthreads();
  ROW_STAMP(7);
#endif
  if constexpr (CL) cluster_wait();  // no CTA leaves while another reads it
}

extern "C" int tt_merge_round_row_max_c() { return ROW_MAX_C; }

// dynamic shared memory of the row kernel at width C, or of the wide
// kernel at slice C
extern "C" long long tt_merge_round_row_smem(int C) {
  return (long long)row_smem_bytes(C, row_threads(C));
}

typedef decltype(&merge_round_kernel<false, true>) RoundKernel;

// the row (cl false) or cluster kernel of B1 (carry true) or B4
static RoundKernel round_kernel(bool cl, bool carry) {
  if (cl) return carry ? merge_round_kernel<true, true> : merge_round_kernel<true, false>;
  return carry ? merge_round_kernel<false, true> : merge_round_kernel<false, false>;
}

// Allow the four kernels of B1 and B4 their dynamic shared memory at
// ROW_MAX_C, and the cluster ones clusters of more than 8 CTAs, on the
// current device; needed once per device before the first launch.
extern "C" int tt_merge_round_row_init() {
  const int bytes = (int)row_smem_bytes(ROW_MAX_C, ROW_THREADS);
  for (int cl = 0; cl < 2; ++cl)
    for (int carry = 0; carry < 2; ++carry) {
      const RoundKernel k = round_kernel(cl, carry);
      cudaError_t st =
          cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (st == cudaSuccess && cl)
        st = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (st != cudaSuccess) return (int)st;
    }
  return 0;
}

// vec: C % 4 == 0 and ids, h0, h1, nid 16-byte aligned
extern "C" int tt_keys(void* ids, void* h0, void* h1, void* nid, int R, int C,
                       int reach, unsigned seed, unsigned mask, int vec,
                       void* stream) {
  if (reach < 1 || reach > KEYS_HALO || C < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (C + KEYS_P - 1) / KEYS_P;
  keys_kernel<<<R * tiles, KEYS_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)ids, (int*)h0, (int*)h1, (int*)nid, C, tiles, reach, seed,
      mask, vec);
  return (int)cudaGetLastError();
}

// B1 (carry 1: h0, h1, nid read, h0_o, h1_o, nid_o written) or B4 (carry
// 0: those six null); any other mix is refused.
static bool keys_agree(int carry, const void* h0, const void* h1, const void* nid,
                       const void* h0_o, const void* h1_o, const void* nid_o) {
  const bool all = h0 && h1 && nid && h0_o && h1_o && nid_o;
  const bool none = !h0 && !h1 && !nid && !h0_o && !h1_o && !nid_o;
  return carry == 1 ? all : (carry == 0 && none);
}

// The row kernel of B1 or B4 (carry, as keys_agree).  vec_flags: bit 0,
// C % 8 == 0 and the row arrays 16-byte aligned (f_o 8-byte); bit 1, the
// tables 16-byte aligned.
extern "C" int tt_merge_round_row(void* ids, void* own_l, void* own_r, void* wid,
                                  void* h0, void* h1, void* nid, void* rows0,
                                  void* rows1, void* ids_o, void* ol_o,
                                  void* or_o, void* f_o, void* h0_o, void* h1_o,
                                  void* nid_o, int R, int C, int reach,
                                  unsigned seed, unsigned mask, int vec_flags,
                                  int carry, void* stream) {
  if (C < 1 || C > ROW_MAX_C || reach < 1 ||
      !keys_agree(carry, h0, h1, nid, h0_o, h1_o, nid_o))
    return (int)cudaErrorInvalidValue;
  const int nth = row_threads(C);
  const RoundKernel k = round_kernel(false, carry);
  k<<<R, nth, row_smem_bytes(C, nth), (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)own_l, (const int*)own_r, (const int*)wid,
      (const int*)h0, (const int*)h1, (const int*)nid, (const int*)rows0,
      (const int*)rows1, (int*)ids_o, (int*)ol_o, (int*)or_o, (unsigned char*)f_o,
      (int*)h0_o, (int*)h1_o, (int*)nid_o, C, C, 0, min(reach, C), seed, mask,
      vec_flags);
  return (int)cudaGetLastError();
}

// ---- the cluster kernels: the row kernels' body over a cluster -------------

static int wide_lg(int S) {  // log2 of a valid slice, else -1
  if (S < WIDE_MIN_S || S > ROW_MAX_C || (S & (S - 1))) return -1;
  int lg = 0;
  while ((1 << lg) < S) ++lg;
  return lg;
}

static bool wide_shape_ok(int C, int S, int n) {
  return wide_lg(S) >= 0 && n >= 1 && n <= WIDE_MAX_N && C >= 1 &&
         C <= WIDE_MAX_C && (n - 1) * S < C && C <= n * S;
}

static cudaLaunchConfig_t wide_config(int R, int S, int n, cudaLaunchAttribute* attr,
                                      void* stream) {
  cudaLaunchConfig_t cfg = {};
  const int nth = row_threads(S);
  cfg.gridDim = dim3((unsigned)(R * n), 1, 1);
  cfg.blockDim = dim3((unsigned)nth, 1, 1);
  cfg.dynamicSmemBytes = row_smem_bytes(S, nth);
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

extern "C" int tt_merge_round_max_c() { return WIDE_MAX_C; }
extern "C" int tt_merge_round_max_n() { return WIDE_MAX_N; }
extern "C" int tt_merge_round_min_s() { return WIDE_MIN_S; }

static int max_clusters(RoundKernel k, int S, int n) {
  if (!wide_shape_ok((n - 1) * S + 1, S, n)) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wide_config(n, S, n, attr, nullptr);
  int num = 0;
  const cudaError_t st = cudaOccupancyMaxActiveClusters(&num, k, &cfg);
  return st == cudaSuccess ? num : -(int)st;
}

// Clusters of n CTAs with slices of S of B1's (carry 1) or B4's (carry 0)
// cluster kernel that can be resident at once on the current device
// (cudaOccupancyMaxActiveClusters); minus the cudaError on failure.  Needs
// tt_merge_round_row_init first.
extern "C" int tt_merge_round_max_clusters(int S, int n, int carry) {
  if (carry != 0 && carry != 1) return -(int)cudaErrorInvalidValue;
  return max_clusters(round_kernel(true, carry), S, n);
}

// Rows of C positions in slices of S (a power of two, WIDE_MIN_S ..
// ROW_MAX_C), n CTAs a cluster ((n - 1) * S < C <= n * S, n <= WIDE_MAX_N);
// carry and vec_flags as tt_merge_round_row.
extern "C" int tt_merge_round(void* ids, void* own_l, void* own_r, void* wid,
                                   void* h0, void* h1, void* nid, void* rows0,
                                   void* rows1, void* ids_o, void* ol_o,
                                   void* or_o, void* f_o, void* h0_o, void* h1_o,
                                   void* nid_o, int R, int C, int S, int n,
                                   int reach, unsigned seed, unsigned mask,
                                   int vec_flags, int carry, void* stream) {
  if (!wide_shape_ok(C, S, n) || reach < 1 ||
      !keys_agree(carry, h0, h1, nid, h0_o, h1_o, nid_o))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wide_config(R, S, n, attr, stream);
  const cudaError_t st = cudaLaunchKernelEx(
      &cfg, round_kernel(true, carry), (const int*)ids, (const int*)own_l,
      (const int*)own_r, (const int*)wid, (const int*)h0, (const int*)h1,
      (const int*)nid, (const int*)rows0, (const int*)rows1, (int*)ids_o,
      (int*)ol_o, (int*)or_o, (unsigned char*)f_o, (int*)h0_o, (int*)h1_o,
      (int*)nid_o, C, S, wide_lg(S), min(reach, C), seed, mask, vec_flags);
  if (st != cudaSuccess) return (int)st;
  return (int)cudaGetLastError();
}
