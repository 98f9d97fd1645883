// Merge-round kernels of the byte-level BPE encode (kernels B1, B2, B4).
//
// Replaces, from tokenizers_tpu/ops/merge_pallas.py:
//   B2 tt_keys        <- keys_pallas (_keys_kernel): each position's next
//                        alive id within 2^k_steps, and both cuckoo slot
//                        hashes of (id, next id).
//   B1 tt_merge_round <- merge_round_fused (_apply_keys_kernel, with the
//                        merge-table row reads of _select_rows moved into
//                        the kernel): one safe-set merge round, then the
//                        next round's keys.
//   B4 tt_merge_round_standalone
//                     <- merge_round_pallas (_keys_kernel, the row reads
//                        of _select_rows, then _apply_kernel): one round
//                        that computes its own keys and carries none out.
// Plain versions: ops/merge_kernels.py (keys_plain, merge_round_fused_plain,
// merge_round_standalone_plain).  B1 and B4 share the round body
// (round_row); B4 computes the keys in its first pass and stops after the
// apply.
//
// Bound on an H100 (3.35 TB/s): B2 reads ids and writes h0, h1, nid, 16 B
// per position (4.9 MB, 1.4 us at the main path's unique buffer
// [74, 4096]); B1 reads ids, own_l, own_r, wid, h0, h1, nid and writes ids,
// own_l, own_r, h0, h1, nid and the bool f, 53 B per position (16 MB at
// [74, 4096]), plus each distinct merge-table row its keys hit, 32 B each.
// B4 reads ids, own_l, own_r, wid and writes ids, own_l, own_r and f, 29 B
// per position, plus the table rows as B1.  All are bound by bytes.  The
// two 32 B table-row reads per position hit the 50 MB L2.
//
// First design: one block of 1024 threads per row (words never cross rows,
// so rows are independent); the row is walked in 1024-wide tiles by a
// dozen passes, and every intermediate (neighbor indices, ranks, flags,
// scans) goes through a global scratch buffer the wrapper allocates, where
// it mostly stays in L2.  So the kernel moves several times its bound and
// [74, 4096] fills 74 of the 132 SMs; keeping the row in shared memory
// and splitting long rows over several blocks is later work.
//
// Semantics that must stay bit-equal to the JAX package:
//   * next/prev alive is searched only 2^k_steps positions away; beyond,
//     the value is 0 and "found" is false (so nid, h0, h1 carry the 0);
//   * a segment starts where wid differs from its left neighbor, and at
//     column 0; segmented sums and mins are unbounded;
//   * INF = 0x7FFFFFFF; tail safety clamps MCR to BIG = 0x3FFFFFF0 first;
//   * a hit in table 0 takes precedence over table 1;
//   * the hash is uint32 arithmetic; mask = rows.shape[0] - 1.
#include "scan.cuh"

#define INF_RANK 0x7fffffff
#define BIG_MCR 0x3ffffff0

// scratch slots, each [R, C] int32
enum {
  S_PRV = 0,   // last alive position <= i, or -1
  S_NXT,       // first alive position >= i, or BIG_POS
  S_R,         // looked-up rank, then INF where the pair is not valid
  S_NEWID,     // merged id of the looked-up row
  S_MCLN,      // MCL(new id)
  S_MCRN,      // MCR(new id)
  S_NMCR,      // MCR of the next alive token (0 if none within reach)
  S_FLAG1,     // valid / cand / seg bits
  S_FLAG2,     // run_start / tail / head_ok / tail_ok bits
  S_CANDSUM,   // inclusive prefix count of cand
  S_SEGSTART,  // last segment start <= i, or -1
  S_RUNSTART,  // last run start <= i, or -1
  S_TAIL,      // first tail >= i, or BIG_POS
  S_SEGEND,    // first segment end >= i
  S_SEGMIN,    // min rank from the segment start to i
  S_F,         // merged-head flag
  S_NXT2,      // first alive position >= i after the merges
  N_SCRATCH
};

enum { F_VALID = 1, F_CAND = 2, F_SEG = 4 };
enum { F_RUNSTART = 1, F_TAIL = 2, F_HEADOK = 4, F_TAILOK = 8 };

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

// first position >= i with a property, from its reverse-scan array; the
// "strictly after i within reach" form used by fill_next
__device__ __forceinline__ int next_within(const int* first_ge, int i, int C,
                                           int reach) {
  if (i + 1 >= C) return -1;
  const int j = first_ge[i + 1];
  return (j < C && j - i <= reach) ? j : -1;
}

__device__ __forceinline__ int prev_within(const int* last_le, int i,
                                           int reach) {
  if (i < 1) return -1;
  const int j = last_le[i - 1];
  return (j >= 0 && i - j <= reach) ? j : -1;
}

// Reverse min-scan of the alive positions of `ids` into first_ge.
__device__ void scan_next_alive(const int* ids, int* first_ge, int C, int* wt) {
  int carry = BIG_POS;
  const int nt = n_tiles(C);
  for (int t = 0; t < nt; ++t) {
    const int e = C - 1 - (t * NT + threadIdx.x);
    const int v = (e >= 0 && ids[e] >= 0) ? e : BIG_POS;
    const int s = block_scan(v, MinOp(), wt, carry);
    if (e >= 0) first_ge[e] = s;
  }
}

// Next round's keys from ids (all scratch/outputs of one row).
__device__ void emit_keys(const int* ids, int* first_ge, int* h0, int* h1,
                          int* nid, int C, int reach, unsigned seed,
                          unsigned mask, int* wt) {
  scan_next_alive(ids, first_ge, C, wt);
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += NT) {
    const int j = next_within(first_ge, i, C, reach);
    const int a = ids[i];
    const int n = j >= 0 ? ids[j] : 0;
    nid[i] = n;
    h0[i] = pair_hash(a, n, seed, mask, 0);
    h1[i] = pair_hash(a, n, seed, mask, 1);
  }
}

__global__ void __launch_bounds__(NT)
keys_kernel(const int* ids, int* h0, int* h1, int* nid, int* scratch, int C,
            int reach, unsigned seed, unsigned mask) {
  __shared__ int wt[32];
  const size_t off = (size_t)blockIdx.x * C;
  emit_keys(ids + off, scratch + off, h0 + off, h1 + off, nid + off, C, reach,
            seed, mask, wt);
}

// One safe-set merge round over one row (row pointers; S: the scratch
// planes of this row).  CARRIED: the pair keys (h0, h1, nid) come in from
// the previous round (B1); otherwise the round computes them from ids
// itself (B4) and h0_in, h1_in, nid_in are unused.
template <bool CARRIED>
__device__ __forceinline__ void round_row(
    const int* ids, const int* own_l, const int* own_r, const int* wid,
    const int* h0_in, const int* h1_in, const int* nid_in, const int* rows0,
    const int* rows1, int* ids_o, int* ol_o, int* or_o, unsigned char* f_o,
    int* const* S, int C, int reach, unsigned seed, unsigned mask, int* wti,
    long long* wtl) {
  const int nt = n_tiles(C);
  if (!CARRIED) {  // first alive >= i, needed for the keys in pass 1
    scan_next_alive(ids, S[S_NXT], C, wti);
    __syncthreads();
  }

  // ---- pass 1: pair keys; table rows at the keys; last alive <= i ------
  {
    int carry = -1;
    for (int t = 0; t < nt; ++t) {
      const int i = t * NT + threadIdx.x;
      int v = -1;
      if (i < C) {
        const int a = ids[i];
        int n, k0, k1;
        if (CARRIED) {
          n = nid_in[i];
          k0 = h0_in[i];
          k1 = h1_in[i];
        } else {
          const int j = next_within(S[S_NXT], i, C, reach);
          n = j >= 0 ? ids[j] : 0;
          k0 = pair_hash(a, n, seed, mask, 0);
          k1 = pair_hash(a, n, seed, mask, 1);
        }
        const int* r0 = rows0 + 8 * (size_t)k0;
        const int* r1 = rows1 + 8 * (size_t)k1;
        const bool hit0 = r0[0] == a && r0[1] == n;
        const bool hit1 = r1[0] == a && r1[1] == n;
        const int* r = hit0 ? r0 : r1;
        S[S_R][i] = (hit0 || hit1) ? r[2] : INF_RANK;
        S[S_NEWID][i] = r[3];
        S[S_MCLN][i] = r[4];
        S[S_MCRN][i] = r[5];
        if (a >= 0) v = i;
      }
      const int s = block_scan(v, MaxOp(), wti, carry);
      if (i < C) S[S_PRV][i] = s;
    }
  }
  // ---- pass 2: first alive >= i ---------------------------------------
  if (CARRIED) scan_next_alive(ids, S[S_NXT], C, wti);
  __syncthreads();

  // ---- pass 3: pair validity and rank ---------------------------------
  for (int i = threadIdx.x; i < C; i += NT) {
    const int a = ids[i];
    const int j = next_within(S[S_NXT], i, C, reach);
    const bool valid = a >= 0 && j >= 0 && wid[j] == wid[i];
    const int r = valid ? S[S_R][i] : INF_RANK;
    S[S_R][i] = r;
    S[S_NMCR][i] = j >= 0 ? own_r[j] : 0;
    const bool seg = i == 0 || wid[i] != wid[i - 1];
    S[S_FLAG1][i] = (valid ? F_VALID : 0) | ((valid && r < INF_RANK) ? F_CAND : 0) |
                    (seg ? F_SEG : 0);
  }
  __syncthreads();

  // ---- pass 4: run structure and head/tail safety ---------------------
  for (int i = threadIdx.x; i < C; i += NT) {
    const int fl = S[S_FLAG1][i];
    const bool cand = fl & F_CAND;
    const bool valid = fl & F_VALID;
    const int r = S[S_R][i];
    const int j = next_within(S[S_NXT], i, C, reach);
    const int nr = j >= 0 ? S[S_R][j] : 0;
    const bool nvalid = j >= 0 && (S[S_FLAG1][j] & F_VALID);
    const int nnmcr = j >= 0 ? S[S_NMCR][j] : 0;
    const int p = prev_within(S[S_PRV], i, reach);
    const bool pfound = p >= 0;
    const int pr = pfound ? S[S_R][p] : 0;
    const int pw = pfound ? wid[p] : 0;
    const int pmcl = pfound ? own_l[p] : 0;
    const bool prev_in_word = pfound && pw == wid[i];
    const bool same_run_prev = cand && prev_in_word && pr == r;
    const bool run_start = cand && !same_run_prev;
    const bool has_next_pair = valid && j >= 0 && nvalid;
    const bool same_run_next = cand && has_next_pair && nr == r;
    const bool tail = cand && !same_run_next;
    const bool head_ok = run_start && (!prev_in_word || (r < pr && r <= pmcl));
    const int nn = nnmcr < BIG_MCR ? nnmcr : BIG_MCR;
    const bool tail_ok = tail && r < nr && (!has_next_pair || r <= nn + 1);
    S[S_FLAG2][i] = (run_start ? F_RUNSTART : 0) | (tail ? F_TAIL : 0) |
                    (head_ok ? F_HEADOK : 0) | (tail_ok ? F_TAILOK : 0);
  }
  __syncthreads();

  // ---- pass 5: forward scans ------------------------------------------
  {
    int c_sum = 0, c_seg = -1, c_run = -1;
    long long c_min = -1;  // identity of max over the non-negative keys
    for (int t = 0; t < nt; ++t) {
      const int i = t * NT + threadIdx.x;
      const bool in = i < C;
      const int fl = in ? S[S_FLAG1][i] : 0;
      const int fl2 = in ? S[S_FLAG2][i] : 0;
      const int cs = block_scan((fl & F_CAND) ? 1 : 0, AddOp(), wti, c_sum);
      const int ss = block_scan((in && (fl & F_SEG)) ? i : -1, MaxOp(), wti, c_seg);
      const int rs = block_scan((fl2 & F_RUNSTART) ? i : -1, MaxOp(), wti, c_run);
      // segmented min as one max-scan: (segment ordinal, ~rank)
      const unsigned r = in ? (unsigned)S[S_R][i] : 0xffffffffu;
      const long long key =
          in ? (((long long)(ss + 1) << 32) | (long long)(0xffffffffu - r)) : -1;
      const long long mk = block_scan(key, MaxOp(), wtl, c_min);
      if (in) {
        S[S_CANDSUM][i] = cs;
        S[S_SEGSTART][i] = ss;
        S[S_RUNSTART][i] = rs;
        S[S_SEGMIN][i] = (int)(0xffffffffu - (unsigned)(mk & 0xffffffffLL));
      }
    }
  }
  // ---- pass 6: reverse scans ------------------------------------------
  {
    int c_tail = BIG_POS, c_end = BIG_POS;
    for (int t = 0; t < nt; ++t) {
      const int e = C - 1 - (t * NT + threadIdx.x);
      const bool in = e >= 0;
      const bool tail = in && (S[S_FLAG2][e] & F_TAIL);
      const bool send = in && (e == C - 1 || wid[e + 1] != wid[e]);
      const int tt = block_scan(tail ? e : BIG_POS, MinOp(), wti, c_tail);
      const int se = block_scan(send ? e : BIG_POS, MinOp(), wti, c_end);
      if (in) {
        S[S_TAIL][e] = tt;
        S[S_SEGEND][e] = se;
      }
    }
  }
  __syncthreads();

  // ---- pass 7: parity, word min, the merge set ------------------------
  for (int i = threadIdx.x; i < C; i += NT) {
    const bool cand = S[S_FLAG1][i] & F_CAND;
    bool f = false;
    if (cand) {
      const int* P = S[S_CANDSUM];
      const int ss = S[S_SEGSTART][i];
      const int q = P[i] - (ss >= 1 ? P[ss - 1] : 0);
      const int rs = S[S_RUNSTART][i];
      int q_head = 0, hl = 0;
      if (rs >= 0) {
        const int ss2 = S[S_SEGSTART][rs];
        q_head = P[rs] - (ss2 >= 1 ? P[ss2 - 1] : 0);
        hl = (S[S_FLAG2][rs] & F_HEADOK) ? 1 : 0;
      }
      const int tp = S[S_TAIL][i];
      const int tl = (tp < C && (S[S_FLAG2][tp] & F_TAILOK)) ? 1 : 0;
      const int wmin = S[S_SEGMIN][S[S_SEGEND][i]];
      const int r = S[S_R][i];
      const bool parity_odd = ((q - q_head) & 1) == 0;
      f = parity_odd && (r == wmin || (hl == 1 && tl == 1));
    }
    S[S_F][i] = f ? 1 : 0;
  }
  __syncthreads();

  // ---- pass 8: apply: left member takes the merge, right member dies --
  for (int i = threadIdx.x; i < C; i += NT) {
    const int a = ids[i];
    const bool f = S[S_F][i];
    const int p = prev_within(S[S_PRV], i, reach);
    const bool kill = a >= 0 && p >= 0 && S[S_F][p] == 1;
    ids_o[i] = kill ? -1 : (f ? S[S_NEWID][i] : a);
    ol_o[i] = f ? S[S_MCLN][i] : own_l[i];
    or_o[i] = f ? S[S_MCRN][i] : own_r[i];
    f_o[i] = f ? 1 : 0;
  }
}

// B1: the round from carried keys, then the next round's keys.
__global__ void __launch_bounds__(NT)
merge_round_kernel(const int* ids_g, const int* ol_g, const int* or_g,
                   const int* wid_g, const int* h0_g, const int* h1_g,
                   const int* nid_g, const int* rows0, const int* rows1,
                   int* ids_o, int* ol_o, int* or_o, unsigned char* f_o, int* h0_o,
                   int* h1_o, int* nid_o, int* scratch, int R, int C, int reach,
                   unsigned seed, unsigned mask) {
  __shared__ int wti[32];
  __shared__ long long wtl[32];
  const size_t off = (size_t)blockIdx.x * C;
  const size_t plane = (size_t)R * C;
  int* S[N_SCRATCH];
#pragma unroll
  for (int k = 0; k < N_SCRATCH; ++k) S[k] = scratch + k * plane + off;
  round_row<true>(ids_g + off, ol_g + off, or_g + off, wid_g + off, h0_g + off,
                  h1_g + off, nid_g + off, rows0, rows1, ids_o + off, ol_o + off,
                  or_o + off, f_o + off, S, C, reach, seed, mask, wti, wtl);
  __syncthreads();

  // ---- passes 9-10: the next round's keys -----------------------------
  emit_keys(ids_o + off, S[S_NXT2], h0_o + off, h1_o + off, nid_o + off, C,
            reach, seed, mask, wti);
}

// B4: one standalone round, its keys computed in the kernel.
__global__ void __launch_bounds__(NT)
merge_round_standalone_kernel(const int* ids_g, const int* ol_g,
                              const int* or_g, const int* wid_g,
                              const int* rows0, const int* rows1, int* ids_o,
                              int* ol_o, int* or_o, unsigned char* f_o,
                              int* scratch, int R, int C, int reach,
                              unsigned seed, unsigned mask) {
  __shared__ int wti[32];
  __shared__ long long wtl[32];
  const size_t off = (size_t)blockIdx.x * C;
  const size_t plane = (size_t)R * C;
  int* S[N_SCRATCH];
#pragma unroll
  for (int k = 0; k < N_SCRATCH; ++k) S[k] = scratch + k * plane + off;
  round_row<false>(ids_g + off, ol_g + off, or_g + off, wid_g + off, nullptr,
                   nullptr, nullptr, rows0, rows1, ids_o + off, ol_o + off,
                   or_o + off, f_o + off, S, C, reach, seed, mask, wti, wtl);
}

extern "C" int tt_n_scratch_merge_round() { return N_SCRATCH; }

extern "C" int tt_keys(void* ids, void* h0, void* h1, void* nid,
                       void* scratch, int R, int C, int reach, unsigned seed,
                       unsigned mask, void* stream) {
  keys_kernel<<<R, NT, 0, (cudaStream_t)stream>>>(
      (const int*)ids, (int*)h0, (int*)h1, (int*)nid, (int*)scratch, C, reach,
      seed, mask);
  return (int)cudaGetLastError();
}

extern "C" int tt_merge_round(void* ids, void* own_l, void* own_r, void* wid,
                              void* h0, void* h1, void* nid, void* rows0,
                              void* rows1, void* ids_o, void* ol_o, void* or_o,
                              void* f_o, void* h0_o, void* h1_o, void* nid_o,
                              void* scratch, int R, int C, int reach,
                              unsigned seed, unsigned mask, void* stream) {
  merge_round_kernel<<<R, NT, 0, (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)own_l, (const int*)own_r, (const int*)wid,
      (const int*)h0, (const int*)h1, (const int*)nid, (const int*)rows0,
      (const int*)rows1, (int*)ids_o, (int*)ol_o, (int*)or_o, (unsigned char*)f_o,
      (int*)h0_o, (int*)h1_o, (int*)nid_o, (int*)scratch, R, C, reach, seed,
      mask);
  return (int)cudaGetLastError();
}

extern "C" int tt_merge_round_standalone(void* ids, void* own_l, void* own_r,
                                         void* wid, void* rows0, void* rows1,
                                         void* ids_o, void* ol_o, void* or_o,
                                         void* f_o, void* scratch, int R, int C,
                                         int reach, unsigned seed,
                                         unsigned mask, void* stream) {
  merge_round_standalone_kernel<<<R, NT, 0, (cudaStream_t)stream>>>(
      (const int*)ids, (const int*)own_l, (const int*)own_r, (const int*)wid,
      (const int*)rows0, (const int*)rows1, (int*)ids_o, (int*)ol_o,
      (int*)or_o, (unsigned char*)f_o, (int*)scratch, R, C, reach, seed, mask);
  return (int)cudaGetLastError();
}
