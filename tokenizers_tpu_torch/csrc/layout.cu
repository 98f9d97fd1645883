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
// First design: one block of 1024 threads per row, walking the row in
// 1024-wide tiles: a forward pass computes boundaries (each thread reads
// the few neighbor bytes it needs) and scans both hashes as one affine
// scan; a reverse pass scans next-boundary and next-word-end positions;
// a last pass delivers the hashes.  The raw hashes and word-end positions
// go through a global scratch buffer, so it moves about twice its bound
// in bytes; the eight sequential tiles per row, each with block-wide
// barriers, keep it well above that in time (PERF.md has the numbers).
#include "scan.cuh"

enum { CLS_O = 0, CLS_L = 1, CLS_N = 2, CLS_SP = 3, CLS_WS = 4, CLS_END = 5 };
#define H1_MULT 0x01000193u
#define H2_MULT 0x0000C597u
#define HASH_REACH 512

struct Row {
  const int* b;
  int L;
  int len;
  __device__ __forceinline__ int byte(int i) const {
    return (i >= 0 && i < L && i < len) ? b[i] : 0;
  }
  __device__ __forceinline__ int cls(int i) const {  // bpe_encode.ascii_cls
    const int c = byte(i);
    const int cl = c | 32;
    if (cl >= 97 && cl <= 122) return CLS_L;
    if (c >= 48 && c <= 57) return CLS_N;
    if (c == 32) return CLS_SP;
    if (c >= 9 && c <= 13) return CLS_WS;
    return CLS_O;
  }
  __device__ __forceinline__ int prev_cls(int i) const {
    return i == 0 ? CLS_END : cls(i - 1);
  }
  // contraction starting at i: 0 none, 2 two bytes ('s 't 'm 'd), 3 three
  __device__ __forceinline__ int contr(int i) const {
    if (i < 0 || i >= L || i >= len || byte(i) != 0x27) return 0;
    const int pc = prev_cls(i);
    const bool p_ok = i == 0 || pc == CLS_L || pc == CLS_N || pc == CLS_WS;
    if (!p_ok) return 0;
    const int b1 = byte(i + 1), b2 = byte(i + 2);
    const bool is3 = ((b1 == 'r' && b2 == 'e') || (b1 == 'v' && b2 == 'e') ||
                      (b1 == 'l' && b2 == 'l')) &&
                     i + 2 < len;
    const bool is2 =
        (b1 == 's' || b1 == 't' || b1 == 'm' || b1 == 'd') && i + 1 < len;
    return is3 ? 3 : (is2 ? 2 : 0);
  }
  __device__ __forceinline__ bool bnd(int i) const {
    if (i < 0 || i >= L || i >= len) return false;
    const int c = cls(i), pc = prev_cls(i);
    const bool next_exists = i + 1 < len;
    const int nc = next_exists ? cls(i + 1) : CLS_END;
    const int c1 = contr(i - 1), c2 = contr(i - 2), c3 = contr(i - 3);
    const bool interior = c1 != 0 || c2 == 3;
    const bool contr_end = c2 == 2 || c3 == 3;
    const bool c_ws = c == CLS_SP || c == CLS_WS;
    const bool p_ws = pc == CLS_SP || pc == CLS_WS;
    const bool n_nonws = next_exists && nc != CLS_SP && nc != CLS_WS;
    bool b_nonws;
    if (pc == CLS_SP) b_nonws = false;
    else if (pc == CLS_WS) b_nonws = true;
    else if (pc == CLS_L) b_nonws = c != CLS_L;
    else if (pc == CLS_N) b_nonws = c != CLS_N;
    else b_nonws = c == CLS_L || c == CLS_N;
    const bool b_ws = p_ws ? n_nonws : true;
    bool out = c_ws ? b_ws : b_nonws;
    out = out || i == 0 || contr_end;
    return out && !interior;
  }
};

__global__ void __launch_bounds__(NT)
layout_kernel(const int* bytes, const int* lengths, unsigned char* bnd_o, int* nxt_o,
              int* h1_o, int* h2_o, int* scratch, int B, int L) {
  __shared__ int wti[32];
  __shared__ Aff2 wta[32];
  const size_t off = (size_t)blockIdx.x * L;
  const size_t plane = (size_t)B * L;
  Row row{bytes + off, L, lengths[blockIdx.x]};
  int* H1 = scratch + off;
  int* H2 = scratch + plane + off;
  int* END = scratch + 2 * plane + off;
  const int nt = n_tiles(L);

  // ---- forward: boundaries and both rolling hashes ---------------------
  {
    Aff2 carry{1u, 0u, 1u, 0u};
    for (int t = 0; t < nt; ++t) {
      const int i = t * NT + threadIdx.x;
      Aff2 x{1u, 0u, 1u, 0u};
      if (i < L) {
        const bool b = row.bnd(i);
        const unsigned c = (unsigned)row.byte(i) + 1u;
        x.a1 = b ? 0u : H1_MULT;
        x.a2 = b ? 0u : H2_MULT;
        x.c1 = c;
        x.c2 = c;
        bnd_o[off + i] = b ? 1 : 0;
      }
      const Aff2 h = block_scan(x, AffOp(), wta, carry);
      if (i < L) {
        H1[i] = (int)h.c1;
        H2[i] = (int)h.c2;
      }
    }
  }
  // ---- reverse: next boundary, next word end ---------------------------
  {
    int c_b = BIG_POS, c_e = BIG_POS;
    for (int t = 0; t < nt; ++t) {
      const int e = L - 1 - (t * NT + threadIdx.x);
      bool isb = false, is_end = false;
      if (e >= 0) {
        isb = row.bnd(e);
        const bool inb = e < row.len;
        const bool nxt_in = e + 1 < L && e + 1 < row.len;
        is_end = inb && (row.bnd(e + 1) || !nxt_in);
      }
      const int nb = block_scan(isb ? e : BIG_POS, MinOp(), wti, c_b);
      const int ne = block_scan(is_end ? e : BIG_POS, MinOp(), wti, c_e);
      if (e >= 0) {
        // nxt is the first boundary strictly after the position: the scan
        // value at e is what position e - 1 reports
        if (e >= 1) nxt_o[off + e - 1] = nb;
        if (e == L - 1) nxt_o[off + e] = BIG_POS;
        END[e] = ne;
      }
    }
  }
  __syncthreads();

  // ---- deliver the hashes from each word's end ------------------------
  for (int i = threadIdx.x; i < L; i += NT) {
    const int j = END[i];
    const bool ok = j < L && j - i <= HASH_REACH;
    h1_o[off + i] = ok ? H1[j] : 0;
    h2_o[off + i] = ok ? H2[j] : 0;
  }
}

extern "C" int tt_n_scratch_layout() { return 3; }

extern "C" int tt_layout(void* bytes, void* lengths, void* bnd, void* nxt,
                         void* h1, void* h2, void* scratch, int B, int L,
                         void* stream) {
  layout_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      (const int*)bytes, (const int*)lengths, (unsigned char*)bnd, (int*)nxt, (int*)h1,
      (int*)h2, (int*)scratch, B, L);
  return (int)cudaGetLastError();
}
