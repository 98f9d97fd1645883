// Suffix-array substring enumeration for the Unigram trainer's seeding;
// copy of the JAX package's `native/esaxx.cpp` (the reference's `esaxx`
// dependency, `models/unigram/trainer.rs:227-230`): a suffix array of the
// flattened corpus by SA-IS, LCP by Kasai, and the suffix tree's internal
// nodes as LCP intervals, each (substring offset, char length, count).
//
// Built with g++ at first use and called through ctypes
// (`tokenizers_tpu_torch/native/__init__.py`).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- SA-IS
// Suffix array by induced sorting over an integer alphabet.

typedef int32_t sa_t;

static void get_counts(const sa_t* s, sa_t* cnt, sa_t n, sa_t k) {
  std::memset(cnt, 0, sizeof(sa_t) * k);
  for (sa_t i = 0; i < n; ++i) ++cnt[s[i]];
}

static void get_buckets(const sa_t* cnt, sa_t* bkt, sa_t k, bool end) {
  sa_t sum = 0;
  for (sa_t i = 0; i < k; ++i) {
    sum += cnt[i];
    bkt[i] = end ? sum : sum - cnt[i];
  }
}

static void induce_sa(const sa_t* s, sa_t* sa, sa_t* cnt, sa_t* bkt, sa_t n,
                      sa_t k, const std::vector<bool>& ls) {
  // induce L-type
  get_counts(s, cnt, n, k);
  get_buckets(cnt, bkt, k, false);
  sa_t j = n - 1;
  if (j >= 0 && !ls[j]) sa[bkt[s[j]]++] = j;
  for (sa_t i = 0; i < n; ++i) {
    j = sa[i] - 1;
    if (sa[i] > 0 && j >= 0 && !ls[j]) sa[bkt[s[j]]++] = j;
  }
  // induce S-type
  get_counts(s, cnt, n, k);
  get_buckets(cnt, bkt, k, true);
  for (sa_t i = n - 1; i >= 0; --i) {
    j = sa[i] - 1;
    if (sa[i] > 0 && j >= 0 && ls[j]) sa[--bkt[s[j]]] = j;
  }
}

static void sais(const sa_t* s, sa_t* sa, sa_t n, sa_t k) {
  if (n == 0) return;
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  std::vector<bool> ls(n);
  ls[n - 1] = true;
  for (sa_t i = n - 2; i >= 0; --i)
    ls[i] = s[i] < s[i + 1] || (s[i] == s[i + 1] && ls[i + 1]);

  std::vector<sa_t> cnt(k), bkt(k);
  // place LMS suffixes
  for (sa_t i = 0; i < n; ++i) sa[i] = -1;
  get_counts(s, cnt.data(), n, k);
  get_buckets(cnt.data(), bkt.data(), k, true);
  for (sa_t i = n - 1; i >= 1; --i)
    if (ls[i] && !ls[i - 1]) sa[--bkt[s[i]]] = i;
  induce_sa(s, sa, cnt.data(), bkt.data(), n, k, ls);

  // compact LMS suffixes in sorted order
  sa_t n1 = 0;
  for (sa_t i = 0; i < n; ++i) {
    sa_t p = sa[i];
    if (p > 0 && ls[p] && !ls[p - 1]) sa[n1++] = p;
  }
  // name LMS substrings
  for (sa_t i = n1; i < n; ++i) sa[i] = -1;
  sa_t name = 0, prev = -1;
  for (sa_t i = 0; i < n1; ++i) {
    sa_t p = sa[i];
    bool diff = false;
    if (prev == -1) {
      diff = true;
    } else {
      // The caller appends a unique smallest sentinel, so comparisons
      // terminate before running off the end.
      for (sa_t d = 0;; ++d) {
        if (s[p + d] != s[prev + d]) {
          diff = true;
          break;
        }
        bool p_lms = p + d > 0 && ls[p + d] && !ls[p + d - 1];
        bool q_lms = prev + d > 0 && ls[prev + d] && !ls[prev + d - 1];
        if (d > 0 && (p_lms || q_lms)) {
          diff = !(p_lms && q_lms);
          break;
        }
      }
    }
    if (diff) {
      ++name;
      prev = p;
    }
    sa[n1 + (p >> 1)] = name - 1;
  }
  sa_t* s1 = sa + n - n1;
  for (sa_t i = n - 1, j2 = n - 1; i >= n1; --i)
    if (sa[i] >= 0) sa[j2--] = sa[i];

  if (name < n1) {
    sais(s1, sa, n1, name);
  } else {
    for (sa_t i = 0; i < n1; ++i) sa[s1[i]] = i;
  }
  // map back to LMS positions
  std::vector<sa_t> lms(n1);
  for (sa_t i = 0, j2 = 0; i < n; ++i)
    if (i > 0 && ls[i] && !ls[i - 1]) lms[j2++] = i;
  for (sa_t i = 0; i < n1; ++i) sa[i] = lms[sa[i]];

  // induce final SA from sorted LMS
  for (sa_t i = n1; i < n; ++i) sa[i] = -1;
  get_counts(s, cnt.data(), n, k);
  get_buckets(cnt.data(), bkt.data(), k, true);
  for (sa_t i = n1 - 1; i >= 0; --i) {
    sa_t j2 = sa[i];
    sa[i] = -1;
    sa[--bkt[s[j2]]] = j2;
  }
  induce_sa(s, sa, cnt.data(), bkt.data(), n, k, ls);
}

}  // namespace

extern "C" {

// Enumerate suffix-tree internal nodes of s[0..n) (int32 symbols >= 0).
// Writes up to `cap` tuples (offset, char_len, count); returns the number
// of nodes found (may exceed cap; caller checks).  Symbols must be < k.
int64_t esaxx_enumerate(const int32_t* s, int32_t n, int32_t k,
                        int32_t* out_off, int32_t* out_len, int32_t* out_cnt,
                        int64_t cap) {
  if (n <= 0) return 0;
  std::vector<sa_t> sa(n);
  sais(s, sa.data(), n, k);

  // Kasai LCP
  std::vector<sa_t> rank(n), lcp(n, 0);
  for (sa_t i = 0; i < n; ++i) rank[sa[i]] = i;
  sa_t h = 0;
  for (sa_t i = 0; i < n; ++i) {
    if (rank[i] > 0) {
      sa_t j = sa[rank[i] - 1];
      while (i + h < n && j + h < n && s[i + h] == s[j + h]) ++h;
      lcp[rank[i]] = h;
      if (h > 0) --h;
    } else {
      h = 0;
    }
  }

  // Enumerate LCP intervals (internal suffix-tree nodes): stack sweep.
  // Each interval (depth d, [l..r]) => substring s[sa[l]..sa[l]+d) occurs
  // (r - l + 1) times.
  int64_t count = 0;
  struct Item {
    sa_t lcp;
    sa_t left;
  };
  std::vector<Item> stack;
  stack.push_back({0, 0});
  for (sa_t i = 1; i <= n; ++i) {
    sa_t cur = (i < n) ? lcp[i] : 0;
    sa_t left = i - 1;
    while (!stack.empty() && cur < stack.back().lcp) {
      Item it = stack.back();
      stack.pop_back();
      // interval [it.left .. i-1] with string depth it.lcp
      if (it.lcp > 0) {
        if (count < cap) {
          out_off[count] = sa[it.left];
          out_len[count] = it.lcp;
          out_cnt[count] = i - it.left;
        }
        ++count;
      }
      left = it.left;
    }
    if (stack.empty() || cur > stack.back().lcp) {
      stack.push_back({cur, left});
    }
  }
  return count;
}
}
