"""Added tokens: user-added and special tokens matched before the model;
port of `tokenizers_tpu.added_vocabulary` (reference
`tokenizer/added_vocabulary.rs`).

Two leftmost-longest matchers: one over the tokens matched on the raw
text (`normalized=False`, special tokens by default), one over the
others, whose patterns are their contents through the tokenizer's
normalizer and which are matched on the normalized text of the pieces
between the first matcher's hits.  Ids are allocated above the model's
vocab (a content the model has keeps its id).  A match is kept or
widened as its token says: `single_word` drops it unless word
boundaries (or the text's ends) lie on both sides, `lstrip` and
`rstrip` take in the whitespace before and after it; with
`encode_special_tokens` the special tokens are not matched at all.

Word chars are the rust-regex `\\w` the reference uses
(`[\\p{Alphabetic}\\p{M}\\p{Nd}\\p{Pc}\\p{Join_Control}]`), read from the
committed class table `data/wl_class_whitespace.npz` (its `WL_A` class,
the `regex` module's `\\w`: the same set of code points); the whitespace
of `lstrip`/`rstrip` is the reference's explicit list (`SPACE_CHARS`).

`split(sentence, normalized)` gives the pieces of a text as
(id or None, start, end) in chars, covering the whole text; the
tokenizer's fast host path runs the normalizer, the pre-tokenizer and the
model on the text pieces (`Tokenizer._host_items`).  The general host
pipeline starts from `extract_and_normalize`, as the JAX package's: a
PreTokenizedString whose splits are the raw tokens' matches, then on each
other split the normalizer and the normalized tokens' matches, every
match a split already tokenized.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# the reference's whitespace of lstrip and rstrip (`added_vocabulary.rs`)
SPACE_CHARS = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680" + "".join(map(chr, range(0x2000, 0x200B)))
                        + "\u2028\u2029\u202f\u205f\u3000")

_word_table = None


def is_word_char(c: str) -> bool:
    """Whether `c` is a rust-regex `\\w` char (the committed class table)."""
    global _word_table
    if _word_table is None:
        from .ops.wordlevel_encode import WL_A, wordlevel_class_tables

        s1, s2 = wordlevel_class_tables("whitespace")
        _word_table = (s1, s2, WL_A)
    s1, s2, word = _word_table
    cp = ord(c)
    return int(s2[(int(s1[cp >> 8]) << 8) | (cp & 255)]) == word


class AddedToken:
    __slots__ = ("content", "single_word", "lstrip", "rstrip", "normalized", "special",
                 "_normalized_arg")

    def __init__(self, content: str = "", single_word: bool = False, lstrip: bool = False,
                 rstrip: bool = False, normalized: Optional[bool] = None, special: bool = False):
        self.content = content
        self.single_word = single_word
        self.lstrip = lstrip
        self.rstrip = rstrip
        # special tokens are not normalized by default
        self.normalized = (not special) if normalized is None else normalized
        self.special = special
        self._normalized_arg = normalized

    def as_special(self) -> "AddedToken":
        """This token made special, as the reference binding's
        `add_special_tokens` makes every token it is given (not normalized
        unless it was asked to be); the JAX package keeps the token as it
        is (ROADMAP Queue C)."""
        if self.special:
            return self
        return AddedToken(self.content, self.single_word, self.lstrip, self.rstrip,
                          self._normalized_arg, special=True)

    def _key(self):
        return (self.content, self.single_word, self.lstrip, self.rstrip, self.normalized,
                self.special)

    def __eq__(self, other):
        if isinstance(other, str):
            return self.content == other
        return isinstance(other, AddedToken) and self._key() == other._key()

    def __hash__(self):
        return hash(self.content)

    def __repr__(self):
        return (f"AddedToken({self.content!r}, single_word={self.single_word}, "
                f"lstrip={self.lstrip}, rstrip={self.rstrip}, normalized={self.normalized}, "
                f"special={self.special})")

    def __str__(self):
        return self.content


class _Matcher:
    """Leftmost-longest matcher over literal patterns: an alternation of
    the patterns, longest first, matches as Aho-Corasick's leftmost-longest
    does."""

    __slots__ = ("_re", "_index")

    def __init__(self, patterns: List[str]):
        self._index: Dict[str, int] = {}
        for i, p in enumerate(patterns):
            self._index.setdefault(p, i)
        alts = sorted((p for p in self._index if p), key=len, reverse=True)
        self._re = re.compile("|".join(map(re.escape, alts))) if alts else None

    def find_iter(self, s: str):
        """(pattern index, char start, char end) of each match."""
        if self._re is None:
            return
        for m in self._re.finditer(s):
            yield self._index[m.group()], m.start(), m.end()

    def any_in(self, s: str) -> bool:
        return self._re is not None and self._re.search(s) is not None


class AddedVocabulary:
    def __init__(self):
        self.added_tokens_map: Dict[str, int] = {}
        self.added_tokens_map_r: Dict[int, AddedToken] = {}
        self.added_tokens: List[AddedToken] = []
        self.special_tokens: List[AddedToken] = []
        self.special_tokens_set: set = set()
        self.split_trie: Tuple[_Matcher, List[int]] = (_Matcher([]), [])
        self.split_normalized_trie: Tuple[_Matcher, List[int]] = (_Matcher([]), [])
        self.encode_special_tokens: bool = False

    def get_added_tokens_decoder(self) -> Dict[int, AddedToken]:
        return dict(self.added_tokens_map_r)

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.added_tokens_map)

    def token_to_id(self, token: str, model) -> Optional[int]:
        tid = self.added_tokens_map.get(token)
        return tid if tid is not None else model.token_to_id(token)

    def id_to_token(self, id: int, model) -> Optional[str]:
        tok = self.added_tokens_map_r.get(id)
        return tok.content if tok is not None else model.id_to_token(id)

    def is_special_token(self, token: str) -> bool:
        return token in self.special_tokens_set

    def has_normalized(self) -> bool:
        """Whether any token is matched on the normalized text."""
        return bool(self.split_normalized_trie[1])

    # ------------------------------------------------------------------ build

    def add_special_tokens(self, tokens: List[AddedToken], model, normalizer) -> int:
        return self.add_tokens(tokens, model, normalizer)

    def add_tokens(self, tokens: List[AddedToken], model, normalizer) -> int:
        """(reference `added_vocabulary.rs:258-316`)"""
        for token in tokens:
            if token.special and token.content and token.content not in self.special_tokens_set:
                self.special_tokens.append(token)
                self.special_tokens_set.add(token.content)
        ignored = 0
        for token in tokens:
            if not token.content or any(v == token for v in self.added_tokens_map_r.values()):
                ignored += 1
                continue
            new_id = self.token_to_id(token.content, model)
            if new_id is None:
                size = model.get_vocab_size()
                if self.added_tokens_map:
                    top = max(self.added_tokens_map.values())
                    new_id = top + 1 if top >= size or size == 0 else size
                else:
                    new_id = size
            self.added_tokens_map[token.content] = new_id
            self.added_tokens_map_r[new_id] = token
            if token.content not in self.special_tokens_set:
                self.added_tokens.append(token)
        self.refresh_added_tokens(model, normalizer)
        return len(tokens) - ignored

    def force_id(self, token: AddedToken, tid: int, model, normalizer) -> None:
        """Give `token` the id `tid`, as a tokenizer.json records it (the
        reference deserializes the map as it stands;
        `tokenizers_tpu/serialization.py:650-668`)."""
        self.added_tokens_map[token.content] = tid
        for k in [k for k, v in self.added_tokens_map_r.items()
                  if v.content == token.content and k != tid]:
            del self.added_tokens_map_r[k]
        self.added_tokens_map_r[tid] = token
        self.refresh_added_tokens(model, normalizer)

    def refresh_added_tokens(self, model, normalizer) -> None:
        """(reference `added_vocabulary.rs:323-360`)"""
        normalized, raw = [], []
        for token in self.special_tokens + self.added_tokens:
            tid = self.token_to_id(token.content, model)
            if tid is None:
                raise RuntimeError("Missing additional token")
            (normalized if token.normalized else raw).append((token, tid))
        self.split_trie = (_Matcher([t.content for t, _ in raw]), [i for _, i in raw])
        patterns = [t.content if normalizer is None else normalizer.normalize_str(t.content)
                    for t, _ in normalized]
        self.split_normalized_trie = (_Matcher(patterns), [i for _, i in normalized])

    # ------------------------------------------------------------------ match

    def needs_host(self, s: str, normalizer) -> bool:
        """Whether `s` holds an added token, in its raw text or (for the
        tokens matched there) its normalized text: such inputs take the
        host pipeline, which extracts them before the model."""
        if any(t in s for t in self.added_tokens_map):
            return True
        if not self.has_normalized():
            return False
        return self.split_normalized_trie[0].any_in(
            s if normalizer is None else normalizer.normalize_str(s))

    def extract_and_normalize(self, normalizer, sequence: str):
        """`sequence` as a PreTokenizedString (reference
        `added_vocabulary.rs:455-521`)."""
        from .pretokenized import PreTokenizedString

        pretokenized = PreTokenizedString(sequence)
        pretokenized.split(lambda _i, ns: self._split_ns(ns, False))

        def norm_and_split(_i, ns):
            if normalizer is not None:
                normalizer.normalize(ns)
            return self._split_ns(ns, True)

        pretokenized.split(norm_and_split)
        return pretokenized

    def _split_ns(self, ns, normalized: bool):
        """`split` of a NormalizedString's text, as (part, tokens or None)."""
        from .normalized import char_to_byte_offsets
        from .pretokenized import Token

        text = ns.get()
        pieces = self.split(text, normalized)
        cb = char_to_byte_offsets(text)
        out = []
        for tid, cs, ce in pieces:
            part = ns.slice(cb[cs], cb[ce])
            if part is None:
                raise RuntimeError("AddedVocabulary bad split")
            if tid is None:
                out.append((part, None))
            else:
                value = part.get()
                out.append((part, [Token(tid, value, (0, len(value.encode("utf-8"))))]))
        return out

    def split(self, sentence: str, normalized: bool) -> List[Tuple[Optional[int], int, int]]:
        """(id or None, start, end) in chars of each piece of `sentence`,
        covering it: the matches of the raw (or, with `normalized`, the
        normalized) tokens, stripped and checked as each token says
        (reference `added_vocabulary.rs:367-420`), and the text between."""
        matcher, ids = self.split_normalized_trie if normalized else self.split_trie
        if not sentence or not ids:
            return [(None, 0, len(sentence))] if sentence else []
        n = len(sentence)
        start_offset = 0
        out: List[Tuple[Optional[int], int, int]] = []
        for pat, cstart, cend in matcher.find_iter(sentence):
            tid = ids[pat]
            token = self.added_tokens_map_r[tid]
            if self.encode_special_tokens and token.content in self.special_tokens_set:
                continue
            if token.single_word:
                start_space = cstart == 0 or not is_word_char(sentence[cstart - 1])
                stop_space = cend == n or not is_word_char(sentence[cend])
                if not (start_space and stop_space):
                    continue
            start, stop = cstart, cend
            if token.lstrip:
                while start > 0 and sentence[start - 1] in SPACE_CHARS:
                    start -= 1
                start = max(start, start_offset)
            if token.rstrip:
                while stop < n and sentence[stop] in SPACE_CHARS:
                    stop += 1
            if start_offset < start:
                out.append((None, start_offset, start))
            out.append((tid, start, stop))
            start_offset = stop
        if start_offset != n:
            out.append((None, start_offset, n))
        return out
