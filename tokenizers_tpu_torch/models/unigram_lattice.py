"""Unigram lattice of the host path: Viterbi, n-best and forward-backward
marginals; copy of `tokenizers_tpu.models.unigram_lattice` (reference
`models/unigram/lattice.rs`).

Node layout: `begin_nodes`/`end_nodes` per byte position with bos/eos
sentinels; `viterbi` (:176) keeps the first-inserted of equal paths (a
later candidate wins only when strictly greater); `nbest` (:237) is the
A*-style hypothesis heap; `populate_marginal` (:331) folds the forward
and backward scores with `log_sum_exp` (:123: the first node initialises,
a gap over 50.0 keeps the larger alone).  `Unigram.populate_nodes`
inserts pieces per position in increasing length, as the reference's
trie does, so ties resolve as there.

This is the oracle the trainer's device programs
(`ops/unigram_em_step.py`) are held against, and the route of the
sentences they do not take.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Optional


class Node:
    __slots__ = ("id", "node_id", "pos", "length", "prev", "backtrace_score", "score")

    def __init__(self, id: int, node_id: int, pos: int, length: int, score: float):
        self.id = id
        self.node_id = node_id
        self.pos = pos
        self.length = length
        self.prev: Optional["Node"] = None
        self.backtrace_score = 0.0
        self.score = score


def log_sum_exp(x: float, y: float, init_mode: bool) -> float:
    if init_mode:
        return y
    vmin, vmax = (y, x) if x > y else (x, y)
    k_minus_log_epsilon = 50.0
    if vmax > vmin + k_minus_log_epsilon:
        return vmax
    return vmax + math.log(math.exp(vmin - vmax) + 1.0)


class Lattice:
    def __init__(self, sentence: str, bos_id: int, eos_id: int):
        self.sentence = sentence
        self.sb = sentence.encode("utf-8")
        self.sentence_bytes = self.sb  # name used by Unigram.populate_nodes
        self.len = len(self.sb)
        self.nodes: List[Node] = []
        self.begin_nodes: List[List[Node]] = [[] for _ in range(self.len + 1)]
        self.end_nodes: List[List[Node]] = [[] for _ in range(self.len + 1)]
        bos = Node(bos_id, 0, 0, 0, 0.0)
        eos = Node(eos_id, 1, self.len, 0, 0.0)
        self.begin_nodes[self.len].append(eos)
        self.end_nodes[0].append(bos)
        self.nodes.append(bos)
        self.nodes.append(eos)

    # `from` is a keyword in Python; keep the reference name via alias
    @classmethod
    def from_(cls, sentence: str, bos_id: int, eos_id: int) -> "Lattice":
        return cls(sentence, bos_id, eos_id)

    def insert(self, pos: int, length: int, score: float, id: int) -> None:
        node = Node(id, len(self.nodes), pos, length, score)
        self.begin_nodes[pos].append(node)
        self.end_nodes[pos + length].append(node)
        self.nodes.append(node)

    # ------------------------------------------------------------- viterbi

    def viterbi(self) -> List[Node]:
        sb = self.sb
        length = self.len
        pos = 0
        while pos <= length:
            if not self.begin_nodes[pos]:
                return []
            for rnode in self.begin_nodes[pos]:
                rnode.prev = None
                best_score = 0.0
                best_node: Optional[Node] = None
                for lnode in self.end_nodes[pos]:
                    score = lnode.backtrace_score + rnode.score
                    if best_node is None or score > best_score:
                        best_node = lnode
                        best_score = score
                if best_node is None:
                    return []
                rnode.prev = best_node
                rnode.backtrace_score = best_score
            if pos < length:
                b0 = sb[pos]
                if b0 < 0x80:
                    pos += 1
                elif b0 < 0xE0:
                    pos += 2
                elif b0 < 0xF0:
                    pos += 3
                else:
                    pos += 4
            else:
                break

        results: List[Node] = []
        root = self.begin_nodes[length][0]
        if root.prev is None:
            return []
        node = root.prev
        while node.prev is not None:
            results.append(node)
            node = node.prev
        results.reverse()
        return results

    def piece(self, node: Node) -> str:
        return self.sb[node.pos : node.pos + node.length].decode("utf-8")

    def tokens(self) -> List[str]:
        return [self.piece(n) for n in self.viterbi()]

    # --------------------------------------------------------------- nbest

    def bos_node(self) -> Node:
        return self.end_nodes[0][0]

    def eos_node(self) -> Node:
        return self.begin_nodes[self.len][0]

    def nbest(self, n: int) -> List[List[Node]]:
        if n == 0:
            return []
        if n == 1:
            return [self.viterbi()]

        # agenda of hypotheses ordered by fx desc (max-heap)
        agenda: List = []
        counter = 0

        def push(fx, gx, node, nxt):
            nonlocal counter
            heapq.heappush(agenda, (-fx, counter, gx, node, nxt))
            counter += 1

        hypotheses: List[List[Node]] = []
        eos = self.eos_node()
        push(eos.score, eos.score, eos, None)
        self.viterbi()  # fill backtrace scores

        while agenda:
            neg_fx, _, gx, node, nxt = heapq.heappop(agenda)
            top = (node, nxt, gx)
            if node.id == self.bos_node().id:
                hypothesis = []
                nref = nxt
                while nref is not None and nref[1] is not None:
                    hypothesis.append(nref[0])
                    nref = nref[1]
                hypotheses.append(hypothesis)
                if len(hypotheses) == n:
                    return hypotheses
            else:
                for lnode in self.end_nodes[node.pos]:
                    fx = lnode.backtrace_score + gx
                    lgx = lnode.score + gx
                    push(fx, lgx, lnode, top)
                k_max_agenda_size = 100_000
                k_min_agenda_size = 512
                if len(agenda) > k_max_agenda_size:
                    keep = min(k_min_agenda_size, n * 10)
                    agenda = heapq.nsmallest(keep, agenda)
                    heapq.heapify(agenda)
        return hypotheses

    def nbest_tokens(self, n: int) -> List[List[str]]:
        return [[self.piece(node) for node in path] for path in self.nbest(n)]

    # ---------------------------------------------------------- marginals

    def populate_marginal(self, freq: float, expected: List[float]) -> float:
        """Add freq-weighted expected piece counts; returns freq * logZ."""
        length = self.len
        n_nodes = len(self.nodes)
        alpha = [0.0] * n_nodes
        beta = [0.0] * n_nodes
        for pos in range(length + 1):
            for rnode in self.begin_nodes[pos]:
                rid = rnode.node_id
                for i, lnode in enumerate(self.end_nodes[pos]):
                    lid = lnode.node_id
                    alpha[rid] = log_sum_exp(
                        alpha[rid], lnode.score + alpha[lid], i == 0
                    )
        for pos in range(length, -1, -1):
            for lnode in self.end_nodes[pos]:
                lid = lnode.node_id
                for i, rnode in enumerate(self.begin_nodes[pos]):
                    rid = rnode.node_id
                    beta[lid] = log_sum_exp(
                        beta[lid], rnode.score + beta[rid], i == 0
                    )

        eos_id = self.begin_nodes[length][0].node_id
        z = alpha[eos_id]
        for pos in range(length):
            for node in self.begin_nodes[pos]:
                a = alpha[node.node_id]
                b = beta[node.node_id]
                total = a + node.score + b - z
                update = freq * math.exp(total)
                expected[node.id] += update
        return freq * z
