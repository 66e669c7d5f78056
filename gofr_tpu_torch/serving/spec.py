"""Speculative decoding support: incremental n-gram drafting, draft
trees, and the goodput-priced speculation controller (the port's own
copy of ``gofr_tpu/serving/spec.py``: host code only, no torch; the
port imports nothing of the JAX package).

Three host-side pieces the engine composes (device work — tree verify,
acceptance, KV compaction — lives in ``serving/engine.py``'s
``resolve_tree`` / ``path_moves``, ``ops/paged_kv.pool_move_rows`` and
the tree kernel of ``ops/paged_attention.py``):

- :class:`NgramIndex` — a per-request index from n-gram to the
  positions it occurs at, extended O(1) per retired token; rebuilt
  from scratch only when the request's token stream is rewritten
  under it.
- :class:`DraftTree` — up to 32 draft nodes packed topologically
  (parent index < child index, node 0 = the committed root token),
  with per-node parent / depth / packed ancestor bitmask arrays in
  exactly the layout the tree-verify kernel consumes.
- :class:`SpecController` — per-slot accept-rate EWMA priced against
  fitted decode sec/token and verify row cost. Drafting happens only
  when the expected accepted tokens are worth more than the marginal
  verify rows; slots whose acceptance collapses are disabled and
  re-probed on a fixed cadence.
"""

from __future__ import annotations

from dataclasses import dataclass

#: packed ancestor masks are int32 bitfields — a draft tree can never
#: exceed this many nodes (root included)
MAX_TREE_NODES = 32


# ------------------------------------------------------------ draft tree

@dataclass
class DraftTree:
    """A verified-together draft tree. Node 0 is the ROOT — the last
    committed token, whose verify logits re-derive the first draft
    prediction. Nodes are packed topologically: ``parents[i] < i`` for
    every i > 0, so the verify kernel's ragged page walk stays exact
    and acceptance can be resolved in one forward sweep.

    ``masks[i]`` packs node i's ancestor-or-self set as bits over the
    node index: bit j set iff node j is on the root-to-i path
    (including i itself). ``masks[0] == 1``.
    """

    tokens: list[int]
    parents: list[int]
    depths: list[int]
    masks: list[int]

    @property
    def n_nodes(self) -> int:
        return len(self.tokens)

    @property
    def n_draft(self) -> int:
        """Drafted (non-root) nodes."""
        return len(self.tokens) - 1

    @property
    def max_depth(self) -> int:
        return max(self.depths)

    @classmethod
    def root(cls, root_token: int) -> "DraftTree":
        return cls([int(root_token)], [0], [0], [1])

    @classmethod
    def from_chain(cls, root_token: int, proposals) -> "DraftTree":
        """A single linear continuation — the historical draft shape
        (``spec_branches=1``), and the normalization target for
        monkeypatched ``_draft_proposals`` hooks that return a plain
        token list."""
        tree = cls.root(root_token)
        cur = 0
        for tok in proposals:
            cur = tree.add(cur, int(tok))
        return tree

    def add(self, parent: int, token: int) -> int:
        """Append a child of ``parent``; returns the new node index.
        Raises if the tree is at the bitmask capacity."""
        i = len(self.tokens)
        if i >= MAX_TREE_NODES:
            raise ValueError(f"draft tree exceeds {MAX_TREE_NODES} nodes")
        if not 0 <= parent < i:
            raise ValueError(f"parent {parent} out of range for node {i}")
        self.tokens.append(int(token))
        self.parents.append(parent)
        self.depths.append(self.depths[parent] + 1)
        self.masks.append(self.masks[parent] | (1 << i))
        return i

    def path_to(self, node: int) -> list[int]:
        """Node indices on the root-to-``node`` path, root first."""
        path = []
        cur = node
        while True:
            path.append(cur)
            if cur == 0:
                break
            cur = self.parents[cur]
        path.reverse()
        return path


def build_draft_tree(root_token: int, chains,
                     max_nodes: int = MAX_TREE_NODES) -> DraftTree:
    """Trie-merge candidate continuation chains into one DraftTree.
    Chains sharing a prefix share nodes (the whole point of tree
    verify: k continuations of a hot n-gram usually agree for a few
    tokens before they fork). Chains are consumed in order; growth
    stops silently at ``max_nodes``."""
    tree = DraftTree.root(root_token)
    children: dict[int, dict[int, int]] = {}
    for chain in chains:
        cur = 0
        for tok in chain:
            tok = int(tok)
            kids = children.setdefault(cur, {})
            nxt = kids.get(tok)
            if nxt is None:
                if tree.n_nodes >= max_nodes:
                    break
                nxt = tree.add(cur, tok)
                kids[tok] = nxt
            cur = nxt
    return tree


# ----------------------------------------------------------- ngram index

class NgramIndex:
    """Incremental n-gram -> positions index over one request's token
    stream (prompt + generated). ``extend`` is O(1) amortized per new
    token; ``propose`` is O(branches) dictionary probes. The index
    tracks how many tokens it has folded in (``size``) so the engine
    can detect a rewritten stream (preempt/recover fold generated
    tokens back into the prompt) and rebuild instead of extending."""

    __slots__ = ("n", "tokens", "positions", "prompt_len")

    def __init__(self, n: int):
        self.n = n
        self.tokens: list[int] = []
        self.positions: dict[tuple, list[int]] = {}
        #: length of the request's prompt when this index was built —
        #: the engine's O(1) rewrite detector (preemption is the only
        #: thing that grows a prompt mid-flight)
        self.prompt_len = -1

    @property
    def size(self) -> int:
        return len(self.tokens)

    def extend(self, new_tokens) -> None:
        toks = self.tokens
        pos = self.positions
        n = self.n
        for t in new_tokens:
            toks.append(int(t))
            start = len(toks) - n
            if start >= 0:
                key = tuple(toks[start:])
                pos.setdefault(key, []).append(start)

    def propose(self, depth: int, branches: int) -> list[list[int]]:
        """Up to ``branches`` candidate continuations of the stream's
        final n-gram, each up to ``depth`` tokens, newest occurrence
        first, distinct first tokens (two chains opening with the same
        token would collapse to one trie branch anyway — spend the
        budget on genuinely different continuations)."""
        toks = self.tokens
        n = self.n
        if depth <= 0 or branches <= 0 or len(toks) < n:
            return []
        hits = self.positions.get(tuple(toks[-n:]))
        if not hits:
            return []
        chains: list[list[int]] = []
        seen: set[int] = set()
        for start in reversed(hits):
            cont = start + n
            if cont >= len(toks):
                continue  # the suffix's own occurrence
            chain = toks[cont:cont + depth]
            if chain[0] in seen:
                continue
            seen.add(chain[0])
            chains.append(chain)
            if len(chains) >= branches:
                break
        return chains


# ------------------------------------------------------------ controller

class SpecController:
    """Per-slot speculation policy, fitted online.

    Learns three things: a decode **sec/token** EWMA (what an accepted
    draft token is worth), a verify **row cost** EWMA (what a drafted
    node costs), and a per-slot **accept-rate** EWMA (how often this
    request's drafts survive). A pass drafts to depth d only while the
    marginal expected value ``accept^d * sec_per_token`` exceeds the
    marginal cost ``branches * row_cost`` of carrying depth d's nodes
    through the verify matmuls. Slots start optimistic (EWMA 1.0 — the
    first drafts always run) and are DISABLED when the EWMA falls
    under ``accept_floor``; a disabled slot sends a single-node probe
    every ``probe_interval`` passes and re-enables on a surviving
    probe. ``adaptive=False`` reproduces the historical static policy
    (always full depth, single chain honored via branches).
    """

    def __init__(self, max_batch: int, *, draft: int, branches: int,
                 adaptive: bool = True, accept_floor: float = 0.1,
                 probe_interval: int = 32, alpha: float = 0.2):
        self.max_batch = max_batch
        self.draft = draft
        self.branches = branches
        self.adaptive = adaptive
        self.accept_floor = accept_floor
        self.probe_interval = probe_interval
        self.alpha = alpha
        self.sec_per_token: float | None = None
        self.row_cost: float | None = None
        self.drafted_total = 0
        self.accepted_total = 0
        self.accept = [1.0] * max_batch
        self.disabled = [False] * max_batch
        self._idle = [0] * max_batch

    # ---- lifecycle ---------------------------------------------------
    def reset_slot(self, slot: int) -> None:
        """New request admitted to ``slot``: forget the old tenant's
        acceptance history, restart optimistic."""
        self.accept[slot] = 1.0
        self.disabled[slot] = False
        self._idle[slot] = 0

    # ---- measurements ------------------------------------------------
    def _ewma(self, old: float | None, new: float) -> float:
        if old is None:
            return new
        return (1.0 - self.alpha) * old + self.alpha * new

    def note_decode(self, busy_s: float, emitted: int) -> None:
        """A plain decode pass emitted ``emitted`` tokens over
        ``busy_s`` device-seconds — the price an accepted draft token
        undercuts."""
        if emitted > 0 and busy_s > 0:
            self.sec_per_token = self._ewma(self.sec_per_token,
                                            busy_s / emitted)

    def note_verify(self, busy_s: float, rows: int, width: int) -> None:
        """A verify pass carried ``rows`` live slots at ``width`` node
        rows each over ``busy_s`` device-seconds."""
        total = rows * width
        if total > 0 and busy_s > 0:
            self.row_cost = self._ewma(self.row_cost, busy_s / total)

    def note_result(self, slot: int, drafted: int, accepted: int) -> None:
        """One slot's verify outcome: ``accepted`` of ``drafted``
        drafted tokens survived."""
        if drafted <= 0:
            return
        self.drafted_total += drafted
        self.accepted_total += accepted
        rate = accepted / drafted
        if self.disabled[slot]:
            # probe outcome: a surviving probe re-enables the slot at
            # the observed rate; a dead probe leaves it disabled until
            # the next probe window
            if rate >= self.accept_floor:
                self.disabled[slot] = False
                self.accept[slot] = max(rate, self.accept_floor)
            return
        self.accept[slot] = (1.0 - self.alpha) * self.accept[slot] \
            + self.alpha * rate
        if self.accept[slot] < self.accept_floor:
            self.disabled[slot] = True
            self._idle[slot] = 0

    # ---- policy ------------------------------------------------------
    def plan(self, slot: int) -> tuple[int, int]:
        """(depth, branches) to draft for ``slot`` this pass;
        (0, 0) means skip drafting."""
        if not self.adaptive:
            return self.draft, self.branches
        if self.disabled[slot]:
            self._idle[slot] += 1
            if self._idle[slot] >= self.probe_interval:
                self._idle[slot] = 0
                return 1, 1
            return 0, 0
        a = self.accept[slot]
        spt, rc = self.sec_per_token, self.row_cost
        if spt is None or rc is None:
            # not calibrated yet: draft at full config depth — the
            # first verify/decode passes fit the EWMAs
            return self.draft, self.branches
        marginal_cost = rc * self.branches
        depth = 0
        value = spt
        for d in range(1, self.draft + 1):
            value *= a  # a^d * sec_per_token
            if value > marginal_cost:
                depth = d
            else:
                break
        if depth == 0:
            return 0, 0
        return depth, self.branches

    def accept_rate(self) -> float:
        """Lifetime accepted/drafted (1.0 before any drafting — the
        optimistic bootstrap, and keeps the gauge in [0, 1])."""
        if self.drafted_total == 0:
            return 1.0
        return self.accepted_total / self.drafted_total

    def state(self) -> dict:
        """Snapshot for ``/debug/efficiency``."""
        return {
            "adaptive": self.adaptive,
            "draft": self.draft,
            "branches": self.branches,
            "accept_rate": round(self.accept_rate(), 4),
            "drafted": self.drafted_total,
            "accepted": self.accepted_total,
            "sec_per_token": self.sec_per_token,
            "verify_row_cost": self.row_cost,
            "slots": [
                {"accept_ewma": round(self.accept[i], 4),
                 "disabled": self.disabled[i]}
                for i in range(self.max_batch)
            ],
        }
