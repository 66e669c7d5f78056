"""Tokenizers for the serving path (copies of ``gofr_tpu/serving/
tokenizer.py``'s ``Tokenizer`` protocol, ``ByteTokenizer`` and
``BPETokenizer``).

``ByteTokenizer`` is the dependency-free default: UTF-8 bytes + special
tokens, reversible for any text, vocab 260. ``BPETokenizer`` loads a
byte-pair vocabulary from a tiktoken-format rank file
(:meth:`BPETokenizer.from_files`) or a Hugging Face ``tokenizer.json``
(:meth:`BPETokenizer.from_hf_json`), as a served checkpoint brings it.
Its merge loop runs in C++ (``gofr_tpu_torch/native/bpe.py``) whenever a
compiler is present, one call for the whole text with the
pre-tokenizer's piece bounds, and in pure Python otherwise
(:attr:`BPETokenizer.native` says which).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Protocol


class Tokenizer(Protocol):
    """What the serving path reads of a tokenizer: its special ids, its
    vocabulary size, ``encode`` and ``decode``."""
    bos_id: int
    eos_id: int
    pad_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 are bytes, then specials."""

    def __init__(self) -> None:
        self.pad_id = 256
        self.bos_id = 257
        self.eos_id = 258
        self.unk_id = 259
        self.vocab_size = 260

    def encode(self, text: str, *, bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if bos else ids

    def decode(self, ids: list[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", "replace")


def _byte_level_table() -> dict[str, int]:
    """The GPT-2 byte<->printable-unicode bijection HF byte-level BPE
    vocabularies are written in: printable ASCII and two latin-1
    ranges map to themselves, everything else shifts into U+0100+."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


#: Llama-3 / GPT-4 style pre-tokenizer, approximated for the stdlib
#: ``re`` engine: ``\p{L}`` becomes ``[^\W\d_]`` and ``\p{N}`` becomes
#: ``\d`` (exotic unicode-numeral edge cases may split differently
#: than HF's regex; byte-level BPE keeps the result lossless either
#: way).
_PRETOKENIZE = re.compile(
    r"'(?i:[sdmt]|ll|ve|re)"
    r"|(?:(?![\r\n])[\W_])?[^\W\d_]+"
    r"|\d{1,3}"
    r"| ?(?:(?!\s)[\W_])+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+")


class BPETokenizer:
    """Byte-pair tokenizer over a rank table (tiktoken file format:
    ``base64(token_bytes) rank`` per line), or a Hugging Face
    ``tokenizer.json`` via :meth:`from_hf_json`.

    In tiktoken form the vocabulary id IS the merge priority. HF
    vocabularies separate the two (merge order comes from the
    ``merges`` list), so ``merge_ranks`` can override the priorities
    the merge loop uses while ``ranks`` keeps mapping final pieces to
    ids."""

    def __init__(self, ranks: dict[bytes, int],
                 specials: dict[str, int] | None = None, *,
                 merge_ranks: dict[bytes, int] | None = None,
                 pretokenize: bool = False,
                 bos_token: str | None = None,
                 eos_token: str | None = None,
                 pad_token: str | None = None) -> None:
        self.ranks = ranks
        self.specials = dict(specials or {})
        self.merge_ranks = merge_ranks
        self._pretok = _PRETOKENIZE if pretokenize else None

        def special(name: str | None, default: str, fallback: int) -> int:
            if name is not None:
                return self.specials[name]
            return self.specials.setdefault(default, fallback)

        base = max(max(ranks.values(), default=-1) + 1,
                   max(self.specials.values(), default=-1) + 1)
        self.bos_id = special(bos_token, "<|bos|>", base)
        self.eos_id = special(eos_token, "<|eos|>", base + 1)
        self.pad_id = special(pad_token, "<|pad|>", base + 2)
        self.vocab_size = max(
            (max(ranks.values(), default=-1),
             max(self.specials.values(), default=-1))) + 1
        self._decode_table: dict[int, bytes] = {v: k for k, v in ranks.items()}
        for text, sid in self.specials.items():
            self._decode_table.setdefault(sid, text.encode())
        self._native = None
        try:
            from ..native import bpe as native_bpe
            self._native = native_bpe.load(ranks, merge_ranks)
        except Exception:  # noqa: BLE001 — no compiler: pure Python
            self._native = None

    @property
    def native(self) -> bool:
        """True when the C++ merge loop is live."""
        return self._native is not None

    @classmethod
    def from_files(cls, ranks_path: str | Path,
                   specials_path: str | Path | None = None) -> "BPETokenizer":
        import base64
        ranks: dict[bytes, int] = {}
        for line in Path(ranks_path).read_text().splitlines():
            if not line.strip():
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
        specials = None
        if specials_path and Path(specials_path).is_file():
            specials = json.loads(Path(specials_path).read_text())
        return cls(ranks, specials)

    @classmethod
    def from_hf_json(cls, path: str | Path, *,
                     bos_token: str | None = None,
                     eos_token: str | None = None) -> "BPETokenizer":
        """Ingest a Hugging Face ``tokenizer.json`` (byte-level BPE —
        the Llama-3 / GPT-2 family layout): the ``model.vocab`` token
        strings decode through the byte-level table back to raw
        bytes, merge priority comes from the ``merges`` list, and
        ``added_tokens`` become specials. ``bos_token``/``eos_token``
        default to the usual Llama-3 names when present."""
        spec = json.loads(Path(path).read_text())
        table = _byte_level_table()

        def to_bytes(token: str) -> bytes:
            return bytes(table[ch] for ch in token if ch in table)

        vocab = spec["model"]["vocab"]
        ranks: dict[bytes, int] = {}
        for token, idx in vocab.items():
            b = to_bytes(token)
            if len(b) == len(token):  # pure byte-level entry
                ranks[b] = idx
        merges = spec["model"].get("merges", [])
        merge_ranks: dict[bytes, int] = {}
        for m, pair in enumerate(merges):
            left, right = pair.split(" ") if isinstance(pair, str) else pair
            merge_ranks[to_bytes(left) + to_bytes(right)] = m
        specials = {t["content"]: t["id"]
                    for t in spec.get("added_tokens", [])}
        if bos_token is None and "<|begin_of_text|>" in specials:
            bos_token = "<|begin_of_text|>"
        if eos_token is None and "<|end_of_text|>" in specials:
            eos_token = "<|end_of_text|>"
        return cls(ranks, specials, merge_ranks=merge_ranks or None,
                   pretokenize=True, bos_token=bos_token,
                   eos_token=eos_token)

    def _bpe_merge(self, piece: bytes) -> list[int]:
        """Greedy lowest-rank merging (the pure-Python loop)."""
        priorities = self.merge_ranks if self.merge_ranks is not None \
            else self.ranks
        parts: list[bytes] = [piece[i:i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                rank = priorities.get(parts[i] + parts[i + 1])
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            rank = self.ranks.get(p)
            if rank is not None:
                out.append(rank)
            else:  # unmergeable byte without a rank: skip (lossy, rare)
                out.extend(r for r in (self.ranks.get(p[i:i+1])
                                       for i in range(len(p))) if r is not None)
        return out

    def encode(self, text: str, *, bos: bool = True) -> list[int]:
        if self._pretok is not None:
            str_pieces = self._pretok.findall(text)
            pieces = [p.encode("utf-8") for p in str_pieces]
            # findall returns ordered substrings, so equal character
            # counts mean the pieces tile the text: a gap would let the
            # whole-text native call see bytes the per-piece loop drops
            if self._native is not None \
                    and sum(map(len, str_pieces)) == len(text):
                # one native call for the whole text, the pieces' starts
                # as bounds that merges may not cross
                bounds: list[int] = []
                off = 0
                for piece in pieces:
                    bounds.append(off)
                    off += len(piece)
                ids = self._native.encode(b"".join(pieces), bounds)
            else:
                ids = []
                for piece in pieces:
                    ids.extend(self._bpe_merge(piece))
        elif self._native is not None:
            ids = self._native.encode(text.encode("utf-8"))
        else:
            ids = self._bpe_merge(text.encode("utf-8"))
        return ([self.bos_id] + ids) if bos else ids

    def decode(self, ids: list[int]) -> str:
        chunks = [self._decode_table.get(i, b"") for i in ids]
        return b"".join(chunks).decode("utf-8", "replace")
