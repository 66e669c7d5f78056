"""ctypes binding of the C++ BPE encoder (``src/bpe.cpp``).

``load(ranks)`` builds a native encoder from a ``bytes -> rank`` table
(tiktoken style: the id is the merge priority); ``load(ranks,
merge_ranks)`` the Hugging Face ``tokenizer.json`` style, where the
merges list gives the priorities and the vocabulary the ids.
:meth:`NativeBPE.encode` releases the GIL for the merge loop and takes
optional pre-tokenizer piece bounds (byte offsets that merges may not
cross). Raises ``NativeBuildError`` when no compiler is present: the
caller (``serving/tokenizer.py``) falls back to pure Python.
"""

from __future__ import annotations

import ctypes

from .build import load_library


class NativeBPE:
    def __init__(self, ranks: dict[bytes, int],
                 merge_ranks: dict[bytes, int] | None = None) -> None:
        self._lib = load_library("bpe")
        self._lib.bpe_create.restype = ctypes.c_void_p
        self._lib.bpe_add_token.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int32]
        self._lib.bpe_add_merge.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int32]
        self._lib.bpe_encode_bounded.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        self._lib.bpe_encode_bounded.restype = ctypes.c_int
        self._lib.bpe_destroy.argtypes = [ctypes.c_void_p]
        self._lib.bpe_finalize.argtypes = [ctypes.c_void_p]
        self._handle = ctypes.c_void_p(self._lib.bpe_create())
        for token, rank in ranks.items():
            self._lib.bpe_add_token(self._handle, token, len(token), rank)
        for piece, prio in (merge_ranks or {}).items():
            self._lib.bpe_add_merge(self._handle, piece, len(piece), prio)
        self._lib.bpe_finalize(self._handle)

    def encode(self, data: bytes,
               bounds: list[int] | None = None) -> list[int]:
        """Ids of ``data``; ``bounds``: sorted byte offsets, each the
        start of a pre-tokenizer piece. Never more ids than bytes, so an
        output of ``max(len(data), 16)`` always holds them."""
        cap = max(len(data), 16)
        nb = len(bounds) if bounds else 0
        b_arr = (ctypes.c_int32 * max(nb, 1))(*(bounds or [0]))
        out = (ctypes.c_int32 * cap)()
        n = self._lib.bpe_encode_bounded(self._handle, data, len(data),
                                         b_arr, nb, out, cap)
        if n < 0:
            raise RuntimeError(f"bpe_encode_bounded overflowed {cap} ids")
        return list(out[:n])

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.bpe_destroy(handle)


def load(ranks: dict[bytes, int],
         merge_ranks: dict[bytes, int] | None = None) -> NativeBPE:
    return NativeBPE(ranks, merge_ranks)
