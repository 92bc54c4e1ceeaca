"""WordPiece tokenizer: this package's copy of the JAX package's
`data/tokenization.py`, with the same ids on either path of
`FastBertTokenizer`.

Capability parity with the vendored BertTokenizer
(reference `transformers/pytorch_transformers/tokenization_bert.py:86-436`):
basic tokenization (lowercase, accent stripping, punctuation split, CJK
handling) + greedy longest-match WordPiece with "##" continuations, vocab.txt
round-trip, and the save/load directory contract. Written from the standard
published algorithm; behavior (not code) mirrors the reference.
"""

from __future__ import annotations

import collections
import os
import unicodedata
from typing import Dict, Iterable, List, Optional

VOCAB_NAME = "vocab.txt"


def load_vocab(vocab_file: str) -> "collections.OrderedDict[str, int]":
    vocab = collections.OrderedDict()
    with open(vocab_file, encoding="utf-8") as f:
        for idx, line in enumerate(f):
            tok = line.rstrip("\n")
            vocab[tok] = idx
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True,
                 never_split: Iterable[str] = ("[UNK]", "[SEP]", "[PAD]",
                                               "[CLS]", "[MASK]")):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._tokenize_cjk(text)
        out = []
        for tok in text.strip().split():
            if tok in self.never_split:
                out.append(tok)
                continue
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            out.extend(self._split_punct(tok))
        return " ".join(out).strip().split()

    @staticmethod
    def _clean(text: str) -> str:
        return "".join(
            " " if _is_whitespace(c) else c
            for c in text if ord(c) != 0 and ord(c) != 0xFFFD and not _is_control(c))

    @staticmethod
    def _tokenize_cjk(text: str) -> str:
        return "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        out: List[List[str]] = []
        new_word = True
        for c in tok:
            if _is_punctuation(c):
                out.append([c])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(c)
        return ["".join(p) for p in out]


class WordpieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        out = []
        for token in text.strip().split():
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            start, bad, subs = 0, False, []
            while start < len(chars):
                end = len(chars)
                cur = None
                while start < end:
                    sub = "".join(chars[start:end])
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                subs.append(cur)
                start = end
            out.extend([self.unk_token] if bad else subs)
        return out


class BertTokenizer:
    """vocab.txt-backed tokenizer with the reference's public surface:
    tokenize / convert_tokens_to_ids / convert_ids_to_tokens /
    save_pretrained / from_pretrained, and cls/sep/mask/pad conveniences."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 do_basic_tokenize: bool = True):
        if not os.path.isfile(vocab_file):
            raise FileNotFoundError(vocab_file)
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.do_basic_tokenize = do_basic_tokenize
        self.basic_tokenizer = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece_tokenizer = WordpieceTokenizer(self.vocab)

    # --- special tokens ---
    unk_token = "[UNK]"
    sep_token = "[SEP]"
    pad_token = "[PAD]"
    cls_token = "[CLS]"
    mask_token = "[MASK]"

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __len__(self) -> int:
        return len(self.vocab)

    # the reference splits special tokens out of the RAW text before basic
    # tokenization (PreTrainedTokenizer.tokenize split_on_tokens,
    # tokenization_utils.py:350-362), so embedded/punctuation-adjacent
    # specials ("x[SEP]y", "[MASK],") stay whole — whitespace-level
    # never_split alone does not reproduce that (oracle-caught divergence,
    # tests/test_tokenizer_parity.py)
    all_special_tokens = (unk_token, sep_token, pad_token, cls_token,
                          mask_token)

    def tokenize(self, text: str) -> List[str]:
        def split_on_tokens(tok_list, txt):
            if not txt:
                return []
            if not tok_list:
                return self._wp_tokenize(txt)
            tok = tok_list[0]
            parts = txt.split(tok)
            out: List[str] = []
            for i, sub in enumerate(parts):
                out.extend(split_on_tokens(tok_list[1:], sub.strip()))
                if i < len(parts) - 1:
                    out.append(tok)
            return out

        return split_on_tokens(self.all_special_tokens, text)

    def _wp_tokenize(self, text: str) -> List[str]:
        if self.do_basic_tokenize:
            toks = []
            for t in self.basic_tokenizer.tokenize(text):
                toks.extend(self.wordpiece_tokenizer.tokenize(t))
            return toks
        return self.wordpiece_tokenizer.tokenize(text)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.vocab[self.unk_token])
        return [self.vocab.get(t, self.vocab[self.unk_token]) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            return self.ids_to_tokens.get(ids, self.unk_token)
        return [self.ids_to_tokens.get(i, self.unk_token) for i in ids]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def save_pretrained(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, VOCAB_NAME)
        with open(path, "w", encoding="utf-8") as f:
            for tok in self.vocab:  # insertion order == index order
                f.write(tok + "\n")
        return path

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "BertTokenizer":
        if os.path.isdir(path):
            path = os.path.join(path, VOCAB_NAME)
        return cls(path, **kwargs)


class FastBertTokenizer(BertTokenizer):
    """BertTokenizer with the native C++ fast path for ASCII text.

    Same algorithm, same outputs (tested against the Python path); unicode
    text goes through the Python implementation. It pickles without its
    native handle and rebuilds it when unpickled, so a dataset holding it
    can be sent to a spawned loader worker."""

    def __init__(self, vocab_file: str, **kwargs):
        super().__init__(vocab_file, **kwargs)
        self._attach_native()

    def _attach_native(self) -> None:
        self._native = None
        # the C path hardcodes lowercasing + punctuation splitting, so it
        # is only equivalent to the default configuration
        if not (self.do_basic_tokenize
                and self.basic_tokenizer.do_lower_case):
            return
        from .. import native
        if native.available():
            self._nv = native.NativeVocab(dict(self.vocab), self.unk_token)
            self._native = native
        # inputs the C path tokenizes DIFFERENTLY from the Python path:
        # embedded special tokens (never_split keeps them whole) and DEL
        # (a control char the Python cleaner strips) route to Python
        self._py_only = tuple(self.basic_tokenizer.never_split) + ("\x7f",)

    def __getstate__(self):
        state = dict(self.__dict__)
        for k in ("_native", "_nv"):
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._attach_native()

    @property
    def native_active(self) -> bool:
        return self._native is not None

    def _native_ids(self, text: str):
        if self._native is None or any(s in text for s in self._py_only):
            return None
        ids = self._native.tokenize_ascii(self._nv, text)
        # the C buffer caps at 4096 tokens: a full buffer may be a
        # truncation — redo such (rare, pathological) inputs in Python
        if ids is not None and len(ids) >= 4096:
            return None
        return ids

    def encode(self, text: str):
        ids = self._native_ids(text)
        if ids is not None:
            return ids
        return super().encode(text)

    def tokenize(self, text: str):
        ids = self._native_ids(text)
        if ids is not None:
            return self.convert_ids_to_tokens(ids)
        return super().tokenize(text)
