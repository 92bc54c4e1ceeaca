"""ctypes binding of the native host library (fastdata.cpp): the ASCII
WordPiece fast path and the base64 span decoder of the input pipeline.

This package's copy of the JAX package's `native/__init__.py`. The library is
built with the host C++ compiler at first use (not at import) into
`mvp_pytorch_tpu_torch/_build/`, keyed on a hash of the source, and never
loaded from a prebuilt file. Every entry point has a pure-Python path with
the same output (`data/tokenization.py`, `base64.b64decode`), taken when the
library cannot be built; `available()` says which path runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from typing import List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastdata.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ["-O3", "-shared", "-fPIC"]
_MAX_TOKENS = 4096


def _build() -> str:
    """Compile fastdata.cpp into _build/ (once per source hash) and return
    the library's path. Processes that build at once each write a temporary
    file and rename it, so a reader never sees a partial library."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    path = os.path.join(_BUILD, f"libfastdata-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


@functools.cache
def _lib() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.SubprocessError):
        return None          # no compiler or a failed build: pure Python
    lib.vocab_create.restype = ctypes.c_void_p
    lib.vocab_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_int32]
    lib.vocab_finalize.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vocab_free.argtypes = [ctypes.c_void_p]
    lib.vocab_size.argtypes = [ctypes.c_void_p]
    lib.vocab_size.restype = ctypes.c_int32
    lib.tokenize_ascii.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int32,
                                   ctypes.POINTER(ctypes.c_int32),
                                   ctypes.c_int32]
    lib.tokenize_ascii.restype = ctypes.c_int32
    lib.b64_decode_at.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int64]
    lib.b64_decode_at.restype = ctypes.c_int64
    return lib


def available() -> bool:
    """Whether the native library is built and loaded (building it on the
    first call)."""
    return _lib() is not None


class NativeVocab:
    """Immutable native vocab handle for FastBertTokenizer."""

    def __init__(self, vocab: dict, unk_token: str = "[UNK]"):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native fastdata library unavailable")
        self._lib = lib
        self._h = lib.vocab_create()
        for tok, idx in vocab.items():
            lib.vocab_add(self._h, tok.encode("utf-8"), idx)
        lib.vocab_finalize(self._h, vocab.get(unk_token, 1))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vocab_free(self._h)
            self._h = None


def tokenize_ascii(nv: NativeVocab, text: str) -> Optional[List[int]]:
    """Tokenize to ids; None if text needs the Python unicode path."""
    raw = text.encode("utf-8", errors="strict")
    out = (ctypes.c_int32 * _MAX_TOKENS)()
    n = nv._lib.tokenize_ascii(nv._h, raw, len(raw), out, _MAX_TOKENS)
    if n < 0:
        return None
    return list(out[:n])


def b64_decode_at(buf: bytes, start: int, length: int, out) -> int:
    """Decode the base64 span buf[start:start+length] directly into `out`
    (a writable C-contiguous uint8 numpy array). Returns the decoded byte
    count, or -1 when the span is not clean contiguous base64 or `out` is
    too small; callers then fall back to base64.b64decode. Needs
    `available()`."""
    if not (0 <= start and 0 <= length and start + length <= len(buf)):
        raise ValueError(f"span [{start}, {start + length}) outside a "
                         f"buffer of {len(buf)} bytes")
    if out.dtype.itemsize != 1 or not out.flags.c_contiguous:
        raise ValueError("out must be a C-contiguous uint8 array")
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return _lib().b64_decode_at(buf, start, length, ptr, out.size)
