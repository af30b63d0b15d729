"""Native (C++) host libraries, loaded with ctypes.

Counterpart of `hcrag_tpu/native/__init__.py`, over the same sources
(`fasthash.cpp`: the hashing embedder's `embed_batch` and `bucket_df`;
`wordpiece.cpp`: the WordPiece tokenizer).  Each source is compiled by g++
at first use into `hcrag_tpu_torch/_kernels_build/lib<name>-<hash>.so`
(the directory the CUDA kernels build into, which `.gitignore` lists); the
hash covers the source and the flags, so an edited source is never served
a stale library.  Every entry point has a pure-Python fallback in its
caller: a missing toolchain makes `available()` false and the functions
here return None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_kernels_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
SOURCES = ("fasthash", "wordpiece")

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def library_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, bool]:
    """Compile every named library that is missing, one g++ process each,
    all started together.  Returns {name: built or present}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        try:
            procs[name] = (subprocess.Popen(
                ["g++", *GXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            ), tmp, target)
        except OSError:  # no g++
            procs[name] = (None, tmp, target)
    for name, (proc, tmp, target) in procs.items():
        ok = False
        if proc is not None:
            try:
                ok = proc.wait(timeout=120) == 0
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if ok:
            os.replace(tmp, target)
        else:
            tmp.unlink(missing_ok=True)
    return {name: library_path(name).exists() for name in names}


def _bind_fasthash(lib: ctypes.CDLL) -> None:
    lib.embed_batch.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float32, flags="C"),
    ]
    lib.embed_batch.restype = None
    lib.bucket_df.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
    ]
    lib.bucket_df.restype = None


def _bind_wordpiece(lib: ctypes.CDLL) -> None:
    lib.wp_create.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_int64,
    ]
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_destroy.restype = None
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
    ]
    lib.wp_encode_batch.restype = None


_BINDERS = {"fasthash": _bind_fasthash, "wordpiece": _bind_wordpiece}


def _load(name: str) -> Optional[ctypes.CDLL]:
    """The named library, built at first use; None when it cannot be built
    or loaded (remembered, so a missing g++ is tried once)."""
    with _lock:
        if name not in _libs:
            lib = None
            if build([name])[name]:
                try:
                    lib = ctypes.CDLL(str(library_path(name)))
                    _BINDERS[name](lib)
                except OSError:
                    lib = None
            _libs[name] = lib
        return _libs[name]


def available() -> bool:
    """True when the hashing embedder's library builds and loads."""
    return _load("fasthash") is not None


def _pack(texts: Sequence[str]):
    encoded = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def embed_batch(
    texts: Sequence[str],
    dim: int,
    *,
    use_bigrams: bool = True,
    idf: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Native hashing embed [len(texts), dim] f32; None when the library is
    unavailable."""
    lib = _load("fasthash")
    if lib is None:
        return None
    blob, offsets = _pack(texts)
    out = np.zeros((len(texts), dim), dtype=np.float32)
    idf_ptr = None
    if idf is not None:
        idf = np.ascontiguousarray(idf, dtype=np.float64)
        idf_ptr = idf.ctypes.data_as(ctypes.c_void_p)
    lib.embed_batch(blob, offsets, len(texts), dim, int(use_bigrams), idf_ptr, out)
    return out


def bucket_df(
    texts: Sequence[str], dim: int, *, use_bigrams: bool = True
) -> Optional[np.ndarray]:
    """Native per-bucket document frequencies [dim] int64; None when the
    library is unavailable."""
    lib = _load("fasthash")
    if lib is None:
        return None
    blob, offsets = _pack(texts)
    df = np.zeros(dim, dtype=np.int64)
    lib.bucket_df(blob, offsets, len(texts), dim, int(use_bigrams), df)
    return df


class NativeWordPiece:
    """Handle over the C++ WordPiece tokenizer.  `create` returns None when
    the library is unavailable; callers keep the Python path."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle

    @classmethod
    def create(cls, vocab_words: Sequence[str]) -> Optional["NativeWordPiece"]:
        lib = _load("wordpiece")
        if lib is None:
            return None
        blob, offsets = _pack(vocab_words)
        return cls(lib, lib.wp_create(blob, offsets, len(vocab_words)))

    def encode_batch(
        self, texts: Sequence[str], max_len: int, *, lowercase: bool,
        cls_id: int, sep_id: int, unk_id: int,
    ):
        """(ids [B, max_len] int32, mask [B, max_len] int32)."""
        blob, offsets = _pack(texts)
        ids = np.zeros((len(texts), max_len), dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=np.int32)
        self._lib.wp_encode_batch(
            self._handle, blob, offsets, len(texts),
            np.int32(max_len), np.int32(lowercase),
            np.int32(cls_id), np.int32(sep_id), np.int32(unk_id),
            ids, mask,
        )
        return ids, mask

    def __del__(self):
        try:
            if self._handle:
                self._lib.wp_destroy(self._handle)
        except Exception:
            pass
