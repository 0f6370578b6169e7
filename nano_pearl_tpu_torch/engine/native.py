"""ctypes binding of the port's native block manager
(``nano_pearl_tpu_torch/native/block_manager.cc``; counterpart of the JAX
package's engine/native.py).

``NativeBlockManager`` has the interface of the Python ``BlockManager``
(engine/block_manager.py), ``shards`` included, and takes the same
decisions: the same blocks, the same prefix hits, the same BLAKE2b chain
digests (``native_chain_hash`` == ``chain_hash``). The scheduler uses it
under ``PearlConfig(native_block_manager=True)``.

The library builds at first use with ``g++ -O2 -shared -fPIC -std=c++17``
into ``build/native/`` at the repository root, under a file name that
carries a hash of the source and flags (a changed source rebuilds). A
missing compiler or a failed build raises: asked for the native manager,
the engine runs it or stops, it never falls back to the Python one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from nano_pearl_tpu_torch.engine.sequence import SeqView

SOURCE = Path(__file__).resolve().parents[1] / "native" / "block_manager.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else g++."""
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpearl_block_manager-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    RuntimeError when the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native block manager: cannot run {cmd[0]!r} ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native block manager: {cmd[0]} failed (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: processes that build one source at once end with one library
    return out


def load_native_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises on failure)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.bm_create.restype = ctypes.c_void_p
    lib.bm_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.bm_destroy.argtypes = [ctypes.c_void_p]
    lib.bm_num_free.restype = ctypes.c_int
    lib.bm_num_free.argtypes = [ctypes.c_void_p]
    lib.bm_chain_hash.restype = ctypes.c_uint64
    lib.bm_chain_hash.argtypes = [_i64p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
    lib.bm_allocate.restype = ctypes.c_int
    lib.bm_allocate.argtypes = [ctypes.c_void_p, _i64p, ctypes.c_int, ctypes.c_int, _i32p]
    lib.bm_deallocate.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int]
    lib.bm_rollback.restype = ctypes.c_int
    lib.bm_rollback.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int, ctypes.c_int]
    lib.bm_ensure.restype = ctypes.c_int
    lib.bm_ensure.argtypes = [
        ctypes.c_void_p, _i64p, ctypes.c_int, ctypes.c_int, _i32p, ctypes.c_int, ctypes.c_int,
    ]
    lib.bm_clear_prefix_cache.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _i64(a) -> tuple[np.ndarray, object]:
    arr = np.ascontiguousarray(a, dtype=np.int64)
    return arr, arr.ctypes.data_as(_i64p)


def _i32(a) -> tuple[np.ndarray, object]:
    arr = np.ascontiguousarray(a, dtype=np.int32)
    return arr, arr.ctypes.data_as(_i32p)


def native_chain_hash(token_ids, prefix: int = -1) -> int:
    """``engine/block_manager.chain_hash`` computed by the library."""
    toks, ptr = _i64(token_ids)
    return int(load_native_lib().bm_chain_hash(ptr, len(toks), prefix & (2**64 - 1), int(prefix != -1)))


class NativeBlockManager:
    """The Python ``BlockManager``'s interface over the C library."""

    def __init__(self, num_blocks: int, block_size: int, shards: int = 1):
        self._lib = load_native_lib()
        self._h = self._lib.bm_create(num_blocks, block_size, shards)
        if not self._h:
            raise ValueError(f"{num_blocks} blocks + the garbage block do not divide over {shards} shards")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.shards = shards

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bm_destroy(self._h)
            self._h = None

    @property
    def num_free_blocks(self) -> int:
        return self._lib.bm_num_free(self._h)

    def can_allocate(self, view: SeqView) -> bool:
        return self.num_free_blocks >= view.num_blocks

    def allocate(self, view: SeqView):
        assert not view.block_table
        toks, tp = _i64(view.token_ids)
        out, op = _i32(np.zeros(view.num_blocks))
        cached = self._lib.bm_allocate(self._h, tp, len(toks), view.num_cached_tokens, op)
        if cached < 0:
            raise RuntimeError("out of KV blocks")
        view.block_table = out.tolist()
        view.num_cached_tokens = cached

    def deallocate(self, view: SeqView):
        if view.block_table:
            table, ptr = _i32(view.block_table)  # released last page first, as the Python manager
            self._lib.bm_deallocate(self._h, ptr, len(table))
        view.block_table.clear()
        view.num_cached_tokens = 0

    def rollback(self, view: SeqView, n: int):
        view.truncate(n)
        table, ptr = _i32(view.block_table)
        keep = self._lib.bm_rollback(self._h, ptr, len(table), len(view))
        del view.block_table[keep:]

    def blocks_needed(self, view: SeqView, extra_tokens: int) -> int:
        return max(0, -(-(len(view) + extra_tokens) // self.block_size) - len(view.block_table))

    def can_ensure(self, view: SeqView, extra_tokens: int) -> bool:
        return self.num_free_blocks >= self.blocks_needed(view, extra_tokens)

    def ensure_capacity(self, view: SeqView, extra_tokens: int):
        cap = max(-(-(len(view) + extra_tokens) // self.block_size), len(view.block_table))
        table = np.zeros((cap,), np.int32)
        table[: len(view.block_table)] = view.block_table
        toks, tp = _i64(view.token_ids)
        new_len = self._lib.bm_ensure(
            self._h, tp, len(toks), extra_tokens, table.ctypes.data_as(_i32p), len(view.block_table), cap,
        )
        if new_len < 0:
            raise RuntimeError("out of KV blocks")
        view.block_table = table[:new_len].tolist()

    def clear_prefix_cache(self):
        self._lib.bm_clear_prefix_cache(self._h)
