"""ctypes bindings for the native C++ scan engine.

Builds ``scan.cpp`` lazily with g++ on first use and exposes numpy-friendly
wrappers.  The library in ``native/build/`` is named by a hash of the
source, the compiler flags and the machine (``-march=native`` code is
specific to the CPU that built it), so a checkout copied to another
machine builds its own.  If no C++ toolchain is available the import
still succeeds; ``available()`` reports False and callers fall back to the
pure-Python oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE / "build"
_SRC = _HERE / "scan.cpp"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


_BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_FLAG_LADDER = (("-march=native", "-fopenmp"), ("-fopenmp",), ())


def _build_key() -> str:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(repr((_BASE_FLAGS, _FLAG_LADDER)).encode())
    h.update(repr(platform.uname()).encode())
    return h.hexdigest()[:16]


def _build() -> Optional[Path]:
    _BUILD_DIR.mkdir(exist_ok=True)
    so_path = _BUILD_DIR / f"libh2rscan-{_build_key()}.so"
    if so_path.exists():
        return so_path
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    for flags in _FLAG_LADDER:
        cmd = ["g++", *flags, *_BASE_FLAGS, str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired):
            continue
        os.replace(tmp, so_path)  # atomic: concurrent builders race safely
        return so_path
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    lib.h2r_scan_states.argtypes = [u8p, i32p, i64, i64, i32p, i32, i32, i32, i32p]
    lib.h2r_substr_scan.argtypes = [
        i32p, i32p, i64, i64, i32p, i32, u8p, u8p, i64, i32p, i32p, i32p,
    ]
    lib.h2r_mask_fsm.argtypes = [i32p, i32p, i32p, i64, i64, i32p, i32p, i32p]
    lib.h2r_pack_lines.argtypes = [
        u8p, i64, i64, i32, u8p, i32p, ctypes.POINTER(i64), i32,
    ]
    lib.h2r_pack_lines.restype = i64
    lib.h2r_num_threads.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def num_threads() -> int:
    lib = _load()
    return lib.h2r_num_threads() if lib else 0


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def scan_states(
    chars: np.ndarray,
    lengths: np.ndarray,
    transition: np.ndarray,
    first_state: int,
    dummy_state: int,
) -> np.ndarray:
    """Batched sequential DFA scan. chars [B, L] uint8, transition [256, S]
    int32 (C-contiguous). Returns states [B, L+1] int32 with padding
    semantics matching the oracle."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    chars = np.ascontiguousarray(chars, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    transition = np.ascontiguousarray(transition, np.int32)
    B, L = chars.shape
    S = transition.shape[1]
    out = np.empty((B, L + 1), np.int32)
    lib.h2r_scan_states(
        _u8p(chars), _i32p(lengths), B, L, _i32p(transition), S,
        int(first_state), int(dummy_state), _i32p(out),
    )
    return out


def substr_scan(
    states: np.ndarray,
    lengths: np.ndarray,
    substr_table: np.ndarray,
    is_start_table: np.ndarray,
    is_end_table: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Substr ids + start/end flags for one def. states [B, L+1] (raw, i.e.
    real states in rows 0..len). Returns (ids [B,L], is_start [B,L+1],
    is_end [B,L+1])."""
    lib = _load()
    assert lib is not None
    states = np.ascontiguousarray(states, np.int32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    substr_table = np.ascontiguousarray(substr_table, np.int32)
    ist = np.ascontiguousarray(is_start_table, np.uint8)
    iet = np.ascontiguousarray(is_end_table, np.uint8)
    B = states.shape[0]
    L = states.shape[1] - 1
    S = substr_table.shape[1]
    assert ist.shape[1] == S and iet.shape[1] == S
    ids = np.empty((B, L), np.int32)
    iso = np.empty((B, L + 1), np.int32)
    ieo = np.empty((B, L + 1), np.int32)
    lib.h2r_substr_scan(
        _i32p(states), _i32p(lengths), B, L, _i32p(substr_table), S,
        _u8p(ist), _u8p(iet), ist.shape[0], _i32p(ids), _i32p(iso), _i32p(ieo),
    )
    return ids, iso, ieo


def mask_fsm(
    id_sum: np.ndarray, is_start_sum: np.ndarray, is_end_sum: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Forward/backward mask FSMs. Returns (fwd, bwd, mask), each [B, L]."""
    lib = _load()
    assert lib is not None
    id_sum = np.ascontiguousarray(id_sum, np.int32)
    iss = np.ascontiguousarray(is_start_sum, np.int32)
    ies = np.ascontiguousarray(is_end_sum, np.int32)
    B, L = id_sum.shape
    fwd = np.empty((B, L), np.int32)
    bwd = np.empty((B, L), np.int32)
    msk = np.empty((B, L), np.int32)
    lib.h2r_mask_fsm(_i32p(id_sum), _i32p(iss), _i32p(ies), B, L,
                     _i32p(fwd), _i32p(bwd), _i32p(msk))
    return fwd, bwd, msk


def pack_lines(
    data: bytes, max_len: int, keep_newline: bool = False
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Split a newline-delimited corpus buffer into a padded batch.
    Returns (chars [N, max_len] uint8, lengths [N] int32, n_truncated).
    ``keep_newline`` restores each terminated line's ``\\n`` byte."""
    lib = _load()
    assert lib is not None
    nl = 1 if keep_newline else 0
    buf = np.frombuffer(data, np.uint8)
    n = lib.h2r_pack_lines(_u8p(buf), buf.size, max_len, 1, None, None, None, nl)
    # np.empty, not zeros: the fill pass writes every byte of every row
    # (memcpy + memset padding), so zeroing here would re-clear the whole
    # batch buffer a second time.
    chars = np.empty((n, max_len), np.uint8)
    lengths = np.empty((n,), np.int32)
    trunc = ctypes.c_int64(0)
    lib.h2r_pack_lines(
        _u8p(buf), buf.size, max_len, 0, _u8p(chars), _i32p(lengths),
        ctypes.byref(trunc), nl,
    )
    return chars, lengths, int(trunc.value)


def match_substrs_native(model, chars: np.ndarray, lengths: np.ndarray):
    """Full witness generation using the native engine for a
    CompiledRegexModel — combines per-def native passes; output fields match
    ops.reference bit-for-bit (subset: the columns needed for extraction).
    Returns a dict of arrays."""
    lib = _load()
    assert lib is not None
    chars = np.ascontiguousarray(chars, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    B, L = chars.shape
    n_defs = model.n_defs
    S = model.s_pad
    id_sum = np.zeros((B, L), np.int32)
    iss_sum = np.zeros((B, L + 1), np.int32)
    ies_sum = np.zeros((B, L + 1), np.int32)
    accepted = np.zeros((B, n_defs), bool)
    has_dead = np.zeros((B, n_defs), bool)
    states_all = []
    ids_all = []
    for d in range(n_defs):
        raw = scan_states(
            chars, lengths, model.transition[d],
            int(model.first_states[d]), int(model.dummy_states[d]),
        )
        # raw rows beyond len already carry dummy; rows 0..len are real.
        final = raw[np.arange(B), lengths]
        accepted[:, d] = final == int(model.accepted_states[d])
        has_dead[:, d] = final == int(model.dead_states[d])
        ids, iso, ieo = substr_scan(
            raw, lengths, model.substr_id_table[d],
            model.is_start_table, model.is_end_table,
        )
        id_sum += ids
        iss_sum += iso
        ies_sum += ieo
        states_all.append(raw)
        ids_all.append(ids)
    fwd, bwd, msk = mask_fsm(id_sum, iss_sum, ies_sum)
    pos = np.arange(L)[None, :]
    enable = (pos < lengths[:, None]).astype(np.int32)
    chars_i32 = chars.astype(np.int32) * enable
    return dict(
        all_enable_flags=enable,
        all_characters=chars_i32,
        all_substr_ids=msk * id_sum,
        masked_characters=msk * chars_i32,
        states=np.stack(states_all, 1),
        substr_ids_per_def=np.stack(ids_all, 1),
        substr_id_sum=id_sum,
        is_start_sum=iss_sum,
        is_end_sum=ies_sum,
        fwd_mask=fwd,
        bwd_mask=bwd,
        mask=msk,
        accepted=accepted,
        has_dead=has_dead,
        match_ok=accepted.all(1) & ~has_dead.any(1),
    )
