"""Device-side run extraction: masked witness columns -> compact tuples.

``extract_substrings`` (ops/reference.py) decodes masked runs on the HOST,
which means shipping the full [B, L] masked columns back per batch.  For
corpus scanning at GB/s that traffic dwarfs the matches; this module
decodes the runs ON DEVICE into fixed-shape compact arrays — one
(offset, length, id, bytes) record per extracted substring — so only
O(B * max_runs * max_len) bytes leave the chip.

Pure XLA with no data-dependent shapes, so it fuses onto any backend's
output and works under jit/shard_map.  Per-run fields are computed as
masked min/max REDUCTIONS over the position axis (max_runs is small and
static) rather than a scatter over the full [B, L] domain, so the whole
record set is a few fused vector passes.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np


def extract_runs(
    all_substr_ids: jnp.ndarray,  # [B, L] masked ids (0 = no substring)
    masked_characters: jnp.ndarray,  # [B, L]
    max_runs: int = 4,
    max_len: int = 0,  # 0 = skip byte payloads
) -> Dict[str, jnp.ndarray]:
    """Decode masked runs into fixed-shape arrays.

    Returns ``offsets``/``lengths``/``ids`` of shape [B, max_runs]
    (``offsets`` = -1 past the last run), ``n_runs`` [B] (the TRUE run
    count, so ``n_runs > max_runs`` flags dropped runs), and — when
    ``max_len`` > 0 — ``bytes`` [B, max_runs, max_len] uint8, zero padded.
    """
    # Barrier: the masked columns typically arrive straight out of the
    # witness pipeline's decode tail; without it XLA fuses that decode
    # into EACH of the max_runs x 3 masked reductions below, recomputing
    # the expensive transpose per reduction (measured 54 ms vs ~7 ms for
    # the whole serving pipeline at B=32k on the v5e).  masked_characters
    # joins the barrier only when byte payloads are requested — otherwise
    # it stays untouched (and dead-code-eliminated if unused upstream).
    if max_len:
        all_substr_ids, masked_characters = jax.lax.optimization_barrier(
            (jnp.asarray(all_substr_ids), jnp.asarray(masked_characters))
        )
    else:
        all_substr_ids = jax.lax.optimization_barrier(
            jnp.asarray(all_substr_ids)
        )
    a = all_substr_ids
    B, L = a.shape
    zcol = jnp.zeros((B, 1), a.dtype)
    prev = jnp.concatenate([zcol, a[:, :-1]], axis=1)
    nxt = jnp.concatenate([a[:, 1:], zcol], axis=1)
    is_start = (a != 0) & (a != prev)
    is_end = (a != 0) & (a != nxt)

    run_idx = jnp.cumsum(is_start, axis=1) - 1  # [B, L], valid where a != 0
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]

    # Per-run fields as masked reductions over the position axis: run r's
    # slot selects positions with run_idx == r (max_runs static and
    # small, so this is [B, R, L] generator work XLA fuses into the
    # reductions — no scatter; see module docstring).
    r_ids = jnp.arange(max_runs, dtype=run_idx.dtype)[None, :, None]
    at_start = is_start[:, None, :] & (run_idx[:, None, :] == r_ids)
    at_end = is_end[:, None, :] & (run_idx[:, None, :] == r_ids)
    big = jnp.int32(L)
    offsets_raw = jnp.min(
        jnp.where(at_start, pos[:, None, :], big), axis=2
    )  # [B, R]; L = no such run
    ends = jnp.max(jnp.where(at_end, pos[:, None, :], -1), axis=2)
    ids = jnp.max(
        jnp.where(at_start, a[:, None, :].astype(jnp.int32), 0), axis=2
    )
    offsets = jnp.where(offsets_raw < big, offsets_raw, -1)
    lengths = jnp.where(offsets >= 0, ends - offsets + 1, 0)
    n_runs = is_start.sum(axis=1).astype(jnp.int32)

    out = dict(offsets=offsets, lengths=lengths, ids=ids, n_runs=n_runs)
    if max_len:
        chars = jnp.asarray(masked_characters)
        # gather a max_len window from each run start (clamped; masked
        # chars are 0 outside runs so over-reads self-clean)
        base = jnp.clip(offsets, 0, L - 1)  # [B, R]
        win = base[:, :, None] + jnp.arange(max_len)[None, None, :]
        win = jnp.clip(win, 0, L - 1)
        # one [B, R*max_len] gather on the original rows (no [B, R, L]
        # broadcast copy of the input)
        payload = jnp.take_along_axis(
            chars,
            win.reshape(B, max_runs * max_len).astype(jnp.int32),
            axis=1,
        ).reshape(B, max_runs, max_len)
        inlen = jnp.arange(max_len)[None, None, :] < lengths[:, :, None]
        valid = (offsets >= 0)[:, :, None]
        out["bytes"] = jnp.where(valid & inlen, payload, 0).astype(jnp.uint8)
    return out


def runs_to_python(out: Dict[str, jnp.ndarray], row: int):
    """Host-side view of one string's runs as (offset, text, id) tuples
    (mirrors ops/reference.extract_substrings)."""
    offs = np.asarray(out["offsets"][row])
    ids = np.asarray(out["ids"][row])
    res = []
    if "bytes" in out:
        payload = np.asarray(out["bytes"][row])
        lens = np.asarray(out["lengths"][row])
        for r in range(offs.shape[0]):
            if offs[r] < 0:
                break
            res.append(
                (
                    int(offs[r]),
                    bytes(payload[r][: lens[r]]).decode("latin-1"),
                    int(ids[r]),
                )
            )
    else:
        for r in range(offs.shape[0]):
            if offs[r] < 0:
                break
            res.append((int(offs[r]), None, int(ids[r])))
    return res
