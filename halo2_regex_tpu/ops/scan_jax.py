"""Batched DFA scan + witness generation on XLA (jit, any backend).

The tensorized equivalent of the reference's host-side witness generation
(reference: src/lib.rs:311-773, 804-888), vectorized over a batch of padded
byte strings. The per-byte recurrence runs as a ``lax.scan`` over sequence
positions carrying one state per (batch, def) lane — each step is a single
fused gather, so throughput scales with the batch dimension, which is the
production workload shape (BASELINE configs[2]: 4096-string corpora).

For long single strings / sequence sharding, see
:func:`prefix_transition_maps` and ``parallel.seq_parallel`` — the DFA
transition maps form a monoid under composition ``(g ∘ f)(x) = g[f[x]]``,
scanned with ``jax.lax.associative_scan``.

All outputs are bit-identical to :mod:`halo2_regex_tpu.ops.reference`
(enforced by tests/test_jax_scan.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models.compiled import CompiledRegexModel
from ..witness.result import RegexResult


def _model_arrays(model: CompiledRegexModel) -> dict:
    """The device-side constants of a model as a dict of jnp arrays."""
    return dict(
        transition=jnp.asarray(model.transition),
        substr_id_table=jnp.asarray(model.substr_id_table),
        first_states=jnp.asarray(model.first_states),
        accepted_states=jnp.asarray(model.accepted_states),
        accept_mask=jnp.asarray(model.accept_mask),
        dummy_states=jnp.asarray(model.dummy_states),
        dead_states=jnp.asarray(model.dead_states),
        is_start_table=jnp.asarray(model.is_start_table),
        is_end_table=jnp.asarray(model.is_end_table),
    )


def scan_states(transition: jnp.ndarray, first_state, chars: jnp.ndarray):
    """Run the per-byte DFA recurrence for one def over a batch.

    Args:
      transition: int32 [256, S] next-state table (DEAD-completed).
      first_state: scalar initial state.
      chars: uint8/int32 [B, L] padded input bytes.

    Returns:
      int32 [B, L+1] raw state sequences (state 0 is the initial state;
      padding positions keep transitioning on byte 0 — callers mask).
    """
    B, L = chars.shape
    S = transition.shape[-1]
    t_flat = transition.reshape(-1)
    c_t = chars.astype(jnp.int32).T  # [L, B] for scan over positions

    def step(state, c):
        nxt = jnp.take(t_flat, c * S + state)
        return nxt, nxt

    init = jnp.full((B,), first_state, jnp.int32)
    _, seq = jax.lax.scan(step, init, c_t)
    return jnp.concatenate([init[None, :], seq], axis=0).T  # [B, L+1]


def prefix_transition_maps(transition: jnp.ndarray, chars: jnp.ndarray):
    """All-prefix composed transition maps via ``associative_scan``.

    Args:
      transition: int32 [256, S].
      chars: int32 [L] byte sequence (single string).

    Returns:
      int32 [L, S]: ``maps[i][s]`` = state after consuming ``chars[:i+1]``
      starting from state ``s``. Work O(L·S·log L); use for sequence-sharded
      scans where the L axis is split across devices.
    """
    per_byte = transition[chars.astype(jnp.int32)]  # [L, S]

    def compose(f, g):
        # apply f then g: (g ∘ f)[x] = g[f[x]]
        return jnp.take_along_axis(g, f, axis=-1)

    return jax.lax.associative_scan(compose, per_byte, axis=0)


def _match_core(arrays: dict, n_defs: int, chars: jnp.ndarray, lengths: jnp.ndarray):
    """Witness generation for a batch. Returns a dict of arrays.

    All defs run in ONE ``lax.scan`` (the carry is [B, n_defs] states and
    each step one fused gather over the def-stacked flat table) — per-step
    overhead dominates this path, so def-vectorizing is an n_defs-x win
    for multi-def models."""
    B, L = chars.shape
    S = arrays["transition"].shape[-1]
    pos = jnp.arange(L, dtype=jnp.int32)
    enable = (pos[None, :] < lengths[:, None]).astype(jnp.int32)  # [B, L]
    chars_i32 = chars.astype(jnp.int32) * enable  # zero padding bytes

    t_all = arrays["transition"].reshape(-1)  # [n_defs*256*S]
    d_off = (jnp.arange(n_defs, dtype=jnp.int32) * (256 * S))[None, :]
    c_t = chars.astype(jnp.int32).T  # [L, B]

    def step(state, c):  # state [B, n_defs]
        nxt = jnp.take(t_all, d_off + c[:, None] * S + state)
        return nxt, nxt

    init = jnp.broadcast_to(arrays["first_states"][None, :], (B, n_defs)).astype(
        jnp.int32
    )
    _, seq = jax.lax.scan(step, init, c_t)  # [L, B, n_defs]
    raw = jnp.concatenate([init[None], seq], axis=0)  # [L+1, B, n_defs]
    raw = jnp.moveaxis(raw, 0, 2)  # [B, n_defs, L+1]

    posL1 = jnp.arange(L + 1, dtype=jnp.int32)
    in_range = posL1[None, None, :] <= lengths[:, None, None]
    dummy = arrays["dummy_states"][None, :, None]
    states = jnp.where(in_range, raw, dummy)  # [B, n_defs, L+1]

    # substr ids on transitions (lib.rs:825-845); 0 beyond the input.
    sub_all = arrays["substr_id_table"].reshape(-1)  # [n_defs*S*S]
    sub_off = (jnp.arange(n_defs, dtype=jnp.int32) * (S * S))[None, :, None]
    prev = raw[:, :, :L]
    nxt = raw[:, :, 1:]
    ids_per_def = jnp.take(sub_all, sub_off + prev * S + nxt) * enable[:, None, :]

    # start/end flags (lib.rs:847-888). is_start[i] uses (ids[i], state[i]);
    # is_end is right-shifted: is_end[i] uses (ids[i-1], state[i]). The
    # membership tables are global across defs already.
    st_flat = arrays["is_start_table"].reshape(-1)
    en_flat = arrays["is_end_table"].reshape(-1)
    Ssub = arrays["is_start_table"].shape[-1]
    is_start_body = jnp.take(st_flat, ids_per_def * Ssub + prev).astype(jnp.int32)
    is_start_vals = jnp.concatenate(
        [is_start_body, jnp.zeros((B, n_defs, 1), jnp.int32)], axis=2
    )  # trailing false (lib.rs:869)
    is_end_body = jnp.take(en_flat, ids_per_def * Ssub + nxt).astype(jnp.int32)
    is_end_vals = jnp.concatenate(
        [jnp.zeros((B, n_defs, 1), jnp.int32), is_end_body], axis=2
    )  # leading false (lib.rs:882)

    final_state = jnp.take_along_axis(
        raw, lengths[:, None, None].repeat(n_defs, 1), axis=2
    )[:, :, 0]
    accepted_arr = arrays["accept_mask"][
        jnp.arange(final_state.shape[1])[None, :], final_state
    ]
    # DEAD is absorbing, so deadness at the final state == any dead.
    has_dead_arr = final_state == arrays["dead_states"][None, :]

    substr_id_sum = ids_per_def.sum(axis=1)  # [B, L]
    is_start_sum = is_start_vals.sum(axis=1)  # [B, L+1]
    is_end_sum = is_end_vals.sum(axis=1)

    start_enable = enable[:, None, :] * is_start_vals[:, :, :L]
    end_enable = enable[:, None, :] * is_end_vals[:, :, 1:]

    # Mask FSMs (lib.rs:598-714): set/reset/hold recurrences over positions.
    def mask_fsm(set_f, reset_f, reverse: bool):
        # inputs [B, L]; returns [B, L]
        xs = (set_f.T, reset_f.T)  # [L, B]

        def step(last, x):
            s, r = x
            new = jnp.where(s, 1, jnp.where(r, 0, last))
            return new, new

        init = jnp.zeros((B,), jnp.int32)
        _, out = jax.lax.scan(step, init, xs, reverse=reverse)
        return out.T

    prev_id = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), substr_id_sum[:, :-1]], 1)
    changed_f = (prev_id != substr_id_sum).astype(jnp.int32)
    set_f = is_start_sum[:, :L].astype(bool) & changed_f.astype(bool)
    reset_f = (
        (~is_start_sum[:, :L].astype(bool))
        & is_end_sum[:, :L].astype(bool)
        & changed_f.astype(bool)
    )
    fwd_mask = mask_fsm(set_f.astype(jnp.int32), reset_f.astype(jnp.int32), False)

    next_id = jnp.concatenate([substr_id_sum[:, 1:], jnp.zeros((B, 1), jnp.int32)], 1)
    changed_b = (next_id != substr_id_sum).astype(bool)
    set_b = is_end_sum[:, 1:].astype(bool) & changed_b
    reset_b = (~is_end_sum[:, 1:].astype(bool)) & is_start_sum[:, 1:].astype(bool) & changed_b
    bwd_mask = mask_fsm(set_b.astype(jnp.int32), reset_b.astype(jnp.int32), True)

    mask = fwd_mask * bwd_mask
    masked_characters = mask * chars_i32
    all_substr_ids = mask * substr_id_sum

    accepted = accepted_arr  # [B, n_defs]
    has_dead = has_dead_arr
    match_ok = accepted.all(axis=1) & (~has_dead.any(axis=1))

    return dict(
        all_enable_flags=enable,
        all_characters=chars_i32,
        all_substr_ids=all_substr_ids,
        masked_characters=masked_characters,
        states=states,
        substr_ids_per_def=ids_per_def,
        start_enable=start_enable,
        end_enable=end_enable,
        is_start_sum=is_start_sum,
        is_end_sum=is_end_sum,
        substr_id_sum=substr_id_sum,
        fwd_mask=fwd_mask,
        bwd_mask=bwd_mask,
        mask=mask,
        accepted=accepted,
        has_dead=has_dead,
        match_ok=match_ok,
    )


class BatchMatcher:
    """A jit-compiled batched matcher for one compiled model.

    Usage::

        matcher = BatchMatcher(model)
        result = matcher(chars_u8_BxL, lengths_B)   # RegexResult of jax arrays
    """

    def __init__(self, model: CompiledRegexModel):
        self.model = model
        arrays = _model_arrays(model)
        n_defs = model.n_defs

        @jax.jit
        def run(chars, lengths):
            return _match_core(arrays, n_defs, chars, lengths)

        self._run = run

    def __call__(self, chars, lengths) -> RegexResult:
        chars = jnp.asarray(chars, jnp.uint8)
        lengths = jnp.asarray(lengths, jnp.int32)
        out = self._run(chars, lengths)
        return RegexResult(**out)

    def match_one(self, characters: bytes) -> RegexResult:
        """Single-string convenience matching the oracle's signature."""
        L = self.model.max_chars_size
        buf = np.zeros((1, L), np.uint8)
        buf[0, : len(characters)] = bytearray(characters)
        res = self(buf, np.array([len(characters)], np.int32))
        return res.map(lambda a: np.asarray(a)[0])


def pack_batch(strings, max_chars_size: int):
    """Pad a list of byte strings into (chars [B, L] uint8, lengths [B])."""
    B = len(strings)
    chars = np.zeros((B, max_chars_size), np.uint8)
    lengths = np.zeros((B,), np.int32)
    for i, s in enumerate(strings):
        b = bytes(s)
        if len(b) > max_chars_size:
            raise ValueError(f"string {i} length {len(b)} > {max_chars_size}")
        chars[i, : len(b)] = bytearray(b)
        lengths[i] = len(b)
    return chars, lengths


def expand_rows(flat, starts, lengths, max_len: int):
    """Gather padded [B, max_len] rows from a device-resident flat corpus
    buffer (jit-friendly; the device-expand corpus path).

    ``flat`` uint8 [total]; ``starts`` int [B] byte offsets;
    ``lengths`` int32 [B] row lengths (<= max_len).  Positions past a
    row's length are zero — identical to the host packer's padding, so
    downstream matchers see the same batches while only the raw corpus
    bytes cross the host->device link (avg_len/max_len of the padded
    volume)."""
    # Index math runs in int32 (JAX default without x64): a flat buffer at
    # or beyond 2 GiB would silently wrap and gather garbage rows.
    if flat.shape[0] >= 2**31:
        raise ValueError(
            f"flat corpus buffer of {flat.shape[0]} bytes exceeds int32 "
            "indexing; use chunk_bytes < 2 GiB"
        )
    pos = jnp.arange(max_len, dtype=jnp.int32)
    valid = pos[None, :] < lengths[:, None]
    idx = starts[:, None].astype(jnp.int32) + pos[None, :]
    idx = jnp.where(valid, idx, 0)
    rows = jnp.take(flat, idx, axis=0)
    return jnp.where(valid, rows, jnp.uint8(0))
