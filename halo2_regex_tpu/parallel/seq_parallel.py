"""Sequence-parallel DFA scan: long inputs sharded along the byte axis.

DFA matching is associative — per-byte transition maps compose as
``(g ∘ f)(x) = g[f[x]]`` — so a sequence-sharded scan follows the blockwise
recipe (SURVEY §5.7, the scan analogue of ring attention):

  1. each shard composes its local per-byte maps into one ``[S]`` map;
  2. the per-shard maps are ``all_gather``-ed along the seq axis (one
     ``[B, S]`` vector per shard — tiny vs the byte data);
  3. each shard composes the maps of the shards before it (an exclusive
     prefix) and applies the result to the initial state, giving its entry
     state;
  4. a second local pass rescans the shard's bytes from the entry state,
     emitting per-position states.

The mask set/reset/hold FSMs (reference: src/lib.rs:598-714) are affine
boolean recurrences ``x' = a·x + b`` and shard the same way. Cross-shard
``i-1``/``i+1`` neighbors (shifted end flags, changed-id tests) move by a
one-column ``ppermute`` halo exchange.

Everything here runs under ``shard_map`` on a ``(data, seq)`` mesh; outputs
are bit-identical to the single-device scan (tests/test_distributed.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.compiled import CompiledRegexModel
from ..ops.scan_jax import _model_arrays
from ..witness.result import RegexResult
from .mesh import DATA_AXIS, SEQ_AXIS


def _shift_right(x, axis_name, fill=0):
    """Global right-shift by one along the sequence axis of locally-[B, Ls]
    arrays: out[i] = global x[i-1]; position 0 gets ``fill``."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    last = x[:, -1:]
    prev_last = jax.lax.ppermute(
        last, axis_name, perm=[(i, (i + 1) % n) for i in range(n)]
    )
    prev_last = jnp.where(idx == 0, fill, prev_last)
    return jnp.concatenate([prev_last, x[:, :-1]], axis=1)


def _shift_left(x, axis_name, fill=0):
    """out[i] = global x[i+1]; the last position gets ``fill``."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    first = x[:, :1]
    next_first = jax.lax.ppermute(
        first, axis_name, perm=[(i, (i - 1) % n) for i in range(n)]
    )
    next_first = jnp.where(idx == n - 1, fill, next_first)
    return jnp.concatenate([x[:, 1:], next_first], axis=1)


def _exclusive_prefix_compose(local, axis_name, compose, identity, reverse=False):
    """Exclusive prefix-combine of per-shard monoid elements along
    ``axis_name`` in ⌈log2 n⌉ ``ppermute`` rounds (Hillis-Steele ladder —
    O(n·log n) total work but latency-logarithmic in shard count, vs the
    O(n)-round gather+loop this replaces).

    ``local``: this shard's element. Returns the composition of all
    elements of shards strictly before this one in processing order
    (shard 0 first, or shard n-1 first when ``reverse``).  ``compose(a, b)``
    must apply ``a`` (earlier) then ``b`` (later).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    ridx = (n - 1 - idx) if reverse else idx
    x = local
    shift = 1
    while shift < n:
        # pull the inclusive window ending just before ours
        if reverse:
            perm = [(i, (i - shift) % n) for i in range(n)]
        else:
            perm = [(i, (i + shift) % n) for i in range(n)]
        y = jax.tree.map(
            lambda t: jax.lax.ppermute(t, axis_name, perm=perm), x
        )
        xc = compose(y, x)
        x = jax.tree.map(
            lambda a, b: jnp.where(ridx >= shift, a, b), xc, x
        )
        shift *= 2
    # inclusive -> exclusive: shift by one, identity at the first shard
    if reverse:
        perm1 = [(i, (i - 1) % n) for i in range(n)]
    else:
        perm1 = [(i, (i + 1) % n) for i in range(n)]
    y = jax.tree.map(lambda t: jax.lax.ppermute(t, axis_name, perm=perm1), x)
    return jax.tree.map(
        lambda ident, yy: jnp.where(ridx == 0, ident, yy), identity, y
    )


def _compose_maps(f, g):
    """Apply f then g on state maps [..., S]."""
    return jnp.take_along_axis(g, f, axis=-1)


def _affine_compose(m1, m2):
    """Compose affine boolean maps applied m1-then-m2: (a, b) pairs with
    x' = a·x + b."""
    a1, b1 = m1
    a2, b2 = m2
    return a1 * a2, a2 * b1 + b2


def _local_affine_fsm(set_f, reset_f, reverse: bool):
    """Run the set/reset/hold FSM locally, returning per-position outputs as
    a function of the (unknown) entry value: out[i] = A[i]*entry + B[i],
    plus the block totals. set wins over reset (lib.rs:613-642)."""
    a = (1 - set_f) * (1 - reset_f)  # hold
    b = set_f  # set -> 1, reset -> 0

    xs = (a.T, b.T)

    def step(carry, x):
        ca, cb = carry
        ai, bi = x
        na, nb = ai * ca, ai * cb + bi
        return (na, nb), (na, nb)

    B = set_f.shape[0]
    init = (jnp.ones((B,), jnp.int32), jnp.zeros((B,), jnp.int32))
    (ta, tb), (As, Bs) = jax.lax.scan(step, init, xs, reverse=reverse)
    return (As.T, Bs.T), (ta, tb)


def _witness_from_states(arrays, n_defs, chars, lengths, entries, afters):
    """Shared shard-local witness emission: given each def's entry state
    [B] and per-position after-states [B, Ls], compute ids/flags/masks/
    acceptance with the cross-shard halo exchanges.  Used by both the
    exact (map-composition) and speculative sequence-sharded matchers."""
    B, Ls = chars.shape
    S = arrays["transition"].shape[-1]
    seq_idx = jax.lax.axis_index(SEQ_AXIS)
    start = seq_idx.astype(jnp.int32) * Ls
    pos = start + jnp.arange(Ls, dtype=jnp.int32)
    enable = (pos[None, :] < lengths[:, None]).astype(jnp.int32)
    chars_i32 = chars.astype(jnp.int32) * enable

    ids_sum = jnp.zeros((B, Ls), jnp.int32)
    is_start_sum = jnp.zeros((B, Ls), jnp.int32)
    is_end_sum_sh = jnp.zeros((B, Ls), jnp.int32)  # shifted end flags
    accepted = []
    has_dead = []
    states_all = []
    ids_all = []
    start_all = []
    endf_all = []
    for d in range(n_defs):
        entry_state, after = entries[d], afters[d]
        first = arrays["first_states"][d]
        prev = jnp.concatenate([entry_state[:, None], after[:, :-1]], axis=1)

        sub_flat = arrays["substr_id_table"][d].reshape(-1)
        ids_d = jnp.take(sub_flat, prev * S + after) * enable

        Ssub = arrays["is_start_table"].shape[-1]
        st_flat = arrays["is_start_table"].reshape(-1)
        en_flat = arrays["is_end_table"].reshape(-1)
        is_start_d = jnp.take(st_flat, ids_d * Ssub + prev).astype(jnp.int32)
        # end flag attributed to position i+1 (right-shift across shards).
        is_end_unshifted = jnp.take(en_flat, ids_d * Ssub + after).astype(jnp.int32)
        is_end_d = _shift_right(is_end_unshifted, SEQ_AXIS)

        # final/acceptance: state at global position lengths-1; lengths may
        # be mid-shard, so the owning shard contributes via psum.
        local_final_idx = jnp.clip(lengths - 1 - start, 0, Ls - 1)
        cand = jnp.take_along_axis(after, local_final_idx[:, None], axis=1)[:, 0]
        owns = (lengths - 1 >= start) & (lengths - 1 < start + Ls)
        cand = jnp.where(owns, cand, 0)
        final_state = jax.lax.psum(cand, SEQ_AXIS)
        # empty input: no shard owns byte -1; final = first state
        final_state = jnp.where(lengths == 0, first, final_state)

        accepted.append(arrays["accept_mask"][d, final_state])
        has_dead.append(final_state == arrays["dead_states"][d])
        states_all.append(after)
        ids_all.append(ids_d)
        start_all.append(is_start_d)
        endf_all.append(is_end_unshifted * enable)
        ids_sum = ids_sum + ids_d
        is_start_sum = is_start_sum + is_start_d
        is_end_sum_sh = is_end_sum_sh + is_end_d

    # Mask FSMs with cross-shard entry values.
    prev_ids = _shift_right(ids_sum, SEQ_AXIS)
    changed_f = (prev_ids != ids_sum).astype(jnp.int32)
    set_f = (is_start_sum.astype(bool) & changed_f.astype(bool)).astype(jnp.int32)
    reset_f = (
        (~is_start_sum.astype(bool))
        & is_end_sum_sh.astype(bool)
        & changed_f.astype(bool)
    ).astype(jnp.int32)
    (Af, Bf), (taf, tbf) = _local_affine_fsm(set_f, reset_f, reverse=False)
    entry_f = _exclusive_prefix_compose(
        (taf, tbf),
        SEQ_AXIS,
        _affine_compose,
        (jnp.ones_like(taf), jnp.zeros_like(tbf)),
    )
    fwd_entry_val = entry_f[1]  # applied to initial mask 0: a*0 + b
    fwd_mask = Af * fwd_entry_val[:, None] + Bf

    next_ids = _shift_left(ids_sum, SEQ_AXIS)
    is_start_next = _shift_left(is_start_sum, SEQ_AXIS)
    is_end_next = _shift_left(is_end_sum_sh, SEQ_AXIS)  # is_end_sum[j+1]
    changed_b = (next_ids != ids_sum).astype(bool)
    set_b = (is_end_next.astype(bool) & changed_b).astype(jnp.int32)
    reset_b = (
        (~is_end_next.astype(bool)) & is_start_next.astype(bool) & changed_b
    ).astype(jnp.int32)
    (Ab, Bb), (tab, tbb) = _local_affine_fsm(set_b, reset_b, reverse=True)
    # For the reverse direction, "earlier" shards are those AFTER mine.
    entry_b = _exclusive_prefix_compose(
        (tab, tbb),
        SEQ_AXIS,
        _affine_compose,
        (jnp.ones_like(tab), jnp.zeros_like(tbb)),
        reverse=True,
    )
    bwd_entry_val = entry_b[1]
    bwd_mask = Ab * bwd_entry_val[:, None] + Bb

    mask = fwd_mask * bwd_mask
    masked_chars = mask * chars_i32
    masked_ids = mask * ids_sum

    accepted_arr = jnp.stack(accepted, axis=1)
    has_dead_arr = jnp.stack(has_dead, axis=1)
    match_ok = accepted_arr.all(axis=1) & (~has_dead_arr.any(axis=1))

    return dict(
        enable=enable,
        states_after=jnp.stack(states_all, axis=1),  # [B, n_defs, Ls]
        substr_ids_per_def=jnp.stack(ids_all, axis=1),
        is_start_per_def=jnp.stack(start_all, axis=1),
        endf_per_def=jnp.stack(endf_all, axis=1),  # unshifted end flags
        substr_id_sum=ids_sum,
        is_start_sum=is_start_sum,
        is_end_sum=is_end_sum_sh,
        fwd_mask=fwd_mask,
        bwd_mask=bwd_mask,
        mask=mask,
        masked_characters=masked_chars,
        all_substr_ids=masked_ids,
        accepted=accepted_arr,
        has_dead=has_dead_arr,
        match_ok=match_ok,
    )


def _seq_scan_shard(arrays, n_defs, first_len, chars, lengths, offsets):
    """shard_map body (EXACT scheme): per-shard composed transition MAPS
    (n_live x per-shard work — correct for any DFA, incl. adversarial
    random tables that never resynchronize), exclusive-prefix composed
    across shards, then a rescan from the exact entry state."""
    B, Ls = chars.shape
    S = arrays["transition"].shape[-1]
    entries = []
    afters = []
    c_t = chars.astype(jnp.int32).T
    for d in range(n_defs):
        t_flat = arrays["transition"][d].reshape(-1)

        # Pass 1: local composed map, tracked as the image of every state.
        def map_step(m, c, t_flat=t_flat):
            nm = jnp.take(t_flat, c[:, None] * S + m)
            return nm, None

        iota = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
        local_map, _ = jax.lax.scan(map_step, iota, c_t)

        # Entry map = exclusive prefix of earlier shards' maps.
        entry_map = _exclusive_prefix_compose(
            local_map, SEQ_AXIS, _compose_maps, iota
        )
        entry_state = entry_map[:, arrays["first_states"][d]]

        # Pass 2: rescan from the entry state.
        def state_step(s, c, t_flat=t_flat):
            ns = jnp.take(t_flat, c * S + s)
            return ns, ns

        _, seq_states = jax.lax.scan(state_step, entry_state, c_t)
        entries.append(entry_state)
        afters.append(seq_states.T)
    return _witness_from_states(arrays, n_defs, chars, lengths, entries, afters)


def _xla_shard_scan(arrays, n_defs):
    """Default per-shard scan hook: lax.scan from given entries.
    fn(chars [B, Ls] u8, entries [n_defs, B]) -> after [n_defs, B, Ls]."""
    S = arrays["transition"].shape[-1]

    def fn(chars, entries):
        c_t = chars.astype(jnp.int32).T
        outs = []
        for d in range(n_defs):
            t_flat = arrays["transition"][d].reshape(-1)

            def state_step(s, c, t_flat=t_flat):
                ns = jnp.take(t_flat, c * S + s)
                return ns, ns

            _, seq_states = jax.lax.scan(state_step, entries[d], c_t)
            outs.append(seq_states.T)
        return jnp.stack(outs, axis=0)

    return fn


def _spec_scan_shard(arrays, n_defs, per_shard_scan, chars, lengths):
    """shard_map body (SPECULATIVE scheme, arXiv:1210.5093): every shard
    scans ONCE from a speculated entry state (the DFA's first state —
    exact for shard 0, a resync guess elsewhere),
    the (speculated, actual-exit) boundary states are exchanged, and the
    loop repeats only until entries reach the global fixed point — one
    extra round when the DFA resynchronizes quickly (email-style scanning
    models), at most n_seq rounds for adversarial tables (always exact).
    Per-shard work is 1x (vs the exact scheme's n_live x map composition),
    and the scan hook is pluggable (XLA scan / fused GPU kernel)."""
    B, Ls = chars.shape
    n = jax.lax.axis_size(SEQ_AXIS)
    idx = jax.lax.axis_index(SEQ_AXIS)
    firsts = jnp.broadcast_to(
        jnp.asarray(arrays["first_states"], jnp.int32)[:, None], (n_defs, B)
    )
    perm_fwd = [(i, (i + 1) % n) for i in range(n)]

    def body(carry):
        entries, _after, _changed, rounds = carry
        after = per_shard_scan(chars, entries)  # [n_defs, B, Ls]
        exits = after[:, :, -1]
        prev_exit = jax.lax.ppermute(exits, SEQ_AXIS, perm=perm_fwd)
        new_entries = jnp.where(idx == 0, firsts, prev_exit)
        changed = jax.lax.psum(
            (new_entries != entries).any().astype(jnp.int32), SEQ_AXIS
        )
        return new_entries, after, changed, rounds + 1

    def cond(carry):
        return carry[2] > 0

    init_after = jnp.zeros((n_defs, B, Ls), jnp.int32)
    entries, after, _, rounds = jax.lax.while_loop(
        cond, body, (firsts, init_after, jnp.int32(1), jnp.int32(0))
    )
    # At exit changed == 0: `after` was scanned from entries equal to the
    # final fixed point, so it is the exact per-position state set.
    out = _witness_from_states(
        arrays,
        n_defs,
        chars,
        lengths,
        [entries[d] for d in range(n_defs)],
        [after[d] for d in range(n_defs)],
    )
    out["spec_rounds"] = jnp.broadcast_to(rounds, (1,))
    return out


_SEQ_OUT_SPECS = dict(
    enable=P(DATA_AXIS, SEQ_AXIS),
    states_after=P(DATA_AXIS, None, SEQ_AXIS),
    substr_ids_per_def=P(DATA_AXIS, None, SEQ_AXIS),
    is_start_per_def=P(DATA_AXIS, None, SEQ_AXIS),
    endf_per_def=P(DATA_AXIS, None, SEQ_AXIS),
    substr_id_sum=P(DATA_AXIS, SEQ_AXIS),
    is_start_sum=P(DATA_AXIS, SEQ_AXIS),
    is_end_sum=P(DATA_AXIS, SEQ_AXIS),
    fwd_mask=P(DATA_AXIS, SEQ_AXIS),
    bwd_mask=P(DATA_AXIS, SEQ_AXIS),
    mask=P(DATA_AXIS, SEQ_AXIS),
    masked_characters=P(DATA_AXIS, SEQ_AXIS),
    all_substr_ids=P(DATA_AXIS, SEQ_AXIS),
    accepted=P(DATA_AXIS, None),
    has_dead=P(DATA_AXIS, None),
    match_ok=P(DATA_AXIS),
)


class SpeculativeSeqMatcher:
    """Sequence-sharded matcher using SPECULATIVE boundary resolution
    (arXiv:1210.5093): each shard scans once from a speculated entry,
    boundary states are exchanged, and only on mismatch does another round
    run — 1x per-shard work for resyncing DFAs vs the exact scheme's
    n_live x map composition.  Always exact (fixed-point iteration, at
    most n_seq rounds).  ``per_shard`` picks the shard-local scan kernel:

      "xla" — lax.scan (any platform; the virtual-mesh path)
      "gpu" — the fused kernel's entry-state scan
              (GpuScanMatcher.scan_from; ``interpret=True`` runs it
              through the Pallas interpreter on virtual meshes).

    Outputs carry ``spec_rounds``: how many scan rounds the fixed point
    took (1 = speculation was immediately right everywhere).
    """

    def __init__(
        self,
        model: CompiledRegexModel,
        mesh: Mesh,
        per_shard: str = "xla",
        interpret: bool = False,
    ):
        self.model = model
        self.mesh = mesh
        arrays = _model_arrays(model)
        n_defs = model.n_defs
        seq = mesh.shape[SEQ_AXIS]
        Ls = model.max_chars_size // seq

        if per_shard == "gpu":
            from ..ops.gpu_scan import GpuScanMatcher
            import dataclasses

            shard_model = dataclasses.replace(model, max_chars_size=Ls)
            scan_hook = GpuScanMatcher(shard_model, interpret=interpret).scan_from

        elif per_shard == "xla":
            scan_hook = _xla_shard_scan(arrays, n_defs)
        else:
            raise ValueError(f"per_shard={per_shard!r}: expected xla/gpu")
        self.per_shard = per_shard

        fn = partial(_spec_scan_shard, arrays, n_defs, scan_hook)
        out_specs = dict(_SEQ_OUT_SPECS, spec_rounds=P(None))
        sharded = shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS)),
            out_specs=out_specs,
            check_vma=False,
        )
        self._run = jax.jit(sharded)

    def __call__(self, chars, lengths):
        chars = jnp.asarray(chars, jnp.uint8)
        lengths = jnp.asarray(lengths, jnp.int32)
        return self._run(chars, lengths)

    def match(self, chars, lengths) -> RegexResult:
        """Full RegexResult view (API parity with SeqShardedMatcher)."""
        chars = jnp.asarray(chars, jnp.uint8)
        lengths = jnp.asarray(lengths, jnp.int32)
        out = dict(self._run(chars, lengths))
        out.pop("spec_rounds", None)
        return _assemble_result(self.model, out, chars, lengths)


class SeqShardedMatcher:
    """Matcher whose byte axis is sharded over the mesh's seq axis (and the
    batch over the data axis). Input L must divide by the seq axis size."""

    def __init__(self, model: CompiledRegexModel, mesh: Mesh):
        self.model = model
        self.mesh = mesh
        arrays = _model_arrays(model)
        n_defs = model.n_defs
        first_len = model.max_chars_size

        fn = partial(_seq_scan_shard, arrays, n_defs, first_len)

        sharded = shard_map(
            lambda chars, lengths: fn(chars, lengths, None),
            mesh=mesh,
            in_specs=(P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS)),
            out_specs=dict(_SEQ_OUT_SPECS),
            check_vma=False,
        )
        self._run = jax.jit(sharded)

    def __call__(self, chars, lengths):
        chars = jnp.asarray(chars, jnp.uint8)
        lengths = jnp.asarray(lengths, jnp.int32)
        return self._run(chars, lengths)

    def match(self, chars, lengths) -> RegexResult:
        """Full RegexResult view (API parity with BatchMatcher). The
        sequence-sharded kernel emits states-after and flag columns; this
        assembles the padded state rows, summed flag columns and enables —
        light elementwise work, left to XLA."""
        chars = jnp.asarray(chars, jnp.uint8)
        lengths = jnp.asarray(lengths, jnp.int32)
        return _assemble_result(self.model, self._run(chars, lengths), chars, lengths)


def _assemble_result(model, out, chars, lengths) -> RegexResult:
        B, L = chars.shape
        n_defs = model.n_defs
        enable = out["enable"]
        chars_i32 = chars.astype(jnp.int32) * enable
        after = out["states_after"]  # [B, n_defs, L] (raw beyond len)
        first = jnp.asarray(model.first_states)[None, :, None]
        raw = jnp.concatenate(
            [jnp.broadcast_to(first, (B, n_defs, 1)), after], axis=2
        )
        posL1 = jnp.arange(L + 1, dtype=jnp.int32)
        in_range = posL1[None, None, :] <= lengths[:, None, None]
        dummy = jnp.asarray(model.dummy_states)[None, :, None]
        states = jnp.where(in_range, raw, dummy)
        # flags: kernel's is_start_sum covers positions [0..L-1]; index L is
        # structurally false (lib.rs:869). is_end_sum is the shifted column;
        # its honest index L equals the summed UNSHIFTED flag at L-1.
        is_start_sum = jnp.concatenate(
            [out["is_start_sum"], jnp.zeros((B, 1), jnp.int32)], axis=1
        )
        is_end_sum = jnp.concatenate(
            [out["is_end_sum"], out["endf_per_def"].sum(axis=1)[:, -1:]], axis=1
        )
        return RegexResult(
            all_enable_flags=enable,
            all_characters=chars_i32,
            all_substr_ids=out["all_substr_ids"],
            masked_characters=out["masked_characters"],
            states=states,
            substr_ids_per_def=out["substr_ids_per_def"],
            start_enable=enable[:, None, :] * out["is_start_per_def"],
            end_enable=enable[:, None, :] * out["endf_per_def"],
            is_start_sum=is_start_sum,
            is_end_sum=is_end_sum,
            substr_id_sum=out["substr_id_sum"],
            fwd_mask=out["fwd_mask"],
            bwd_mask=out["bwd_mask"],
            mask=out["mask"],
            accepted=out["accepted"],
            has_dead=out["has_dead"],
            match_ok=out["match_ok"],
        )
