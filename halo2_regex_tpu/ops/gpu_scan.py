"""Fused witness scan as one GPU kernel (Pallas, Triton route).

The portable path (:mod:`.scan_jax`) runs three serial ``lax.scan`` loops
of L steps each: the DFA states, then the forward and the backward mask
FSMs (reference: src/lib.rs:598-714, 804-888).  On a GPU every step of
those loops is at least one kernel launch inside an XLA while loop.  This
kernel does the same work in one launch:

  * **one string per lane**: a program handles a block of ``BB`` strings
    (a power of two) and loops over the L byte positions itself;
  * **one gather per def per byte**: each def's transitions are packed
    into one int32 word per (byte, state) — next state, substr id, start
    flag, end flag — so a step is a single table load per def.  All four
    are functions of (byte, cur) since next = T[byte, cur].  The tables
    are small (24 KB for the email ``from:`` model, 1 MB for a 1000-state
    table) and stay in L1/L2;
  * **a forward loop** carries the per-def states, sums the ids across
    defs and runs the forward set/reset/hold FSM; it writes the states,
    the id sum and a flags byte per position;
  * **a reverse loop in the same kernel** reads back what the forward
    loop wrote (each lane its own string, so no other thread's writes are
    involved), runs the backward FSM and writes the mask.

Data is time-major inside the kernel ([L, B]), so each step's loads and
stores of BB consecutive strings are coalesced; XLA transposes the byte
input in and the columns out, fused with the light elementwise work of
assembling the result (dummy padding, enable masks, sums across defs).

Every output is an integer and the kernel has no matrix product, so the
results are bit-identical to :mod:`.reference` (tolerance zero).

The kernel is compiled for the GPU only.  ``interpret=True`` runs the same
kernel body through the Pallas interpreter on any platform; the tests use
it on the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models.compiled import CompiledRegexModel
from ..witness.result import RegexResult

# Packed table word: next state | substr id << 16 | start << 30 | end << 31.
_ID_SHIFT = 16
_NEXT_MASK = (1 << _ID_SHIFT) - 1
_ID_MASK = (1 << 14) - 1
_START_BIT = 30
_END_BIT = 31

# Flags byte, one per position (also the compact witness format read by
# witness/expand.py): bit 0 mask, 1 fwd, 2 bwd, 3 enable, 4 any start
# flag at the position, 5 any (unshifted) end flag at the position.
F_MASK, F_FWD, F_BWD, F_EN, F_START, F_END = 0, 1, 2, 3, 4, 5

COLUMNS = ("full", "witness", "match")


def table_fit(model: CompiledRegexModel) -> Optional[str]:
    """Why ``model`` does not fit the packed-word layout, or None if it
    does (states below 2**16, substr ids below 2**14)."""
    if model.s_pad > _NEXT_MASK + 1:
        return f"s_pad {model.s_pad} > {_NEXT_MASK + 1} states"
    if model.total_substrs > _ID_MASK:
        return f"{model.total_substrs} substrs > {_ID_MASK}"
    return None


def build_packed_table(model: CompiledRegexModel) -> np.ndarray:
    """int32 [n_defs, 256, s_pad]: the packed word per (def, byte, state).

    id = substr_id_table[cur, next]; start = cur is a start state of id;
    end = next is an end state of id (the unshifted end flag; the
    reference's is_end column is this shifted right by one)."""
    reason = table_fit(model)
    if reason is not None:
        raise ValueError(f"model does not fit the packed table: {reason}")
    S = model.s_pad
    cur = np.broadcast_to(np.arange(S)[None, :], (256, S))
    out = np.empty((model.n_defs, 256, S), np.uint32)
    for d in range(model.n_defs):
        nxt = model.transition[d].astype(np.int64)
        ids = model.substr_id_table[d][cur, nxt].astype(np.int64)
        start = model.is_start_table[ids, cur].astype(np.int64)
        end = model.is_end_table[ids, nxt].astype(np.int64)
        out[d] = (
            nxt
            | (ids << _ID_SHIFT)
            | (start << _START_BIT)
            | (end << _END_BIT)
        )
    return out.view(np.int32)


def _uint_for(max_value: int):
    for dt in (jnp.uint8, jnp.uint16):
        if max_value <= jnp.iinfo(dt).max:
            return dt
    return jnp.int32


# Strings per program (two warps, one string per thread).  On the H200 the
# time per batch did not depend on it between 32 and 256 (docs/PERF.md).
BLOCK = 64


def _scan_kernel(chars_ref, len_ref, init_ref, table_ref, *out_refs,
                 mode, L, Bp, BB, S, n_defs, dummies, state_dtype, id_dtype):
    """One program: BB strings, all L positions.

    ``mode``: "match" writes the final states; "states" writes the raw
    after-states (the per-shard hook); "full" and "witness" write the
    witness columns (see :class:`GpuScanMatcher`)."""
    rows = pl.program_id(0) * BB + jnp.arange(BB, dtype=jnp.int32)
    lens = len_ref[rows]
    init = [init_ref[d * Bp + rows] for d in range(n_defs)]
    witness = mode in ("full", "witness")
    if mode == "match":
        (final_ref,) = out_refs
    elif mode == "states":
        (states_ref,) = out_refs
    elif mode == "full":
        final_ref, states_ref, tags_ref, ids_ref, flags_ref = out_refs
    else:
        final_ref, states_ref, ids_ref, flags_ref = out_refs

    def fwd_step(t, carry):
        cur, final, prev_id, prev_end, fwd = carry
        c = chars_ref[t * Bp + rows].astype(jnp.int32)
        en = t < lens
        nxt_all, final_all = [], []
        id_sum = jnp.zeros((BB,), jnp.int32)
        any_start = jnp.zeros((BB,), jnp.bool_)
        any_end = jnp.zeros((BB,), jnp.bool_)
        for d in range(n_defs):
            w = table_ref[d * (256 * S) + c * S + cur[d]]
            nxt = w & _NEXT_MASK
            nxt_all.append(nxt)
            final_all.append(jnp.where(t + 1 == lens, nxt, final[d]))
            out_at = (d * L + t) * Bp + rows
            if mode == "states":
                states_ref[out_at] = nxt
                continue
            if not witness:
                continue
            ids = jnp.where(en, (w >> _ID_SHIFT) & _ID_MASK, 0)
            start = en & (((w >> _START_BIT) & 1) != 0)
            end = en & (((w >> _END_BIT) & 1) != 0)
            if mode == "full":
                states_ref[out_at] = nxt
                tags_ref[out_at] = (
                    ids
                    | (start.astype(jnp.int32) << _START_BIT)
                    | (end.astype(jnp.int32) << _END_BIT)
                )
            else:
                states_ref[out_at] = jnp.where(en, nxt, dummies[d]).astype(
                    state_dtype
                )
            id_sum = id_sum + ids
            any_start = any_start | start
            any_end = any_end | end
        if witness:
            # forward set/reset/hold FSM (lib.rs:598-642): is_end_sum at t
            # is the unshifted end flag of t-1, carried as prev_end.
            changed = id_sum != prev_id
            set_f = any_start & changed
            reset_f = (~any_start) & prev_end & changed
            fwd = jnp.where(set_f, 1, jnp.where(reset_f, 0, fwd))
            at = t * Bp + rows
            ids_ref[at] = id_sum.astype(id_dtype)
            flags_ref[at] = (
                (fwd << F_FWD)
                | (en.astype(jnp.int32) << F_EN)
                | (any_start.astype(jnp.int32) << F_START)
                | (any_end.astype(jnp.int32) << F_END)
            ).astype(jnp.uint8)
            prev_id, prev_end = id_sum, any_end
        return tuple(nxt_all), tuple(final_all), prev_id, prev_end, fwd

    zeros = jnp.zeros((BB,), jnp.int32)
    carry = (tuple(init), tuple(init), zeros, zeros != 0, zeros)
    _, final, _, _, _ = jax.lax.fori_loop(0, L, fwd_step, carry)
    if mode != "states":
        for d in range(n_defs):
            final_ref[d * Bp + rows] = final[d]
    if not witness:
        return

    def bwd_step(k, carry):
        # backward FSM (lib.rs:644-714) from position L-1 down to 0
        next_id, next_start, bwd = carry
        at = (L - 1 - k) * Bp + rows
        id_sum = ids_ref[at].astype(jnp.int32)
        flags = flags_ref[at].astype(jnp.int32)
        end = ((flags >> F_END) & 1) != 0
        changed = next_id != id_sum
        set_b = end & changed
        reset_b = (~end) & next_start & changed
        bwd = jnp.where(set_b, 1, jnp.where(reset_b, 0, bwd))
        mask = ((flags >> F_FWD) & 1) & bwd
        ids_ref[at] = (mask * id_sum).astype(id_dtype)
        flags_ref[at] = (flags | (bwd << F_BWD) | (mask << F_MASK)).astype(
            jnp.uint8
        )
        return id_sum, ((flags >> F_START) & 1) != 0, bwd

    jax.lax.fori_loop(0, L, bwd_step, (zeros, zeros != 0, zeros))


class GpuScanMatcher:
    """Fused-kernel matcher; drop-in for :class:`.scan_jax.BatchMatcher`.

    Args:
      model: the compiled model (must pass :func:`table_fit`).
      columns: "full" returns the :class:`RegexResult` set (bit-identical
        to BatchMatcher); "witness" returns the compact dict that
        ``witness/expand.py`` reads (states, masked ids and masked chars
        in the narrowest unsigned type that holds them, the flags byte,
        the mask and the verdicts); "match" returns only the verdicts
        (``final_states``, ``accepted``, ``has_dead``, ``match_ok``).
      interpret: run the kernel through the Pallas interpreter (tests on
        the CPU).  Without it the matcher needs a GPU.
    """

    def __init__(self, model: CompiledRegexModel, columns: str = "full",
                 interpret: bool = False):
        if columns not in COLUMNS:
            raise ValueError(f"columns={columns!r}: expected one of {COLUMNS}")
        if not interpret and jax.devices()[0].platform != "gpu":
            raise ValueError(
                "GpuScanMatcher compiles for a GPU; found "
                f"{jax.devices()[0].platform!r} (interpret=True runs the "
                "kernel through the Pallas interpreter instead)"
            )
        self.model = model
        self.columns = columns
        self.interpret = interpret
        self.n_defs = model.n_defs
        self.S = model.s_pad
        self._table = jnp.asarray(build_packed_table(model).reshape(-1))
        self._first = np.asarray(model.first_states, np.int32)
        self._dummies = tuple(int(x) for x in model.dummy_states)
        self.state_dtype = _uint_for(int(model.s_pad) - 1)
        max_ids = sum(
            int(model.substr_id_table[d].max()) for d in range(model.n_defs)
        )
        self.id_dtype = _uint_for(max_ids)
        self._accept_mask = jnp.asarray(model.accept_mask)
        self._dead = jnp.asarray(model.dead_states)
        self.core = self._core  # unjitted: usable inside shard_map
        self._run = jax.jit(self._core)

    # ------------------------------------------------------------- kernel
    def _kernel_call(self, mode: str, chars_tm, lengths, init):
        """Run the kernel on time-major chars [L, Bp] (Bp a multiple of
        the block), lengths [Bp] and entry states [n_defs, Bp]."""
        L, Bp = chars_tm.shape
        n = self.n_defs
        big = (n * L * Bp,)
        col = (L * Bp,)
        out = {
            "match": [((n * Bp,), jnp.int32)],
            "states": [(big, jnp.int32)],
            "full": [((n * Bp,), jnp.int32), (big, jnp.int32),
                     (big, jnp.int32), (col, self.id_dtype),
                     (col, jnp.uint8)],
            "witness": [((n * Bp,), jnp.int32), (big, self.state_dtype),
                        (col, self.id_dtype), (col, jnp.uint8)],
        }[mode]
        kernel = functools.partial(
            _scan_kernel, mode=mode, L=L, Bp=Bp, BB=BLOCK, S=self.S,
            n_defs=n, dummies=self._dummies, state_dtype=self.state_dtype,
            id_dtype=self.id_dtype,
        )
        outs = pl.pallas_call(
            kernel,
            out_shape=[jax.ShapeDtypeStruct(s, dt) for s, dt in out],
            grid=(Bp // BLOCK,),
            backend="triton",
            compiler_params=plgpu.CompilerParams(
                num_warps=BLOCK // 32, num_stages=1
            ),
            interpret=self.interpret,
            name=f"h2r_gpu_scan_{mode}",
        )(
            chars_tm.reshape(-1),
            lengths,
            init.reshape(-1),
            self._table,
        )
        return outs

    @staticmethod
    def _time_major(chars):
        """Pad the batch to whole blocks and go time-major: [L, Bp]."""
        B = chars.shape[0]
        Bp = -(-B // BLOCK) * BLOCK
        return jnp.pad(chars.astype(jnp.uint8), ((0, Bp - B), (0, 0))).T

    def scan_from(self, chars, entries):
        """Raw after-states [n_defs, B, L] (int32) scanned from per-string
        entry states ``entries`` [n_defs, B] — the per-shard hook of the
        sequence-sharded matchers (parallel/seq_parallel.py).  Every
        position is scanned; the caller masks by length."""
        B, L = chars.shape
        chars_tm = self._time_major(chars)
        Bp = chars_tm.shape[1]
        init = jnp.pad(jnp.asarray(entries, jnp.int32), ((0, 0), (0, Bp - B)))
        lengths = jnp.full((Bp,), L, jnp.int32)
        (states,) = self._kernel_call("states", chars_tm, lengths, init)
        return states.reshape(self.n_defs, L, Bp)[:, :, :B].transpose(0, 2, 1)

    # ----------------------------------------------------------- pipeline
    def _verdicts(self, final):
        """final [n_defs, B] -> accepted, has_dead [B, n_defs], match_ok."""
        final = final.T
        accepted = self._accept_mask[jnp.arange(self.n_defs)[None, :], final]
        has_dead = final == self._dead[None, :]
        return final, accepted, has_dead, accepted.all(1) & ~has_dead.any(1)

    def _core(self, chars, lengths):
        B, L = chars.shape
        n = self.n_defs
        chars_tm = self._time_major(chars)
        Bp = chars_tm.shape[1]
        init = jnp.broadcast_to(jnp.asarray(self._first)[:, None], (n, Bp))
        lengths_p = jnp.pad(lengths.astype(jnp.int32), (0, Bp - B))
        outs = self._kernel_call(self.columns, chars_tm, lengths_p, init)
        final, accepted, has_dead, match_ok = self._verdicts(
            outs[0].reshape(n, Bp)[:, :B]
        )
        if self.columns == "match":
            return dict(final_states=final, accepted=accepted,
                        has_dead=has_dead, match_ok=match_ok)

        def rows_major(x, lead):  # [lead.., L, Bp] flat -> [B, lead.., L]
            x = x.reshape(*lead, L, Bp)[..., :B]
            return jnp.moveaxis(x, -1, 0)

        flags = rows_major(outs[-1], ())
        mask = flags & 1
        ids_masked = rows_major(outs[-2], ())
        chars = chars.astype(jnp.uint8)
        first = jnp.broadcast_to(
            jnp.asarray(self._first)[None, :, None], (B, n, 1)
        )
        after = rows_major(outs[1], (n,))
        if self.columns == "witness":
            states = jnp.concatenate(
                [first.astype(self.state_dtype), after], axis=2
            )
            return dict(
                states=states,
                all_substr_ids=ids_masked,
                masked_characters=mask * chars,
                flags=flags,
                mask=mask,
                accepted=accepted,
                has_dead=has_dead,
                match_ok=match_ok,
            )

        pos = jnp.arange(L + 1, dtype=jnp.int32)
        in_range = pos[None, None, :] <= lengths[:, None, None]
        dummy = jnp.asarray(self._dummies, jnp.int32)[None, :, None]
        states = jnp.where(
            in_range, jnp.concatenate([first, after], axis=2), dummy
        )
        tags = rows_major(outs[2], (n,))
        ids_per_def = tags & ((1 << _START_BIT) - 1)
        start = (tags >> _START_BIT) & 1
        end = (tags >> _END_BIT) & 1
        zero_col = jnp.zeros((B, 1), jnp.int32)
        mask = mask.astype(jnp.int32)
        enable = ((flags >> F_EN) & 1).astype(jnp.int32)
        chars_i32 = chars.astype(jnp.int32) * enable
        return dict(
            all_enable_flags=enable,
            all_characters=chars_i32,
            all_substr_ids=ids_masked.astype(jnp.int32),
            masked_characters=mask * chars_i32,
            states=states,
            substr_ids_per_def=ids_per_def,
            start_enable=start,
            end_enable=end,
            is_start_sum=jnp.concatenate([start.sum(1), zero_col], axis=1),
            is_end_sum=jnp.concatenate([zero_col, end.sum(1)], axis=1),
            substr_id_sum=ids_per_def.sum(1),
            fwd_mask=((flags >> F_FWD) & 1).astype(jnp.int32),
            bwd_mask=((flags >> F_BWD) & 1).astype(jnp.int32),
            mask=mask,
            accepted=accepted,
            has_dead=has_dead,
            match_ok=match_ok,
        )

    def __call__(self, chars, lengths):
        out = self._run(
            jnp.asarray(chars, jnp.uint8), jnp.asarray(lengths, jnp.int32)
        )
        return RegexResult(**out) if self.columns == "full" else out

    def match_one(self, characters: bytes):
        L = self.model.max_chars_size
        buf = np.zeros((1, L), np.uint8)
        buf[0, : len(characters)] = bytearray(characters)
        res = self(buf, np.array([len(characters)], np.int32))
        if self.columns == "full":
            return res.map(lambda a: np.asarray(a)[0])
        return {k: np.asarray(v)[0] for k, v in res.items()}
