"""Data-parallel corpus matching over a device mesh.

Shards the batch dimension across the mesh's data axis with the transition
tables replicated per device; per-shard scans are independent, and only the
summary statistics (match counts, extracted-byte counts, failure flags)
reduce across the mesh — XLA lowers those ``sum``s to all-reduce
collectives (NCCL over NVLink between the cards of a host; the reference
has no distributed path to mirror, SURVEY §5.8).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.compiled import CompiledRegexModel
from ..ops.scan_jax import _match_core, _model_arrays
from ..witness.result import RegexResult
from .mesh import DATA_AXIS, batch_sharding, make_mesh, replicated


class DistributedMatcher:
    """Batched matcher whose inputs/outputs are sharded over the data axis.

    Usage::

        mesh = make_mesh()                     # all devices on the data axis
        dm = DistributedMatcher(model, mesh)
        result, stats = dm(chars, lengths)     # chars [B, L] with B % n_data == 0
    """

    def __init__(
        self,
        model: CompiledRegexModel,
        mesh: Optional[Mesh] = None,
        backend: str = "xla",  # "xla" | "gpu" (fused kernel per shard)
        interpret: bool = False,  # gpu kernel through the interpreter
    ):
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh()
        arrays = {
            k: jax.device_put(v, replicated(self.mesh))
            for k, v in _model_arrays(model).items()
        }
        n_defs = model.n_defs
        in_shard = batch_sharding(self.mesh)
        len_shard = NamedSharding(self.mesh, P(DATA_AXIS))

        if backend == "gpu":
            from ..ops.gpu_scan import GpuScanMatcher
            from jax import shard_map

            gm = GpuScanMatcher(model, interpret=interpret)
            core = shard_map(
                gm.core,
                mesh=self.mesh,
                in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                out_specs=P(DATA_AXIS),
                check_vma=False,
            )
        elif backend == "xla":
            def core(chars, lengths):
                return _match_core(arrays, n_defs, chars, lengths)
        else:
            raise ValueError(f"backend={backend!r}: expected xla/gpu")

        def run(chars, lengths):
            out = core(chars, lengths)
            stats = dict(
                n_matched=out["match_ok"].sum(),
                n_failed=(~out["match_ok"]).sum(),
                n_dead=out["has_dead"].any(axis=1).sum(),
                bytes_scanned=lengths.sum(),
                extracted_bytes=(out["mask"] * out["all_enable_flags"]).sum(),
            )
            return out, stats

        self._run = jax.jit(
            run,
            in_shardings=(in_shard, len_shard),
            out_shardings=(
                None,  # leave outputs sharded as computed (batch-sharded)
                NamedSharding(self.mesh, P()),  # stats fully reduced
            ),
        )

    def __call__(self, chars, lengths):
        chars = jnp.asarray(chars, jnp.uint8)
        lengths = jnp.asarray(lengths, jnp.int32)
        chars = jax.device_put(chars, batch_sharding(self.mesh))
        lengths = jax.device_put(lengths, NamedSharding(self.mesh, P(DATA_AXIS)))
        out, stats = self._run(chars, lengths)
        return RegexResult(**out), {k: np.asarray(v) for k, v in stats.items()}
