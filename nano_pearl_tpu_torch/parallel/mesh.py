"""Device placement of the draft and target model groups (counterpart of
the sequence-parallel part of nano_pearl_tpu/parallel/mesh.py:
``_group_mesh`` and ``build_group_meshes``).

The JAX package runs one controller over a ``("sp", "tp")`` mesh per
group: weights are replicated over ``sp`` and only the KV cache's block
axis is sharded over it, each shard on its own device, with the shards'
partial softmaxes merged across the axis (parallel/sp.py). The port's
counterpart is an in-process sp group: a ``GroupPlacement`` lists one
device per cache shard, the runner keeps one cache shard on each, runs
one kernel launch per shard and merges the partials on the engine's
device. When there are fewer devices than the groups' shards, the
shards share devices round-robin, as ``build_group_meshes`` does (same
numerics, no overlap), with its warning. The port places every group on
one device (the engine's); tensor, pipeline and expert parallel groups
are refused at the engine (engine/engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nano_pearl_tpu_torch.utils.logging import logger


@dataclass(frozen=True)
class GroupPlacement:
    """A model group's devices: one per sp shard of its KV cache."""

    devices: tuple[torch.device, ...]

    @property
    def sp_size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices))


def build_group_placements(
    devices: list[torch.device], draft_sp: int = 1, target_sp: int = 1
) -> tuple[GroupPlacement, GroupPlacement]:
    """The draft's and the target's placements over ``devices``: disjoint
    (the draft on the first ``draft_sp`` devices, the target on the next
    ``target_sp``) when there are enough, else shared round-robin with a
    warning where a group's shards outnumber the devices. A group of one
    shard on a shared device is the port's usual one-device layout and is
    not warned about."""
    if draft_sp < 1 or target_sp < 1:
        raise ValueError(f"sp sizes must be >= 1, got draft {draft_sp}, target {target_sp}")
    devices = list(devices)
    n = len(devices)
    if n >= draft_sp + target_sp:
        draft_devs = devices[:draft_sp]
        target_devs = devices[draft_sp : draft_sp + target_sp]
    else:
        if max(draft_sp, target_sp) > 1:
            logger.warning(
                f"only {n} device(s) for draft {draft_sp} + target {target_sp}; "
                "groups will share devices (no cross-group overlap)."
            )
        draft_devs = [devices[i % n] for i in range(draft_sp)]
        target_devs = [devices[(i + draft_sp) % n] for i in range(target_sp)]
    return GroupPlacement(tuple(draft_devs)), GroupPlacement(tuple(target_devs))
