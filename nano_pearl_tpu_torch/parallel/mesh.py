"""Device placement of the draft and target model groups (counterpart of
nano_pearl_tpu/parallel/mesh.py: ``_group_mesh`` and ``build_group_meshes``).

The JAX package runs one controller over a mesh per group: ``("sp",
"tp")``, weights sharded over ``tp`` (parallel/sharding.py) and the KV
cache's head axis over ``tp`` and its block axis over ``sp``. The port's
counterpart is an in-process group: a ``GroupPlacement`` lists the
group's devices, one per tensor-parallel rank or per sequence-parallel
cache shard, and the runner keeps one weight shard and one cache shard on
each, launches each rank's or shard's kernels in turn, and combines their
results on the host (tensor parallelism: the ranks' partial products
summed in rank order, parallel/sharding.py; sequence parallelism: the
shards' partial softmaxes merged, parallel/sp.py). Every tensor's device
is explicit, so the ranks may sit on one device or on several.

``"disjoint"`` placement gives the draft the first ``draft_tp * draft_sp``
devices and the target the next ``target_tp * target_sp``; when there
are fewer devices, the groups share them round-robin, as
``build_group_meshes`` does (same numerics, no overlap), with its
warning. ``"union"`` places both groups over all the devices and needs
``draft_tp == target_tp`` (and equal sp) to cover them; where the devices
are fewer than a group's ranks (one card), the ranks share them
round-robin, with a warning (the JAX package asserts there). A group of one
rank and one shard on a shared device is the port's usual one-device
layout and is not warned about. Tensor parallelism with sp > 1 is
refused at the engine (engine/engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nano_pearl_tpu_torch.utils.logging import logger


@dataclass(frozen=True)
class GroupPlacement:
    """A model group's devices: ``sp`` rows of ``tp`` devices, row-major as
    the JAX package's ``(sp, tp)`` mesh; one per tensor-parallel rank (sp
    1) or per cache shard (tp 1)."""

    devices: tuple[torch.device, ...]
    tp_size: int = 1

    @property
    def sp_size(self) -> int:
        return len(self.devices) // self.tp_size

    @property
    def distinct_devices(self) -> tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices))


def build_group_placements(
    devices: list,
    draft_tp: int = 1,
    target_tp: int = 1,
    placement: str = "disjoint",
    draft_sp: int = 1,
    target_sp: int = 1,
) -> tuple[GroupPlacement, GroupPlacement]:
    """The draft's and the target's placements over ``devices`` (torch
    devices or strings), by the module doc's rules."""
    if min(draft_tp, target_tp, draft_sp, target_sp) < 1:
        raise ValueError(
            f"tp and sp sizes must be >= 1, got draft tp {draft_tp} sp {draft_sp}, "
            f"target tp {target_tp} sp {target_sp}"
        )
    if placement not in ("disjoint", "union"):
        raise ValueError(f"placement must be 'disjoint' or 'union', got {placement!r}")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    d_n, t_n = draft_tp * draft_sp, target_tp * target_sp
    if placement == "union":
        if draft_sp != target_sp or draft_tp != target_tp or d_n < n:
            raise ValueError(
                f"union placement needs draft_tp == target_tp >= num_devices / sp "
                f"({draft_tp}, {target_tp}, {n} / {draft_sp})"
            )
        if d_n > n:
            logger.warning(
                f"only {n} device(s) for a union group of {d_n}; its ranks will share devices."
            )
        draft_devs = target_devs = [devices[i % n] for i in range(d_n)]
    elif n >= d_n + t_n:
        draft_devs = devices[:d_n]
        target_devs = devices[d_n : d_n + t_n]
    else:
        if max(d_n, t_n) > 1:
            logger.warning(
                f"only {n} device(s) for draft {d_n} + target {t_n}; "
                "groups will share devices (no cross-group overlap)."
            )
        draft_devs = [devices[i % n] for i in range(d_n)]
        target_devs = [devices[(i + d_n) % n] for i in range(t_n)]
    return GroupPlacement(tuple(draft_devs), draft_tp), GroupPlacement(tuple(target_devs), target_tp)
