"""repro_torch.fabric: the sharded memory plane.

Twin of ``repro/fabric/``.  One page address space consistent-hashed over N member ``MemoryPath``s
with replication factor R — itself a ``MemoryPath``, so ``TieredStore``,
``MemoryEngine``, checkpoints and serve ride it unchanged.  Placement is
pure arithmetic (``HashRing``/``plan_rebalance``), routing and replica
fan-out live in ``ShardedPath``, and failure detection + online
copy-then-flip rebalancing live in ``FabricManager``.

Public API:
    HashRing, PlacementPolicy, PageMove, RebalancePlan, plan_rebalance
    ShardedPath, FabricUnavailable, QuorumError
    FabricManager, FabricDataLoss
    create_fabric                       (registry factory: path "fabric")
"""
from __future__ import annotations

from repro_torch.fabric.manager import FabricDataLoss, FabricManager
from repro_torch.fabric.placement import (HashRing, PageMove,
                                          PlacementPolicy, RebalancePlan,
                                          plan_rebalance)
from repro_torch.fabric.sharded_path import (FabricUnavailable, QuorumError,
                                             ShardedPath)


def create_fabric(n_pages: int = 0, page_bytes: int = 0, shards: int = 2,
                  replicas: int = 1, member: str = "xdma",
                  vnodes: int = 64, policy=None, fabric_reactor=None,
                  retry=None, integrity: bool = False,
                  **member_kw) -> ShardedPath:
    """Build a ``ShardedPath`` of ``shards`` homogeneous members.

    ``member`` names any registered access path (``xdma``/``qdma``/
    ``verbs``/``auto``/...); each member is constructed with the full
    page geometry so any page can live on any shard (replication and
    rebalancing both need that).  Extra kwargs flow to the member
    factory, which signature-filters them.
    """
    from repro_torch.access.registry import create_path
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    members = []
    try:
        for _ in range(shards):
            members.append(create_path(member, n_pages=n_pages,
                                       page_bytes=page_bytes, **member_kw))
        return ShardedPath(members, replicas=replicas, policy=policy,
                           vnodes=vnodes, reactor=fabric_reactor,
                           retry=retry, integrity=integrity)
    except BaseException:
        # a failed ShardedPath constructor (bad replicas, geometry...)
        # must not strand member threads/pools any more than a failed
        # member build would
        for m in members:
            m.close()
        raise


__all__ = [
    "HashRing", "PlacementPolicy", "PageMove", "RebalancePlan",
    "plan_rebalance",
    "ShardedPath", "FabricUnavailable", "QuorumError",
    "FabricManager", "FabricDataLoss",
    "create_fabric",
]
