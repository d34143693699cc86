"""Multi-device execution over torch.distributed process groups (port of
`spgemm_tpu/parallel`): one process per device, the mesh axis the ranks
of a process group, A tile-row slabs per rank and B exchanged by
collectives (dist.py)."""

from spgemm_tpu_torch.parallel.dist import (
    DistPlan, GustavsonDistPlan, Mesh, OzakiDistPlan, StripDistPlan,
    init_multihost, make_mesh, place_strip_partition, plan_gustavson_partition,
    plan_ozaki_partition, plan_row_partition, plan_strip_partition,
    spawn_ranks, spgemm_sharded, spgemm_sharded_esc, spgemm_sharded_ozaki,
    spgemm_sharded_pairs, spgemm_sharded_ring, spgemm_sharded_strip)

__all__ = [
    "Mesh", "make_mesh", "init_multihost", "spawn_ranks",
    "DistPlan", "plan_row_partition", "spgemm_sharded_pairs",
    "GustavsonDistPlan", "plan_gustavson_partition", "spgemm_sharded",
    "spgemm_sharded_ring",
    "StripDistPlan", "plan_strip_partition", "place_strip_partition",
    "spgemm_sharded_strip",
    "spgemm_sharded_esc",
    "OzakiDistPlan", "plan_ozaki_partition", "spgemm_sharded_ozaki",
]
