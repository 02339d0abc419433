"""The paper's own architecture: partition-centric Euler circuits on a
G50-class Eulerian RMAT graph, 512 partitions = 512 devices (mirrors
``repro/configs/euler_rmat.py``; every cap is the reference's).

Production sizing mirrors the paper's largest graph (G50/P8: 49M vertices,
264M undirected edges) at pod scale: 512 partitions × 256k edges ≈ 134M
local edges + cut edges.  The dry run (``launch/dryrun.py``) runs one
rank's share of the production mesh: one partition a rank.
"""
import dataclasses

from ..core.engine import EngineCaps
from .base import ArchConfig, ShapeCell


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    name: str
    caps: EngineCaps
    n_levels: int
    # edge count modeled by the "fused" whole-run cell (0 → n·edge_cap).
    # The mate/Phase-3 stage is O(E) and partition-independent, so a
    # reduced E keeps the cell tractable while the "superstep" cell
    # models the full per-level load.
    fused_edges: int = 0


def _model(reduced=False):
    if reduced:
        return EulerConfig(
            "euler-smoke",
            EngineCaps(edge_cap=64, park_cap=64, ship_cap=32, new_cap=96,
                       open_cap=48, touch_cap=96),
            n_levels=4,
            fused_edges=4_096,
        )
    return EulerConfig(
        "euler-rmat-512",
        EngineCaps(
            edge_cap=262_144,      # 256k local edges / partition
            park_cap=262_144,      # parked cut edges (§5 dedup+defer)
            ship_cap=4_096,        # per (src,dst) lane per level
            new_cap=524_288,       # level-0 pool = local edges
            open_cap=32_768,
            touch_cap=65_536,
            # live comps per partition are far below the padded capacity,
            # so log2(cap)+2 hook rounds over-provision ~2x; runtime
            # convergence flags guard the cut
            hook_rounds=12,
            splice_rounds=6,
            # ship lanes are per (src,dst) pair; a partition ships its
            # opens/touch to exactly one ancestor per level, so lanes are
            # sized to real transfer volumes; overflow flags guard them
            open_ship_cap=2_048,
            touch_ship_cap=4_096,
            # the fused run's mate writes are keyed by stub id, so they
            # spread ~uniformly over shards; lane = 64k covers 8x
            # hot-spotting at the 2·pair_cap worst case (overflow flags
            # guard it)
            mate_ship_cap=65_536,
        ),
        n_levels=10,               # ceil(log2 512) + 1
        fused_edges=4_194_304,     # Phase-3 analysis scale (O(E), see above)
    )


SHAPES = {
    "superstep": ShapeCell("superstep", "superstep",
                           note="one BSP level: ship + Phase 1"),
    "fused": ShapeCell("fused", "superstep",
                       note="scan-fused whole run: all levels + on-device "
                            "mate accumulation + device Phase 3"),
}


def _reduced():
    return ArchConfig("euler-rmat", "euler", _model(True), SHAPES,
                      source="this paper")


CONFIG = ArchConfig("euler-rmat", "euler", _model(), SHAPES,
                    source="this paper", reduced=_reduced)
