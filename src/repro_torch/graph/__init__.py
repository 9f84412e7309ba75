"""Graph substrate: structures, generators, partitioning, and reference problems.

This package provides the host-side (numpy) graph preprocessing pipeline and
the PyTorch reference implementations of the five graph problems
studied in the paper (BFS, PR, WCC, SSSP, SpMV).
"""
from repro_torch.graph.structure import Graph, from_edges
from repro_torch.graph.generators import (
    rmat,
    uniform_random,
    grid_road,
    small_world,
    paper_suite,
    GraphSpec,
    PAPER_GRAPHS,
)
from repro_torch.graph.layout import (
    GraphLayout,
    REORDERS,
    layout_permutation,
    partition_balance,
    relabel_graph,
    reorder_permutation,
    undo_relabel,
)
from repro_torch.graph.partition import (
    horizontal_partition,
    vertical_partition,
    interval_shard_partition,
    HorizontalPartitions,
    VerticalPartitions,
    IntervalShards,
)
from repro_torch.graph import problems

__all__ = [
    "Graph",
    "from_edges",
    "rmat",
    "uniform_random",
    "grid_road",
    "small_world",
    "paper_suite",
    "GraphSpec",
    "PAPER_GRAPHS",
    "GraphLayout",
    "REORDERS",
    "layout_permutation",
    "partition_balance",
    "relabel_graph",
    "reorder_permutation",
    "undo_relabel",
    "horizontal_partition",
    "vertical_partition",
    "interval_shard_partition",
    "HorizontalPartitions",
    "VerticalPartitions",
    "IntervalShards",
    "problems",
]
