"""Distributed layer: mesh setup, hash-prefix routing, sharded counting.

All new scope vs the reference (SURVEY.md §5.8): shard_map over a
jax.sharding.Mesh, XLA collectives (all_to_all / psum / ppermute) between
devices, fixed-capacity routing with overflow counters.
"""

from . import count, halo, mesh, pipeline, route, stream
from .count import (CountTable, CountTableWide, UnitTable, UnitTableWide,
                    count_words, count_words_wide, count_weighted,
                    merge_tables, merge_many, unit_table, unit_table_wide,
                    lookup, lookup_wide)
from .mesh import (make_mesh, batch_sharding, replicated, init_distributed,
                   local_read_slice, make_global_array)
from .pipeline import (CountResult, count_reads, count_reads_packed,
                       count_reads_wide,
                       make_sharded_counter, make_sharded_counter_wide,
                       make_sequence_parallel_counter,
                       make_sharded_minimizer_counter,
                       make_superkmer_counter, make_sharded_lookup)
from .route import Routed, RoutedWide, owner_of, owner_of_wide
from .stream import (ShardedStreamingCounter, StreamingCounter,
                     count_fastx)

__all__ = [
    "count", "halo", "mesh", "pipeline", "route", "stream",
    "CountTable", "CountTableWide", "UnitTable", "UnitTableWide",
    "count_words", "count_words_wide", "count_weighted", "merge_tables",
    "merge_many", "unit_table", "unit_table_wide", "lookup",
    "lookup_wide",
    "make_mesh", "batch_sharding", "replicated", "init_distributed",
    "local_read_slice", "make_global_array",
    "CountResult", "count_reads", "count_reads_packed", "count_reads_wide",
    "make_sharded_counter", "make_sharded_counter_wide",
    "make_sequence_parallel_counter", "make_sharded_minimizer_counter",
    "make_superkmer_counter", "make_sharded_lookup",
    "Routed", "RoutedWide", "owner_of", "owner_of_wide",
    "ShardedStreamingCounter", "StreamingCounter", "count_fastx",
]
