"""Streaming graph subsystem of the port: out-of-core ingestion,
incremental partition patching, delta batching, membership compaction.

  - edgelog:  chunked on-disk edge log (reader/writer, spill shards), the
              JAX package's format byte for byte
  - ingest:   two-pass streaming pipeline -> PartitionedGraph + StreamContext
  - delta:    edge insert/delete batches patched through the frozen hashes,
              plus membership compaction after delete-heavy traffic
  - buffer:   coalescing DeltaBuffer for continuous producer traffic

Host arrays are numpy and bit-identical to the JAX package's after every
step; ``repro_torch.session.GraphSession`` folds the lifecycle into
``update``/``flush``/``compact`` and keeps the device copies fresh.
"""
from repro_torch.stream.buffer import BufferStats, DeltaBuffer
from repro_torch.stream.delta import (CompactStats, DeltaStats, EdgeDelta,
                                      apply_delta, compact)
from repro_torch.stream.edgelog import (EdgeLogMeta, EdgeLogReader,
                                        EdgeLogWriter, write_edge_log)
from repro_torch.stream.ingest import (ChunkAccountant, IngestStats,
                                       StreamContext, streaming_ingest)

__all__ = [
    "EdgeLogMeta", "EdgeLogReader", "EdgeLogWriter", "write_edge_log",
    "ChunkAccountant", "IngestStats", "StreamContext", "streaming_ingest",
    "EdgeDelta", "DeltaStats", "apply_delta", "CompactStats", "compact",
    "BufferStats", "DeltaBuffer",
]
