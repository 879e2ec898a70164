"""Pipeline configuration (port of the depth half of pipeline_config and
of FLUSH_THREAD_PREFIX, paimon_tpu/parallel/pipeline.py).

`scan.prefetch-splits` is how far work may run ahead of its consumer: 0
runs everything in order on the caller's thread. The writer's flush
offload (core/writer.py) is its one consumer in the port; the split
pipeline (SplitPipeline, bounded_map), its read and compaction consumers
and the scan.parallelism option they read are not ported.
"""

from __future__ import annotations

__all__ = ["pipeline_config", "FLUSH_THREAD_PREFIX"]

# the flush worker's thread name; tests/conftest.py fails a test that
# leaves one alive
FLUSH_THREAD_PREFIX = "paimon-flush"


def pipeline_config(options) -> int:
    """The pipeline depth of a CoreOptions: scan.prefetch-splits, 0 or
    more."""
    from ..options import CoreOptions

    return max(int(options.options.get(CoreOptions.SCAN_PREFETCH_SPLITS) or 0), 0)
