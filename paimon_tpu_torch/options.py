"""Typed table options (port of paimon_tpu/options.py, this slice's keys).

Options persist as a plain string map inside the table schema, so the keys
and defaults here are the JAX package's, byte for byte. Keys this module
does not know are kept verbatim in the map and written back unchanged.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Generic, Mapping, TypeVar

T = TypeVar("T")

__all__ = [
    "ConfigOption",
    "Options",
    "MemorySize",
    "CoreOptions",
    "MergeEngine",
    "SortEngine",
    "ChangelogProducer",
    "StartupMode",
    "parse_duration_millis",
]

_DURATION_UNITS = {"ms": 1, "s": 1000, "sec": 1000, "min": 60_000, "m": 60_000, "h": 3_600_000, "d": 86_400_000}


def parse_duration_millis(v: "str | int | float") -> int:
    """'1 h' / '30s' / '100 ms' / a bare number of millis -> millis."""
    if isinstance(v, (int, float)):
        return int(v)
    t = str(v).strip().lower().replace(" ", "")
    for u in ("ms", "sec", "min", "s", "m", "h", "d"):
        if t.endswith(u) and t[: -len(u)].replace(".", "", 1).isdigit():
            return int(float(t[: -len(u)]) * _DURATION_UNITS[u])
    return int(float(t))


class MemorySize(int):
    """Bytes, parseable from '128 mb' style strings."""

    _UNITS = {"b": 1, "kb": 1 << 10, "mb": 1 << 20, "gb": 1 << 30, "tb": 1 << 40}

    @staticmethod
    def parse(s: "str | int") -> "MemorySize":
        if isinstance(s, int):
            return MemorySize(s)
        t = s.strip().lower().replace(" ", "")
        for u in ("tb", "gb", "mb", "kb", "b"):
            if t.endswith(u):
                return MemorySize(int(float(t[: -len(u)]) * MemorySize._UNITS[u]))
        return MemorySize(int(t))


@dataclass(frozen=True)
class ConfigOption(Generic[T]):
    key: str
    default: T
    parser: Callable[[Any], T]
    description: str = ""
    fallback_keys: tuple[str, ...] = ()

    @staticmethod
    def string(key: str, default: str | None = None, description: str = "", fallback: tuple[str, ...] = ()):
        return ConfigOption(key, default, lambda v: None if v is None else str(v), description, fallback)

    @staticmethod
    def int_(key: str, default: int | None = None, description: str = "", fallback: tuple[str, ...] = ()):
        return ConfigOption(key, default, lambda v: None if v is None else int(v), description, fallback)

    @staticmethod
    def bool_(key: str, default: bool = False, description: str = "", fallback: tuple[str, ...] = ()):
        return ConfigOption(
            key, default, lambda v: v if isinstance(v, bool) else str(v).lower() == "true", description, fallback
        )

    @staticmethod
    def duration(key: str, default: "str | None", description: str = "", fallback: tuple[str, ...] = ()):
        """Millis (int | None), parsed by parse_duration_millis."""
        d = None if default is None else parse_duration_millis(default)
        return ConfigOption(key, d, lambda v: None if v is None else parse_duration_millis(v), description, fallback)

    @staticmethod
    def float_(key: str, default: float | None = None, description: str = ""):
        return ConfigOption(key, default, lambda v: None if v is None else float(v), description)

    @staticmethod
    def memory(key: str, default: str, description: str = ""):
        return ConfigOption(key, MemorySize.parse(default), MemorySize.parse, description)

    @staticmethod
    def enum(key: str, enum_cls, default, description: str = "", fallback: tuple[str, ...] = ()):
        def parse(v):
            return v if isinstance(v, enum_cls) else enum_cls(str(v).lower().replace("_", "-"))

        return ConfigOption(key, default, parse, description, fallback)


def _per_level(spec: str | None, key: str) -> dict[int, str]:
    out: dict[int, str] = {}
    for part in (spec or "").split(","):
        if not part.strip():
            continue
        level, _, value = part.strip().partition(":")
        if not value:
            raise ValueError(f"{key} needs 'level:value' pairs, got {part!r}")
        out[int(level)] = value.strip()
    return out


class Options:
    """A string->value map with typed access via ConfigOption."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        self._data: dict[str, Any] = dict(data or {})

    def get(self, option: ConfigOption[T]) -> T:
        for key in (option.key, *option.fallback_keys):
            if key in self._data:
                return option.parser(self._data[key])
        return option.default

    def contains(self, option: "ConfigOption | str") -> bool:
        return (option if isinstance(option, str) else option.key) in self._data

    def to_map(self) -> dict[str, str]:
        return {k: str(v) for k, v in self._data.items()}

    def set_key(self, option: ConfigOption) -> str | None:
        """The key under which option is set (its own or a fallback), or
        None when it is left at its default."""
        return next((k for k in (option.key, *option.fallback_keys) if k in self._data), None)


class MergeEngine(str, enum.Enum):
    DEDUPLICATE = "deduplicate"
    PARTIAL_UPDATE = "partial-update"
    AGGREGATE = "aggregation"
    FIRST_ROW = "first-row"


class StartupMode(str, enum.Enum):
    DEFAULT = "default"
    LATEST_FULL = "latest-full"
    LATEST = "latest"
    FROM_TIMESTAMP = "from-timestamp"
    FROM_SNAPSHOT = "from-snapshot"
    FROM_SNAPSHOT_FULL = "from-snapshot-full"
    COMPACTED_FULL = "compacted-full"

    @classmethod
    def _missing_(cls, value):
        # the deprecated "full" is "latest-full"
        return cls.LATEST_FULL if value == "full" else None


class ChangelogProducer(str, enum.Enum):
    NONE = "none"
    INPUT = "input"
    FULL_COMPACTION = "full-compaction"
    LOOKUP = "lookup"


class SortEngine(str, enum.Enum):
    XLA_SEGMENTED = "xla-segmented"  # plain torch ops
    PALLAS = "pallas"  # the hand-written Hopper kernels
    NUMPY = "numpy"  # host oracle


class CoreOptions:
    """The options the port reads, with the JAX package's keys, defaults and
    descriptions (docs_gen prints them). A description names no
    PAIMON_TPU_* override, since the port reads none, and file.format's
    lists the port's formats."""

    BUCKET = ConfigOption.int_("bucket", -1, description='Number of buckets (-1 = dynamic/unaware).')
    DYNAMIC_BUCKET_TARGET_ROW_NUM = ConfigOption.int_(
        "dynamic-bucket.target-row-num",
        2_000_000,
        description=(
            'Rows per dynamic bucket.'
        ),
    )
    DYNAMIC_BUCKET_INITIAL_BUCKETS = ConfigOption.int_(
        "dynamic-bucket.initial-buckets",
        None,
        description=(
            'Dynamic bucket mode: buckets pre-created per assigner.'
        ),
    )
    DYNAMIC_BUCKET_ASSIGNER_PARALLELISM = ConfigOption.int_(
        "dynamic-bucket.assigner-parallelism",
        None,
        description=(
            'Dynamic bucket mode: assigner operators; new buckets are striped bucket %% parallelism == '
            'assigner_id (default: writer parallelism).'
        ),
    )
    PARTITION_DEFAULT_NAME = ConfigOption.string(
        "partition.default-name",
        "__DEFAULT_PARTITION__",
        description=(
            'Path name used for null/empty partition values.'
        ),
    )
    SCAN_PLAN_SORT_PARTITION = ConfigOption.bool_(
        "scan.plan-sort-partition",
        False,
        description=(
            'true: splits strictly partition-major (sorted sequential consumption); false: round-robin across '
            'partitions (spreads parallel readers).'
        ),
    )
    FILE_FORMAT = ConfigOption.string("file.format", "parquet", description='Data file format: parquet|orc|avro.')
    FILE_COMPRESSION = ConfigOption.string("file.compression", "zstd", description='Data file compression codec.')
    # the port's zstd encoder has one strength and reads this key nowhere:
    # a level changes the size of the files the JAX package writes, never
    # the rows, and nothing the port writes
    FILE_COMPRESSION_ZSTD_LEVEL = ConfigOption.int_(
        "file.compression.zstd-level",
        1,
        description=(
            'zstd level for data files (higher = smaller + slower).'
        ),
    )
    FILE_COMPRESSION_PER_LEVEL = ConfigOption.string(
        "file.compression.per.level",
        None,
        description=(
            "Per-LSM-level compression override, e.g. '0:lz4,5:zstd' (level-0 files are short-lived: cheap "
            'codec; bottom level: dense codec).'
        ),
    )
    # '0:avro,5:parquet': the data file format of the levels it names
    FILE_FORMAT_PER_LEVEL = ConfigOption.string(
        "file.format.per.level",
        None,
        description=(
            "Per-LSM-level format override, e.g. '0:avro,5:parquet' (row format for hot small runs, columnar "
            'for the settled bottom level).'
        ),
    )
    # the reference's key-value layout: the trimmed primary key again in
    # front of each data file, as _KEY_<name> columns
    DATA_FILE_INCLUDE_KEY_COLUMNS = ConfigOption.bool_(
        "data-file.include-key-columns",
        False,
        description=(
            'Duplicate the trimmed primary key as _KEY_<name> columns at the front of every data file (the '
            'reference KeyValue.schema layout) — with manifest.format=avro this makes the whole table '
            'reference-layout on disk.'
        ),
    )
    MANIFEST_FORMAT = ConfigOption.string("manifest.format", "jsonl", description='Manifest file format.')
    MANIFEST_COMPRESSION = ConfigOption.string(
        "manifest.compression",
        "default",
        description=(
            'Manifest codec: default (zstd for jsonl / deflate for avro) or none.'
        ),
    )
    TARGET_FILE_SIZE = ConfigOption.memory(
        "target-file-size",
        "128 mb",
        description=(
            'Rolling target size for data files.'
        ),
    )
    WRITE_BUFFER_SIZE = ConfigOption.memory("write-buffer-size", "256 mb", description='Memtable size before flush.')
    WRITE_BUFFER_ROWS = ConfigOption.int_("write-buffer-rows", 1_000_000, description='Memtable row cap before flush.')
    LOCAL_MERGE_BUFFER_SIZE = ConfigOption.memory(
        "local-merge-buffer-size",
        "0 b",
        description=(
            'When >0, pre-merge high-churn keys in a local buffer BEFORE bucket routing (reference '
            'LocalMergeOperator; deduplicate engine only).'
        ),
    )
    # admission control (core/admission.py): a byte budget over every
    # buffered memtable and offloaded flush of a write (0 = off); past
    # stop-trigger x max-memory a write blocks up to block-timeout, then is
    # rejected; at most max-pending-flushes memtables wait for the flush
    # worker (0 = no cap)
    WRITE_BUFFER_MAX_MEMORY = ConfigOption.memory(
        "write.buffer.max-memory",
        "0 b",
        description=(
            'Admission-control byte budget over ALL buffered memtables and in-flight offloaded flushes of a '
            'write job (0 = off). Above write.buffer.stop-trigger of this budget new writes first throttle '
            '(bounded block while flushes drain, deadline write.buffer.block-timeout) and then reject with '
            'WriterBackpressureError.'
        ),
    )
    WRITE_BUFFER_STOP_TRIGGER = ConfigOption.float_(
        "write.buffer.stop-trigger",
        0.9,
        description=(
            'Fraction of write.buffer.max-memory at which incoming writes stop being admitted immediately and '
            'start throttling.'
        ),
    )
    WRITE_BUFFER_BLOCK_TIMEOUT = ConfigOption.duration(
        "write.buffer.block-timeout",
        "10 s",
        description=(
            'How long a throttled write blocks waiting for flushes to release buffer budget before it is '
            'rejected with WriterBackpressureError.'
        ),
    )
    WRITE_BUFFER_MAX_PENDING_FLUSHES = ConfigOption.int_(
        "write.buffer.max-pending-flushes",
        4,
        description=(
            'Cap on memtables queued behind the offloaded flush workers across a write job (0 = unlimited). At '
            'the cap the writer encodes inline — the caller pays — so a slow encoder can never queue unbounded '
            'memtables.'
        ),
    )
    # the spilling write buffer of append tables (core/disk.py): segments
    # of write-buffer-spill.rows rows or .size bytes go to local disk, up
    # to .max-disk-size on disk, past which the buffer flushes
    WRITE_BUFFER_SPILLABLE = ConfigOption.bool_(
        "write-buffer-spillable",
        False,
        description=(
            'Spill the write buffer to local disk under memory pressure.'
        ),
    )
    WRITE_BUFFER_FOR_APPEND = ConfigOption.bool_(
        "write-buffer-for-append",
        False,
        description=(
            'Append tables: buffer rows (with spill) instead of flushing a file per write call.'
        ),
    )
    WRITE_BUFFER_SPILL_ROWS = ConfigOption.int_(
        "write-buffer-spill.rows",
        256 * 1024,
        description=(
            'In-memory rows before a spill segment is written.'
        ),
    )
    WRITE_BUFFER_SPILL_SIZE = ConfigOption.memory(
        "write-buffer-spill.size",
        "64 mb",
        description=(
            'In-memory bytes before a spill segment is written.'
        ),
    )
    WRITE_BUFFER_SPILL_MAX_DISK_SIZE = ConfigOption.memory(
        "write-buffer-spill.max-disk-size",
        f"{1 << 50} b",
        description=(
            'Cap on bytes of spill segments on local disk; past it the buffer flushes instead of spilling.'
        ),
    )
    # the writer's flush offload (core/writer.py): 0 flushes inline, more
    # hands auto-flushes to one paimon-flush worker (parallel/pipeline.py)
    SCAN_PREFETCH_SPLITS = ConfigOption.int_(
        "scan.prefetch-splits",
        2,
        description=(
            'Readahead depth of the pipelined split scheduler: how many splits/compaction sections/flush '
            'encodes may run ahead of the consumer. 0 disables pipelining everywhere (strictly sequential '
            'execution; output is bit-identical either way).'
        ),
    )
    WRITE_ONLY = ConfigOption.bool_(
        "write-only",
        False,
        fallback=("write.compaction-skip",),
        description=(
            'Skip compaction (dedicated compact job mode).'
        ),
    )
    MERGE_ENGINE = ConfigOption.enum(
        "merge-engine",
        MergeEngine,
        MergeEngine.DEDUPLICATE,
        description=(
            'How same-key records merge.'
        ),
    )
    IGNORE_DELETE = ConfigOption.bool_(
        "ignore-delete",
        False,
        fallback=(
            "first-row.ignore-delete",
            "deduplicate.ignore-delete",
            "partial-update.ignore-delete",
        ), description='Ignore -D records on write/merge.',
    )
    SORT_ENGINE = ConfigOption.enum(
        "sort-engine",
        SortEngine,
        SortEngine.XLA_SEGMENTED,
        description=(
            'Merge kernel backend.'
        ),
    )
    MERGE_LANE_COMPRESSION = ConfigOption.bool_(
        "merge.lane-compression",
        True,
        description=(
            'Compress uint32 key lanes before every merge, compaction rewrite, and sort-compact sort: drop '
            'batch-constant lanes, bit-pack adjacent narrowed lanes into fused uint32 operands, and lead wide '
            'keys with a device-computed offset-value code lane (OVC). Output is bit-identical to the '
            'uncompressed path; off restores it.'
        ),
    )
    MERGE_READ_BATCH_ROWS = ConfigOption.int_(
        "merge.read-batch-rows",
        8 << 20,
        description=(
            'Row tile per device merge step (key-range tiling).'
        ),
    )
    # the code domain: readers hand dictionary-encoded chunks over as
    # (sorted pool, uint32 codes) columns; a dictionary or unified merge pool
    # past the limit expands instead
    MERGE_DICT_DOMAIN = ConfigOption.bool_(
        "merge.dict-domain",
        False,
        description=(
            'Carry dictionary codes as the merge currency end-to-end: readers return (pool, codes) columns for '
            'dictionary-encoded string/bytes chunks instead of expanding them, per-file pools unify into one '
            'sorted merge domain (ops.dicts — the LSM-OPD/LUDA move), re-mapped codes become key lanes with '
            'zero searchsorted, dedup/partial-update/aggregation and sort-compact run on codes, and '
            'flush/compaction encode emits dictionary pages straight from the unified pool. Falls back to the '
            'expanded path per file/merge when a column is not dictionary-encoded or the domain exceeds '
            'merge.dict-domain.pool-limit. Output rows are bit-identical to the expanded path.'
        ),
    )
    MERGE_DICT_DOMAIN_POOL_LIMIT = ConfigOption.int_(
        "merge.dict-domain.pool-limit",
        1 << 20,
        description=(
            'Largest dictionary domain (distinct values per column) the code-domain merge path will carry — a '
            'single file dictionary or a unified merge pool above this expands to strings instead '
            '(dict{fallback_expanded}).'
        ),
    )
    SEQUENCE_FIELD = ConfigOption.string("sequence.field", None, description='User-defined sequence column(s).')
    PARTIAL_UPDATE_REMOVE_RECORD_ON_DELETE = ConfigOption.bool_(
        "partial-update.remove-record-on-delete",
        False,
        description=(
            '-D removes whole row under partial-update.'
        ),
    )
    AGGREGATE_DEFAULT_FUNC = ConfigOption.string(
        "fields.default-aggregate-function",
        None,
        description=(
            'Default aggregate for unconfigured fields.'
        ),
    )
    ROWKIND_FIELD = ConfigOption.string(
        "rowkind.field",
        None,
        description=(
            "Column holding the row kind ('+I'/'-U'/'+U'/'-D') extracted on write."
        ),
    )
    # INSERT OVERWRITE without a partition filter replaces only the
    # partitions the new rows touch (false: the whole table)
    DYNAMIC_PARTITION_OVERWRITE = ConfigOption.bool_(
        "dynamic-partition-overwrite",
        True,
        description=(
            'INSERT OVERWRITE without a partition filter clears only the partitions present in the new data '
            '(false: whole table).'
        ),
    )
    # cross-partition upsert (table/crosspartition.py): threads reading the
    # key columns at bootstrap, and the index entries' lifetime (None: no
    # expiry)
    CROSS_PARTITION_UPSERT_BOOTSTRAP_PARALLELISM = ConfigOption.int_(
        "cross-partition-upsert.bootstrap-parallelism",
        10,
        description=(
            'Threads reading existing keys when bootstrapping the cross-partition index.'
        ),
    )
    CROSS_PARTITION_UPSERT_INDEX_TTL = ConfigOption.duration(
        "cross-partition-upsert.index-ttl",
        None,
        description=(
            'TTL for rows in the cross-partition key->(partition,bucket) index (0/None = keep forever; shorter '
            '= less memory, risk of stale rows).'
        ),
    )
    # "Deletion-vector mode." (table/delete.py)
    DELETION_VECTORS_ENABLED = ConfigOption.bool_(
        "deletion-vectors.enabled",
        False,
        description=(
            'Deletion-vector mode.'
        ),
    )
    BRANCH = ConfigOption.string("branch", "main", description='Branch this table view reads and writes.')
    # time travel and incremental reads (table/read.py TableScan)
    SCAN_MODE = ConfigOption.enum(
        "scan.mode",
        StartupMode,
        StartupMode.DEFAULT,
        'Startup mode for scans.',
        ("log.scan",),
    )
    SCAN_SNAPSHOT_ID = ConfigOption.int_("scan.snapshot-id", None, description='Snapshot id for time travel.')
    SCAN_TIMESTAMP_MILLIS = ConfigOption.int_(
        "scan.timestamp-millis",
        None,
        'Timestamp for time travel.',
        ("log.scan.timestamp-millis",),
    )
    # "YYYY-MM-DD[ HH:MM:SS[.ffffff]]" in the local zone
    SCAN_TIMESTAMP = ConfigOption.string(
        "scan.timestamp",
        None,
        description=(
            "Timestamp for time travel as 'YYYY-MM-DD[ HH:MM:SS[.ffffff]]' (local time)."
        ),
    )
    SCAN_TAG_NAME = ConfigOption.string("scan.tag-name", None, description='Tag name for time travel.')
    # a tag name, else a snapshot id
    SCAN_VERSION = ConfigOption.string(
        "scan.version",
        None,
        description=(
            'Unified time travel: a tag name, or a snapshot id (tag wins on ambiguity).'
        ),
    )
    # the earliest snapshot whose watermark is at least this
    SCAN_WATERMARK = ConfigOption.int_(
        "scan.watermark",
        None,
        description=(
            'Travel to the earliest snapshot whose watermark is >= this value.'
        ),
    )
    # only the data files created after this epoch-millis
    SCAN_FILE_CREATION_TIME_MILLIS = ConfigOption.int_(
        "scan.file-creation-time-millis",
        None,
        description=(
            'Only read data files created after this epoch-millis.'
        ),
    )
    SCAN_MAX_SPLITS_PER_TASK = ConfigOption.int_(
        "scan.max-splits-per-task",
        10,
        description=(
            'Split-assignment batch cap per reader task in the enumerator.'
        ),
    )
    # "t1,t2" epoch-millis
    INCREMENTAL_BETWEEN_TIMESTAMP = ConfigOption.string(
        "incremental-between-timestamp",
        None,
        description=(
            "Incremental read between two epoch-millis timestamps 't1,t2' (resolved to snapshots)."
        ),
    )
    # "a,b" snapshot ids or tag names: a exclusive, b inclusive
    INCREMENTAL_BETWEEN = ConfigOption.string(
        "incremental-between",
        None,
        description=(
            "Read incremental changes between two snapshots or tags ('3,7' or 'tagA,tagB'): start exclusive, "
            'end inclusive.'
        ),
    )
    # delta (APPEND snapshots' new files) or changelog (changelog files)
    INCREMENTAL_BETWEEN_SCAN_MODE = ConfigOption.string(
        "incremental-between-scan-mode",
        "delta",
        description=(
            'Incremental read source: delta (APPEND snapshot deltas) or changelog (changelog files of the '
            'range).'
        ),
    )
    # streaming reads (table/stream.py): the stream ends once a snapshot's
    # watermark passes this bound
    SCAN_BOUNDED_WATERMARK = ConfigOption.int_(
        "scan.bounded.watermark",
        None,
        description=(
            "Streaming reads end once a snapshot's watermark passes this bound."
        ),
    )
    STREAMING_READ_OVERWRITE = ConfigOption.bool_(
        "streaming-read-overwrite",
        False,
        description=(
            'Streaming reads also emit the new content of OVERWRITE snapshots.'
        ),
    )
    STREAMING_READ_MODE = ConfigOption.string(
        "streaming-read-mode",
        "file",
        description=(
            "Streaming source: file (lake files). 'log' needs an external log system."
        ),
    )
    # none: the changelog-aware follow-up; file-monitor: every snapshot's raw
    # delta files, compactions included
    STREAM_SCAN_MODE = ConfigOption.string(
        "stream-scan-mode",
        "none",
        description=(
            'none: normal changelog-aware follow-up; file-monitor: raw delta files of EVERY snapshot incl. '
            'compaction (compactor sources).'
        ),
    )
    CONTINUOUS_DISCOVERY_INTERVAL = ConfigOption.duration(
        "continuous.discovery-interval",
        "10 s",
        description=(
            'Poll interval for discovering new snapshots in streaming reads.'
        ),
    )
    CONSUMER_ID = ConfigOption.string("consumer-id", None, description='Consumer id protecting read progress.')
    CONSUMER_IGNORE_PROGRESS = ConfigOption.bool_(
        "consumer.ignore-progress",
        False,
        description=(
            'Start from the startup mode, ignoring saved consumer progress.'
        ),
    )
    # the subscription hub of service/subscription.py
    SUBSCRIPTION_QUEUE_DEPTH = ConfigOption.int_(
        "subscription.queue-depth",
        16,
        description=(
            "CDC subscription service: max decoded changelog batches buffered "
            "per subscriber. A queue full past subscription.shed-timeout sheds "
            "that subscriber (typed BUSY) — it never stalls the tailer."
        ),
    )
    SUBSCRIPTION_POLL_BACKOFF = ConfigOption.duration(
        "subscription.poll-backoff",
        "20 ms",
        description=(
            "CDC subscription service: initial tailer backoff when no new "
            "snapshot is available, doubling up to "
            "continuous.discovery-interval (blocking poll, no busy loop)."
        ),
    )
    SUBSCRIPTION_SHED_TIMEOUT = ConfigOption.duration(
        "subscription.shed-timeout",
        "2 s",
        description=(
            "CDC subscription service: how long the tailer waits on one "
            "subscriber's full queue (or the shared buffer budget) before "
            "shedding that subscriber with a typed SubscriberShedError carrying "
            "its durable restart offset."
        ),
    )
    SUBSCRIPTION_HEARTBEAT_INTERVAL = ConfigOption.duration(
        "subscription.heartbeat-interval",
        "5 s",
        description=(
            "CDC subscription service: cadence of durable consumer-position "
            "re-records. Each record refreshes the consumer file's mtime, so "
            "consumer.expiration-time only collects readers that stopped "
            "heartbeating."
        ),
    )
    SUBSCRIPTION_MAX_SUBSCRIBERS = ConfigOption.int_(
        "subscription.max-subscribers",
        1024,
        description=(
            "CDC subscription service: subscriber cap per table hub; subscribe() "
            "past it answers a typed BUSY immediately."
        ),
    )
    SUBSCRIPTION_REPLAY_CACHE_MAX_MEMORY = ConfigOption.memory(
        "subscription.replay-cache.max-memory",
        "32 mb",
        description=(
            "CDC subscription service: byte budget for the hub's replay cache of "
            "decoded ChangelogBatches (LRU by snapshot). The data-file cache "
            "already makes PAGE decode once-per-process; this extends decode-once "
            "to the merged batch, so catch-up replay and shed-resume reuse the "
            "tailer's decode+merge instead of re-merging per subscriber. "
            "0 b = off."
        ),
    )
    SUBSCRIPTION_BUFFER_MAX_MEMORY = ConfigOption.memory(
        "subscription.buffer.max-memory",
        "64 mb",
        description=(
            "CDC subscription service: shared byte budget for queued decoded "
            "batches across ALL subscribers of a table (the "
            "WriteBufferController riding the fan-out path). 0 b = unbounded."
        ),
    )
    # exactly-once: progress recorded on checkpoint completion;
    # at-least-once: on every plan
    CONSUMER_MODE = ConfigOption.string(
        "consumer.mode",
        "exactly-once",
        description=(
            'exactly-once: progress advances on checkpoint ack; at-least-once: on every plan.'
        ),
    )
    SNAPSHOT_WATERMARK_IDLE_TIMEOUT = ConfigOption.duration(
        "snapshot.watermark-idle-timeout",
        None,
        description=(
            'Streaming reads: advance the watermark to the snapshot commit time when no new snapshot arrived '
            'for this long.'
        ),
    )
    SOURCE_SPLIT_TARGET_SIZE = ConfigOption.memory(
        "source.split.target-size",
        "128 mb",
        description=(
            'Target size of one batch-read split.'
        ),
    )
    SOURCE_SPLIT_OPEN_FILE_COST = ConfigOption.memory(
        "source.split.open-file-cost",
        "4 mb",
        description=(
            'Weight floor per file when packing splits.'
        ),
    )
    COMMIT_MAX_RETRIES = ConfigOption.int_(
        "commit.max-retries",
        10,
        description=(
            'Bounded commit retry loop: snapshot-CAS races (and conflict re-plans) are retried this many times '
            'with commit.retry-backoff between rounds before the commit gives up (CommitGiveUpError). The seed '
            'looped forever — a livelock under heavy contention.'
        ),
    )
    # base of the jittered backoff between lost commit rounds (decorrelated,
    # capped at 100x base), slept outside the catalog lock
    COMMIT_RETRY_BACKOFF = ConfigOption.duration(
        "commit.retry-backoff",
        "10 ms",
        description=(
            'Base backoff between commit retry rounds (decorrelated jitter, capped at 100x base) so racing '
            'committers desynchronize.'
        ),
    )
    # the resilience layer (resilience/): total tries per FileIO op (1 turns
    # the retrying wrapper off), the jittered backoff between them, and a
    # per-op deadline across the tries (None: unbounded)
    FS_RETRY_MAX_ATTEMPTS = ConfigOption.int_(
        "fs.retry.max-attempts",
        3,
        description=(
            'Total tries per FileIO op before a transient fault becomes fatal (resilience.RetryingFileIO, '
            'installed by the store). 1 disables retrying entirely — the wrapper is then not even constructed.'
        ),
    )
    FS_RETRY_INITIAL_BACKOFF = ConfigOption.duration(
        "fs.retry.initial-backoff",
        "10 ms",
        description=(
            'Base backoff between IO retries; actual sleeps use decorrelated jitter (U(base, 3*prev), capped by'
            ' fs.retry.max-backoff).'
        ),
    )
    FS_RETRY_MAX_BACKOFF = ConfigOption.duration(
        "fs.retry.max-backoff",
        "2 s",
        description=(
            'Cap on a single IO retry backoff.'
        ),
    )
    FS_IO_TIMEOUT = ConfigOption.duration(
        "fs.io.timeout",
        None,
        description=(
            'Per-op wall-clock deadline spanning all retry attempts; past it the op fails with '
            'IODeadlineExceeded (counted in io{timeouts}). Unset = unbounded.'
        ),
    )
    # remove_orphan_files touches only files older than this
    ORPHAN_CLEAN_OLDER_THAN = ConfigOption.duration(
        "orphan.clean.older-than",
        "1 d",
        description=(
            'remove_orphan_files safety threshold: only files older than this are eligible for deletion (an '
            "in-flight commit's freshly written files must survive the sweep)."
        ),
    )
    # commits under a catalog lock: engaged by this option or by a store
    # whose rename is not atomic; 'file' is a lock file in the table
    # directory (exclusive create needed), 'jdbc' an external database
    COMMIT_CATALOG_LOCK = ConfigOption.bool_(
        "commit.catalog-lock.enabled",
        False,
        description=(
            'Run snapshot commits under an external catalog lock (required on stores whose rename is not '
            'atomic; reference CatalogLock SPI).'
        ),
    )
    COMMIT_CATALOG_LOCK_TYPE = ConfigOption.string(
        "commit.catalog-lock.type",
        "file",
        description=(
            "Catalog lock implementation: 'file' (lock object in the table dir; needs exclusive-create, i.e. "
            "conditional PUT on object stores) or 'jdbc' (external lock database — the only safe choice on "
            'legacy object stores without conditional PUT).'
        ),
    )
    COMMIT_CATALOG_LOCK_JDBC_PATH = ConfigOption.string(
        "commit.catalog-lock.jdbc-path",
        None,
        description=(
            'Database path for commit.catalog-lock.type=jdbc.'
        ),
    )
    COMMIT_CATALOG_LOCK_TIMEOUT = ConfigOption.float_(
        "commit.catalog-lock.acquire-timeout",
        60.0,
        description=(
            'Seconds to wait for the catalog lock before the commit fails (reference catalog option '
            'lock-acquire-timeout).'
        ),
    )
    # seconds after which a holder that stopped heartbeating counts as crashed
    COMMIT_CATALOG_LOCK_STALE_TTL = ConfigOption.float_(
        "commit.catalog-lock.check-max-sleep",
        300.0,
        description=(
            'Seconds after which a non-heartbeating lock holder is presumed crashed and its lock is swept '
            '(reference lock-check-max-sleep).'
        ),
    )
    COMMIT_FORCE_COMPACT = ConfigOption.bool_(
        "commit.force-compact",
        False,
        description=(
            'Run a full compaction as part of every batch prepare_commit.'
        ),
    )
    NUM_SORTED_RUNS_COMPACTION_TRIGGER = ConfigOption.int_(
        "num-sorted-run.compaction-trigger",
        5,
        description=(
            'Sorted runs per bucket that trigger compaction.'
        ),
    )
    NUM_SORTED_RUNS_STOP_TRIGGER = ConfigOption.int_(
        "num-sorted-run.stop-trigger",
        None,
        description=(
            'Sorted runs that block writes (default trigger+3).'
        ),
    )
    NUM_LEVELS = ConfigOption.int_(
        "num-levels",
        None,
        description=(
            'LSM levels (default trigger+1).'
        ),
    )
    COMPACTION_MAX_SIZE_AMP_PERCENT = ConfigOption.int_(
        "compaction.max-size-amplification-percent",
        200,
        description=(
            'Universal compaction size-amp trigger.'
        ),
    )
    COMPACTION_SIZE_RATIO = ConfigOption.int_(
        "compaction.size-ratio",
        1,
        description=(
            'Universal compaction size ratio percent.'
        ),
    )
    COMPACTION_MAX_FILE_NUM = ConfigOption.int_(
        "compaction.max.file-num",
        50,
        "Cap on files merged by one size-ratio/file-num pick (bounds a single compaction's input; reference "
        'compaction.max.file-num).',
        ("compaction.early-max.file-num",),
    )
    # append tables: small files concatenated once this many are in a row
    COMPACTION_MIN_FILE_NUM = ConfigOption.int_(
        "compaction.min.file-num",
        5,
        description=(
            'Min files for size-ratio pick.'
        ),
    )
    # millis; the JAX package reads this key as a bare int too
    COMPACTION_OPTIMIZATION_INTERVAL = ConfigOption.int_(
        "compaction.optimization-interval",
        None,
        description=(
            'Force full compaction every N millis.'
        ),
    )
    MANIFEST_TARGET_SIZE = ConfigOption.memory(
        "manifest.target-file-size",
        "8 mb",
        description=(
            'Manifest merge target size.'
        ),
    )
    MANIFEST_MERGE_MIN_COUNT = ConfigOption.int_(
        "manifest.merge-min-count",
        30,
        description=(
            'Small manifests before merge.'
        ),
    )
    MANIFEST_FULL_COMPACTION_THRESHOLD_SIZE = ConfigOption.memory(
        "manifest.full-compaction-threshold-size",
        "16 mb",
        description=(
            'Rewrite ALL manifests into compacted base manifests once the unmerged (delta) manifests exceed '
            'this total size.'
        ),
    )
    CHANGELOG_PRODUCER = ConfigOption.enum(
        "changelog-producer",
        ChangelogProducer,
        ChangelogProducer.NONE,
        description=(
            'How changelog files are produced.'
        ),
    )
    # drop -U/+U pairs whose values did not change (full-compaction and
    # lookup producers); the JAX package's default, true
    CHANGELOG_PRODUCER_ROW_DEDUPLICATE = ConfigOption.bool_(
        "changelog-producer.row-deduplicate",
        True,
        description=(
            'Drop -U/+U changelog pairs whose values did not change (full-compaction/lookup producers). Default'
            ' true here: the diff is a vectorized compare, effectively free (reference defaults false because '
            'its row-by-row compare costs).'
        ),
    )
    # lookup producer: false defers the changelog to the next compaction
    CHANGELOG_PRODUCER_LOOKUP_WAIT = ConfigOption.bool_(
        "changelog-producer.lookup-wait",
        True,
        description=(
            'changelog-producer=lookup: commit waits for the lookup compaction (false: defer changelog '
            'production to a later compaction).'
        ),
    )
    # "Row TTL on read/compact." (core/store.py record_expire_predicate)
    RECORD_LEVEL_EXPIRE_TIME = ConfigOption.duration(
        "record-level.expire-time", None, 'Row TTL on read/compact.', ("record-level.expire-time.ms",)
    )
    # "Row TTL time column."
    RECORD_LEVEL_TIME_FIELD = ConfigOption.string("record-level.time-field", description='Row TTL time column.')
    # "Row TTL column unit: seconds|millis|micros."
    RECORD_LEVEL_TIME_FIELD_TYPE = ConfigOption.string(
        "record-level.time-field-type",
        "seconds",
        description=(
            'Row TTL column unit: seconds|millis|micros.'
        ),
    )
    # "Roll the packed deletion-vector container at this size."
    DELETION_VECTOR_INDEX_FILE_TARGET_SIZE = ConfigOption.memory(
        "deletion-vector.index-file.target-size",
        "2 mb",
        description=(
            'Roll the packed deletion-vector container at this size.'
        ),
    )
    # "DELETE/UPDATE commands produce input changelog even when
    # changelog-producer=none." (table/delete.py)
    DELETE_FORCE_PRODUCE_CHANGELOG = ConfigOption.bool_(
        "delete.force-produce-changelog",
        False,
        description=(
            'DELETE/UPDATE commands produce input changelog even when changelog-producer=none.'
        ),
    )
    # commit-time maintenance (table/write.py TableCommit._post_commit)
    SNAPSHOT_NUM_RETAINED_MIN = ConfigOption.int_(
        "snapshot.num-retained.min",
        10,
        description=(
            'Min snapshots retained.'
        ),
    )
    SNAPSHOT_NUM_RETAINED_MAX = ConfigOption.int_(
        "snapshot.num-retained.max",
        2147483647,
        description=(
            'Max snapshots retained.'
        ),
    )
    SNAPSHOT_TIME_RETAINED = ConfigOption.duration(
        "snapshot.time-retained",
        "1 h",
        'Snapshot retention time.',
        ("snapshot.time-retained.ms",),
    )
    SNAPSHOT_EXPIRE_LIMIT = ConfigOption.int_(
        "snapshot.expire.limit",
        50,
        description=(
            'Max snapshots processed per expire run.'
        ),
    )
    SNAPSHOT_EXPIRE_CLEAN_EMPTY_DIRS = ConfigOption.bool_(
        "snapshot.expire.clean-empty-directories",
        False,
        description=(
            'Also remove bucket/partition directories left empty by expiry.'
        ),
    )
    SNAPSHOT_EXPIRE_EXECUTION_MODE = ConfigOption.string(
        "snapshot.expire.execution-mode",
        "sync",
        description=(
            'sync | async (expire runs on a background thread).'
        ),
    )
    # any of the three set decouples changelog files from snapshot expiry
    CHANGELOG_NUM_RETAINED_MIN = ConfigOption.int_(
        "changelog.num-retained.min",
        None,
        description=(
            'Min decoupled changelogs retained (enables the decoupled lifecycle).'
        ),
    )
    CHANGELOG_NUM_RETAINED_MAX = ConfigOption.int_(
        "changelog.num-retained.max",
        None,
        description=(
            'Max decoupled changelogs retained.'
        ),
    )
    CHANGELOG_TIME_RETAINED = ConfigOption.duration(
        "changelog.time-retained",
        None,
        description=(
            'Decoupled changelog retention time (enables the decoupled lifecycle).'
        ),
    )
    CONSUMER_EXPIRATION_TIME = ConfigOption.duration(
        "consumer.expiration-time", None, 'Consumer expiry.', ("consumer.expiration-time.ms",)
    )
    PARTITION_EXPIRATION_TIME = ConfigOption.duration(
        "partition.expiration-time", None, 'Partition TTL.', ("partition.expiration-time.ms",)
    )
    PARTITION_EXPIRATION_CHECK_INTERVAL = ConfigOption.duration(
        "partition.expiration-check-interval",
        "1 h",
        description=(
            'Min interval between partition-expiry sweeps piggybacked on commits.'
        ),
    )
    PARTITION_TIMESTAMP_FORMATTER = ConfigOption.string("partition.timestamp-formatter", None, description='')
    PARTITION_TIMESTAMP_PATTERN = ConfigOption.string("partition.timestamp-pattern", None, description='')
    TAG_AUTOMATIC_CREATION = ConfigOption.string(
        "tag.automatic-creation",
        "none",
        description=(
            'none|process-time|watermark.'
        ),
    )
    TAG_CREATION_PERIOD = ConfigOption.string("tag.creation-period", "daily", description='daily|hourly.')
    TAG_CREATION_DELAY = ConfigOption.duration(
        "tag.creation-delay",
        "0 ms",
        description=(
            'Extra wait after a period closes before its tag is created.'
        ),
    )
    TAG_PERIOD_FORMATTER = ConfigOption.string(
        "tag.period-formatter",
        "with_dashes",
        description=(
            'Tag name style: with_dashes (2024-01-02[ 03]) | without_dashes (20240102[03]).'
        ),
    )
    TAG_NUM_RETAINED_MAX = ConfigOption.int_(
        "tag.num-retained-max",
        None,
        description=(
            'Max auto-created tags kept (oldest pruned first).'
        ),
    )
    TAG_DEFAULT_TIME_RETAINED = ConfigOption.duration(
        "tag.default-time-retained",
        None,
        description=(
            'Auto tags older than this (by tagged snapshot time) are removed.'
        ),
    )
    TAG_CALLBACKS = ConfigOption.string(
        "tag.callbacks",
        None,
        description=(
            "Comma list of 'module:function' callables invoked as fn(table, tag_name, snapshot)."
        ),
    )
    COMMIT_CALLBACKS = ConfigOption.string(
        "commit.callbacks",
        description=(
            "Comma list of 'module:function' callables invoked as fn(table, snapshot) after commit."
        ),
    )
    COMMIT_FORCE_CREATE_SNAPSHOT = ConfigOption.bool_(
        "commit.force-create-snapshot",
        False,
        description=(
            'Create a snapshot even for an empty commit.'
        ),
    )
    # the adaptive background compactor (table/compactor.py
    # AdaptiveCompactorService) and its ingest gate
    COMPACTION_ADAPTIVE_ENABLED = ConfigOption.bool_(
        "compaction.adaptive.enabled",
        False,
        description=(
            'Drain compaction debt through the LUDA-style adaptive background scheduler '
            '(table.compactor.AdaptiveCompactorService) instead of inline with writers: hot buckets compact '
            'deeper and earlier, cold ones defer, and per-bucket read amplification stays under '
            'compaction.adaptive.read-amp-ceiling. Ingest writers typically run write-only alongside it.'
        ),
    )
    COMPACTION_ADAPTIVE_INTERVAL = ConfigOption.duration(
        "compaction.adaptive.interval",
        "200 ms",
        description=(
            "Pause between adaptive-scheduler observation rounds (each round scans the latest snapshot's "
            'per-bucket LSM shape and compacts the buckets the policy picks).'
        ),
    )
    COMPACTION_ADAPTIVE_READ_AMP_CEILING = ConfigOption.int_(
        "compaction.adaptive.read-amp-ceiling",
        12,
        description=(
            'Per-bucket sorted-run ceiling: a bucket at or above it is compacted with mandatory priority '
            'regardless of heat, bounding merge-read amplification under sustained ingest.'
        ),
    )
    COMPACTION_ADAPTIVE_TRIGGER = ConfigOption.int_(
        "compaction.adaptive.trigger",
        3,
        description=(
            'Sorted runs before a bucket becomes eligible for proactive adaptive compaction; below it the '
            'bucket is deferred (counted in compaction{deferred_buckets}).'
        ),
    )
    COMPACTION_ADAPTIVE_MAX_BUCKETS = ConfigOption.int_(
        "compaction.adaptive.max-buckets-per-round",
        2,
        description=(
            'Proactive buckets compacted per scheduler round — bounds the background work one round can steal '
            'from ingest (ceiling breaches are exempt: the read-amp bound always wins).'
        ),
    )
    COMPACTION_ADAPTIVE_DEEP_RUNS = ConfigOption.int_(
        "compaction.adaptive.deep-runs",
        8,
        description=(
            'Sorted runs at or above which an adaptive compaction goes deep (full rewrite to the top level) '
            "instead of a shallow universal pick — LUDA's compact-hotter-buckets-deeper rule."
        ),
    )
    COMPACTION_ADAPTIVE_PARALLELISM = ConfigOption.int_(
        "compaction.adaptive.parallelism",
        2,
        description=(
            "Worker threads executing the adaptive scheduler's per-bucket compactions concurrently (distinct "
            "buckets commit independently through the snapshot CAS; LUDA's premise is that compaction is cheap "
            'enough to run ahead of demand — parallel workers are how the drain rate scales past one bucket at '
            'a time).'
        ),
    )
    COMPACTION_ADAPTIVE_INGEST_GATE = ConfigOption.bool_(
        "compaction.adaptive.ingest-gate",
        True,
        description=(
            "Bound write-only ingest by the adaptive scheduler's debt-admission gate: when an "
            'AdaptiveCompactorService is running for the table, every MergeTreeWriter flush first admits '
            "against the read-amp ceiling (blocking while the target bucket's projected sorted-run count sits "
            'at/over it, up to compaction.adaptive.ingest-gate-timeout) and settles its one-run charge when the'
            ' flush lands — so ANY write-only writer is read-amp-bounded, not just harnesses that call admit() '
            'by hand.'
        ),
    )
    COMPACTION_ADAPTIVE_INGEST_GATE_TIMEOUT = ConfigOption.duration(
        "compaction.adaptive.ingest-gate-timeout",
        "30 s",
        description=(
            'Longest a gated write-only flush blocks waiting for compaction headroom; on timeout the flush '
            "proceeds (the breach is the scheduler's to drain) — the gate bounds read amplification, it must "
            'never wedge ingest on a stalled compactor.'
        ),
    )
    COMPACTION_ADAPTIVE_STARVATION_TIMEOUT = ConfigOption.duration(
        "compaction.adaptive.starvation-timeout",
        "10 s",
        description=(
            'A bucket whose compaction debt has been deferred longer than this is promoted to mandatory '
            'priority — cold buckets cannot starve under sustained skewed writes.'
        ),
    )
    # sort-compact (table/sort_compact.py): quantity rolls files by the
    # schema's row width, size by the measured one
    SORT_COMPACTION_RANGE_STRATEGY = ConfigOption.string(
        "sort-compaction.range-strategy",
        "quantity",
        description=(
            'quantity: range-split sort compaction by row count; size: by bytes (skewed row widths pack ranges '
            'evenly).'
        ),
    )
    # bytes a string or bytes column contributes to the z-order interleave
    ZORDER_VAR_LENGTH_CONTRIBUTION = ConfigOption.int_(
        "zorder.var-length-contribution",
        8,
        description=(
            'Bytes a var-length column (string/bytes) contributes to the z-order interleave.'
        ),
    )
    # equi-joins (ops/join.py): the kernel, the backend ('auto' keeps joins
    # below join.device-rows on the host, larger ones on the caller's
    # device in the sort-engine's flavour), and the skew-aware partitioning
    JOIN_ALGORITHM = ConfigOption.string(
        "join.algorithm",
        "auto",
        description=(
            "Equi-join kernel: 'hash' probes a sorted single-operand key by binary search, 'sort-merge' routes "
            "multi-operand keys through the merge kernel's sorted_segments seam (inheriting "
            "sort-engine=pallas), 'auto' picks hash exactly when the global lane plan packed the key into one "
            'fused uint32 operand.'
        ),
    )
    JOIN_ENGINE = ConfigOption.string(
        "join.engine",
        "auto",
        description=(
            "Join execution backend: 'numpy' (host lexsort/searchsorted), 'xla' or 'pallas' (device kernels). "
            "'auto' mirrors the merge rule — host below join.device-rows or on a CPU-only platform, device "
            'otherwise, with the device flavor following sort-engine.'
        ),
    )
    JOIN_DEVICE_ROWS = ConfigOption.int_(
        "join.device-rows",
        4096,
        description=(
            'Smallest combined row count (probe + build) the auto engine sends to the device kernels; smaller '
            'joins stay on the host where dispatch overhead dominates.'
        ),
    )
    JOIN_CHUNK_ROWS = ConfigOption.int_(
        "join.chunk-rows",
        1 << 20,
        description=(
            'Probe rows per join partition: a probe side larger than this splits into ceil(rows / chunk) '
            'key-disjoint partitions (bounding device batch size), with heavy-hitter keys skew-split across all'
            ' partitions (JSPIM). join.partitions overrides the count directly.'
        ),
    )
    JOIN_PARTITIONS = ConfigOption.int_(
        "join.partitions",
        0,
        description=(
            'Explicit join partition count (0 = derive from join.chunk-rows). Values > 1 enable the skew-aware '
            'split even for small probes.'
        ),
    )
    JOIN_SKEW_FACTOR = ConfigOption.float_(
        "join.skew-factor",
        0.5,
        description=(
            'A join key is a heavy hitter when it holds >= this fraction of the fair per-partition probe share '
            '(probe_rows / partitions) — a hot key cannot be subdivided by hashing, so it is dealt round-robin '
            'across every partition with its build rows replicated, and never serializes one partition (JSPIM).'
        ),
    )
    # SELECT ... JOIN planning (sql/select.py): up to this many distinct
    # keys on the smaller side prune the bigger side's scan with an IN
    # list, more with a BETWEEN over their range
    JOIN_PUSHDOWN_IN_LIMIT = ConfigOption.int_(
        "join.pushdown-in-limit",
        1024,
        description=(
            "SELECT ... JOIN planning: when the smaller side's distinct join keys number at most this, the big "
            "side's scan is pruned with an IN predicate over those keys (file/row-group skipping); above it, a "
            "BETWEEN over the small side's key range is pushed instead."
        ),
    )
    # file indexes (format/fileindex.py): per-column blooms, the composite
    # primary-key bloom the batched gets prune by, and where the payload
    # lands (embedded in the manifest entry below the threshold, else a
    # .index sidecar)
    FILE_INDEX_BLOOM_COLUMNS = ConfigOption.string(
        "file-index.bloom-filter.columns",
        None,
        description=(
            'Columns with bloom file index.'
        ),
    )
    FILE_INDEX_BLOOM_FPP = ConfigOption.float_(
        "file-index.bloom-filter.fpp",
        0.05,
        description=(
            'Bloom false-positive rate.'
        ),
    )
    FILE_INDEX_READ_ENABLED = ConfigOption.bool_(
        "file-index.read.enabled",
        True,
        description=(
            'Evaluate file index (bloom sidecars / embedded) during planning.'
        ),
    )
    FILE_INDEX_BLOOM_KEY_ENABLED = ConfigOption.bool_(
        "file-index.bloom-filter.primary-key.enabled",
        False,
        description=(
            'Primary-key tables: write a composite key bloom (one __KEY__ entry over the combined key-column '
            "hash) into every data file's PTIX index at flush/compaction time, so batched point-get planning "
            'can prune files with zero data IO.'
        ),
    )
    FILE_INDEX_BLOOM_KEY_FPP = ConfigOption.float_(
        "file-index.bloom-filter.primary-key.fpp",
        0.001,
        description=(
            'Key bloom false-positive rate. Tighter than the per-column default because a batched get probes '
            'MANY keys per file: the per-file false-positive budget must survive the union over the batch.'
        ),
    )
    FILE_INDEX_IN_MANIFEST_THRESHOLD = ConfigOption.memory(
        "file-index.in-manifest-threshold",
        "500 b",
        description=(
            'Index payloads smaller than this embed in the manifest entry instead of a sidecar file (saves one '
            'open per file per scan).'
        ),
    )
    # the process-wide caches (utils/cache.py); '0 b' opts a table out
    CACHE_MANIFEST_MAX_MEMORY = ConfigOption.memory(
        "cache.manifest.max-memory-size",
        "256 mb",
        description=(
            'Byte budget of the process-wide decoded manifest/metadata object cache (manifest entry lists, '
            "manifest-list metas, snapshots, the latest-snapshot pointer). '0 b' opts this table out."
        ),
    )
    CACHE_DATA_FILE_MAX_MEMORY = ConfigOption.memory(
        "cache.data-file.max-memory-size",
        "128 mb",
        description=(
            'Byte budget of the process-wide decoded data-file (KVBatch) cache over predicate-free '
            "reader_factory reads. '0 b' opts this table out."
        ),
    )
    # point lookups (table/query.py, lookup/)
    LOOKUP_CACHE_MAX_MEMORY_SIZE = ConfigOption.memory(
        "lookup.cache-max-memory-size",
        "256 mb",
        description=(
            'Lookup in-memory cache byte budget.'
        ),
    )
    LOOKUP_CACHE_MAX_DISK_SIZE = ConfigOption.memory(
        "lookup.cache-max-disk-size",
        f"{1 << 50} b",
        description=(
            'Lookup on-disk cache byte budget (oldest persisted lookup files evicted first).'
        ),
    )
    LOOKUP_CACHE_FILE_RETENTION = ConfigOption.duration(
        "lookup.cache-file-retention",
        "1 h",
        description=(
            'Persisted lookup files older than this are re-buildable garbage.'
        ),
    )
    LOOKUP_CACHE_BLOOM_FILTER_ENABLED = ConfigOption.bool_(
        "lookup.cache.bloom.filter.enabled",
        True,
        description=(
            'Guard lookup files with a bloom filter of their keys.'
        ),
    )
    LOOKUP_CACHE_BLOOM_FILTER_FPP = ConfigOption.float_(
        "lookup.cache.bloom.filter.fpp",
        0.05,
        description=(
            'Lookup bloom filter false-positive rate.'
        ),
    )
    LOOKUP_HASH_LOAD_FACTOR = ConfigOption.float_(
        "lookup.hash-load-factor",
        0.75,
        description=(
            "Fill ratio of the sorted-hash lookup sidecar's slot table."
        ),
    )
    LOOKUP_GET_BLOOM_PRUNE = ConfigOption.bool_(
        "lookup.get.bloom-prune.enabled",
        True,
        description=(
            'Batched gets consult per-file key blooms (and key ranges) to prune files before any data IO. Off ='
            ' every candidate file is probed.'
        ),
    )
    LOOKUP_GET_MAX_INFLIGHT = ConfigOption.int_(
        "lookup.get.max-inflight",
        64,
        description=(
            "Concurrent get_batch requests a serving endpoint (KV server / "
            "Flight do_action) admits before answering a typed BUSY instead of "
            "queueing into a timeout."
        ),
    )

    def __init__(self, options: "Options | Mapping[str, Any] | None" = None):
        self.options = options if isinstance(options, Options) else Options(options)

    @property
    def bucket(self) -> int:
        return self.options.get(CoreOptions.BUCKET)

    @property
    def file_format(self) -> str:
        return self.options.get(CoreOptions.FILE_FORMAT)

    @property
    def file_compression(self) -> str:
        return self.options.get(CoreOptions.FILE_COMPRESSION)

    @property
    def file_compression_per_level(self) -> dict[int, str]:
        """'0:zstd,5:none' -> {0: 'zstd', 5: 'none'}."""
        return _per_level(self.options.get(CoreOptions.FILE_COMPRESSION_PER_LEVEL), "file.compression.per.level")

    @property
    def file_format_per_level(self) -> dict[int, str]:
        """'0:avro,5:parquet' -> {0: 'avro', 5: 'parquet'}."""
        return _per_level(self.options.get(CoreOptions.FILE_FORMAT_PER_LEVEL), "file.format.per.level")

    @property
    def write_buffer_max_memory(self) -> int:
        return int(self.options.get(CoreOptions.WRITE_BUFFER_MAX_MEMORY))

    @property
    def write_buffer_block_timeout_ms(self) -> int:
        return self.options.get(CoreOptions.WRITE_BUFFER_BLOCK_TIMEOUT)

    @property
    def manifest_compression(self) -> str:
        return str(self.options.get(CoreOptions.MANIFEST_COMPRESSION)).lower()

    @property
    def merge_engine(self) -> MergeEngine:
        return self.options.get(CoreOptions.MERGE_ENGINE)

    @property
    def sort_engine(self) -> SortEngine:
        return self.options.get(CoreOptions.SORT_ENGINE)

    @property
    def lane_compression(self) -> bool:
        return self.options.get(CoreOptions.MERGE_LANE_COMPRESSION)

    @property
    def target_file_size(self) -> int:
        return int(self.options.get(CoreOptions.TARGET_FILE_SIZE))

    @property
    def write_buffer_rows(self) -> int:
        return self.options.get(CoreOptions.WRITE_BUFFER_ROWS)

    @property
    def write_buffer_size(self) -> int:
        return int(self.options.get(CoreOptions.WRITE_BUFFER_SIZE))

    @property
    def write_only(self) -> bool:
        return self.options.get(CoreOptions.WRITE_ONLY)

    @property
    def num_sorted_runs_compaction_trigger(self) -> int:
        return self.options.get(CoreOptions.NUM_SORTED_RUNS_COMPACTION_TRIGGER)

    @property
    def num_sorted_runs_stop_trigger(self) -> int:
        v = self.options.get(CoreOptions.NUM_SORTED_RUNS_STOP_TRIGGER)
        return v if v is not None else self.num_sorted_runs_compaction_trigger + 3

    @property
    def num_levels(self) -> int:
        v = self.options.get(CoreOptions.NUM_LEVELS)
        return v if v is not None else self.num_sorted_runs_compaction_trigger + 1

    @property
    def compaction_min_file_num(self) -> int:
        return self.options.get(CoreOptions.COMPACTION_MIN_FILE_NUM)

    @property
    def max_size_amplification_percent(self) -> int:
        return self.options.get(CoreOptions.COMPACTION_MAX_SIZE_AMP_PERCENT)

    @property
    def size_ratio(self) -> int:
        return self.options.get(CoreOptions.COMPACTION_SIZE_RATIO)

    @property
    def snapshot_num_retained_min(self) -> int:
        return self.options.get(CoreOptions.SNAPSHOT_NUM_RETAINED_MIN)

    @property
    def snapshot_num_retained_max(self) -> int:
        return self.options.get(CoreOptions.SNAPSHOT_NUM_RETAINED_MAX)

    @property
    def snapshot_time_retained_ms(self) -> int:
        return self.options.get(CoreOptions.SNAPSHOT_TIME_RETAINED)

    @property
    def ignore_delete(self) -> bool:
        return self.options.get(CoreOptions.IGNORE_DELETE)

    @property
    def changelog_producer(self) -> ChangelogProducer:
        return self.options.get(CoreOptions.CHANGELOG_PRODUCER)

    @property
    def sequence_field(self) -> list[str]:
        v = self.options.get(CoreOptions.SEQUENCE_FIELD)
        return [s.strip() for s in v.split(",")] if v else []

    def field_option(self, field_name: str, suffix: str) -> str | None:
        """fields.<field_name>.<suffix> (aggregate-function, ignore-retract,
        list-agg-delimiter), or None when unset."""
        return self.options._data.get(f"fields.{field_name}.{suffix}")
