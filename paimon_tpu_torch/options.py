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
    fallback_keys: tuple[str, ...] = ()

    @staticmethod
    def string(key: str, default: str | None = None):
        return ConfigOption(key, default, lambda v: None if v is None else str(v))

    @staticmethod
    def int_(key: str, default: int | None = None, fallback: tuple[str, ...] = ()):
        return ConfigOption(key, default, lambda v: None if v is None else int(v), fallback)

    @staticmethod
    def bool_(key: str, default: bool = False, fallback: tuple[str, ...] = ()):
        return ConfigOption(key, default, lambda v: v if isinstance(v, bool) else str(v).lower() == "true", fallback)

    @staticmethod
    def duration(key: str, default: "str | None", fallback: tuple[str, ...] = ()):
        """Millis (int | None), parsed by parse_duration_millis."""
        d = None if default is None else parse_duration_millis(default)
        return ConfigOption(key, d, lambda v: None if v is None else parse_duration_millis(v), fallback)

    @staticmethod
    def float_(key: str, default: float | None = None):
        return ConfigOption(key, default, lambda v: None if v is None else float(v))

    @staticmethod
    def memory(key: str, default: str):
        return ConfigOption(key, MemorySize.parse(default), MemorySize.parse)

    @staticmethod
    def enum(key: str, enum_cls, default, fallback: tuple[str, ...] = ()):
        def parse(v):
            return v if isinstance(v, enum_cls) else enum_cls(str(v).lower().replace("_", "-"))

        return ConfigOption(key, default, parse, fallback)


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
    """The options this slice reads, with the JAX package's keys/defaults."""

    BUCKET = ConfigOption.int_("bucket", -1)
    DYNAMIC_BUCKET_TARGET_ROW_NUM = ConfigOption.int_("dynamic-bucket.target-row-num", 2_000_000)
    DYNAMIC_BUCKET_INITIAL_BUCKETS = ConfigOption.int_("dynamic-bucket.initial-buckets", None)
    DYNAMIC_BUCKET_ASSIGNER_PARALLELISM = ConfigOption.int_("dynamic-bucket.assigner-parallelism", None)
    PARTITION_DEFAULT_NAME = ConfigOption.string("partition.default-name", "__DEFAULT_PARTITION__")
    SCAN_PLAN_SORT_PARTITION = ConfigOption.bool_("scan.plan-sort-partition", False)
    FILE_FORMAT = ConfigOption.string("file.format", "parquet")
    FILE_COMPRESSION = ConfigOption.string("file.compression", "zstd")
    # the port's zstd encoder has one strength and reads this key nowhere:
    # a level changes the size of the files the JAX package writes, never
    # the rows, and nothing the port writes
    FILE_COMPRESSION_ZSTD_LEVEL = ConfigOption.int_("file.compression.zstd-level", 1)
    FILE_COMPRESSION_PER_LEVEL = ConfigOption.string("file.compression.per.level", None)
    MANIFEST_FORMAT = ConfigOption.string("manifest.format", "jsonl")
    MANIFEST_COMPRESSION = ConfigOption.string("manifest.compression", "default")
    TARGET_FILE_SIZE = ConfigOption.memory("target-file-size", "128 mb")
    WRITE_BUFFER_SIZE = ConfigOption.memory("write-buffer-size", "256 mb")
    WRITE_BUFFER_ROWS = ConfigOption.int_("write-buffer-rows", 1_000_000)
    LOCAL_MERGE_BUFFER_SIZE = ConfigOption.memory("local-merge-buffer-size", "0 b")
    # read only to refuse them on append tables: the spilling buffer
    # (core/disk.py) is not ported
    WRITE_BUFFER_SPILLABLE = ConfigOption.bool_("write-buffer-spillable", False)
    WRITE_BUFFER_FOR_APPEND = ConfigOption.bool_("write-buffer-for-append", False)
    WRITE_ONLY = ConfigOption.bool_("write-only", False, fallback=("write.compaction-skip",))
    MERGE_ENGINE = ConfigOption.enum("merge-engine", MergeEngine, MergeEngine.DEDUPLICATE)
    IGNORE_DELETE = ConfigOption.bool_(
        "ignore-delete",
        False,
        fallback=(
            "first-row.ignore-delete",
            "deduplicate.ignore-delete",
            "partial-update.ignore-delete",
        ),
    )
    SORT_ENGINE = ConfigOption.enum("sort-engine", SortEngine, SortEngine.XLA_SEGMENTED)
    MERGE_LANE_COMPRESSION = ConfigOption.bool_("merge.lane-compression", True)
    MERGE_READ_BATCH_ROWS = ConfigOption.int_("merge.read-batch-rows", 8 << 20)
    # the code domain: readers hand dictionary-encoded chunks over as
    # (sorted pool, uint32 codes) columns; a dictionary or unified merge pool
    # past the limit expands instead
    MERGE_DICT_DOMAIN = ConfigOption.bool_("merge.dict-domain", False)
    MERGE_DICT_DOMAIN_POOL_LIMIT = ConfigOption.int_("merge.dict-domain.pool-limit", 1 << 20)
    SEQUENCE_FIELD = ConfigOption.string("sequence.field", None)
    PARTIAL_UPDATE_REMOVE_RECORD_ON_DELETE = ConfigOption.bool_("partial-update.remove-record-on-delete", False)
    AGGREGATE_DEFAULT_FUNC = ConfigOption.string("fields.default-aggregate-function", None)
    ROWKIND_FIELD = ConfigOption.string("rowkind.field", None)
    # INSERT OVERWRITE without a partition filter replaces only the
    # partitions the new rows touch (false: the whole table)
    DYNAMIC_PARTITION_OVERWRITE = ConfigOption.bool_("dynamic-partition-overwrite", True)
    # cross-partition upsert (table/crosspartition.py): threads reading the
    # key columns at bootstrap, and the index entries' lifetime (None: no
    # expiry)
    CROSS_PARTITION_UPSERT_BOOTSTRAP_PARALLELISM = ConfigOption.int_(
        "cross-partition-upsert.bootstrap-parallelism", 10
    )
    CROSS_PARTITION_UPSERT_INDEX_TTL = ConfigOption.duration("cross-partition-upsert.index-ttl", None)
    # "Deletion-vector mode." (table/delete.py)
    DELETION_VECTORS_ENABLED = ConfigOption.bool_("deletion-vectors.enabled", False)
    BRANCH = ConfigOption.string("branch", "main")
    # time travel and incremental reads (table/read.py TableScan)
    SCAN_MODE = ConfigOption.enum("scan.mode", StartupMode, StartupMode.DEFAULT, ("log.scan",))
    SCAN_SNAPSHOT_ID = ConfigOption.int_("scan.snapshot-id", None)
    SCAN_TIMESTAMP_MILLIS = ConfigOption.int_("scan.timestamp-millis", None, ("log.scan.timestamp-millis",))
    # "YYYY-MM-DD[ HH:MM:SS[.ffffff]]" in the local zone
    SCAN_TIMESTAMP = ConfigOption.string("scan.timestamp", None)
    SCAN_TAG_NAME = ConfigOption.string("scan.tag-name", None)
    # a tag name, else a snapshot id
    SCAN_VERSION = ConfigOption.string("scan.version", None)
    # the earliest snapshot whose watermark is at least this
    SCAN_WATERMARK = ConfigOption.int_("scan.watermark", None)
    # only the data files created after this epoch-millis
    SCAN_FILE_CREATION_TIME_MILLIS = ConfigOption.int_("scan.file-creation-time-millis", None)
    SCAN_MAX_SPLITS_PER_TASK = ConfigOption.int_("scan.max-splits-per-task", 10)
    # "t1,t2" epoch-millis
    INCREMENTAL_BETWEEN_TIMESTAMP = ConfigOption.string("incremental-between-timestamp", None)
    # "a,b" snapshot ids or tag names: a exclusive, b inclusive
    INCREMENTAL_BETWEEN = ConfigOption.string("incremental-between", None)
    # delta (APPEND snapshots' new files) or changelog (changelog files)
    INCREMENTAL_BETWEEN_SCAN_MODE = ConfigOption.string("incremental-between-scan-mode", "delta")
    # streaming reads (table/stream.py): the stream ends once a snapshot's
    # watermark passes this bound
    SCAN_BOUNDED_WATERMARK = ConfigOption.int_("scan.bounded.watermark", None)
    STREAMING_READ_OVERWRITE = ConfigOption.bool_("streaming-read-overwrite", False)
    STREAMING_READ_MODE = ConfigOption.string("streaming-read-mode", "file")
    # none: the changelog-aware follow-up; file-monitor: every snapshot's raw
    # delta files, compactions included
    STREAM_SCAN_MODE = ConfigOption.string("stream-scan-mode", "none")
    CONTINUOUS_DISCOVERY_INTERVAL = ConfigOption.duration("continuous.discovery-interval", "10 s")
    CONSUMER_ID = ConfigOption.string("consumer-id", None)
    CONSUMER_IGNORE_PROGRESS = ConfigOption.bool_("consumer.ignore-progress", False)
    # exactly-once: progress recorded on checkpoint completion;
    # at-least-once: on every plan
    CONSUMER_MODE = ConfigOption.string("consumer.mode", "exactly-once")
    SNAPSHOT_WATERMARK_IDLE_TIMEOUT = ConfigOption.duration("snapshot.watermark-idle-timeout", None)
    SOURCE_SPLIT_TARGET_SIZE = ConfigOption.memory("source.split.target-size", "128 mb")
    SOURCE_SPLIT_OPEN_FILE_COST = ConfigOption.memory("source.split.open-file-cost", "4 mb")
    COMMIT_MAX_RETRIES = ConfigOption.int_("commit.max-retries", 10)
    COMMIT_FORCE_COMPACT = ConfigOption.bool_("commit.force-compact", False)
    NUM_SORTED_RUNS_COMPACTION_TRIGGER = ConfigOption.int_("num-sorted-run.compaction-trigger", 5)
    NUM_SORTED_RUNS_STOP_TRIGGER = ConfigOption.int_("num-sorted-run.stop-trigger", None)  # default trigger+3
    NUM_LEVELS = ConfigOption.int_("num-levels", None)  # default trigger+1
    COMPACTION_MAX_SIZE_AMP_PERCENT = ConfigOption.int_("compaction.max-size-amplification-percent", 200)
    COMPACTION_SIZE_RATIO = ConfigOption.int_("compaction.size-ratio", 1)
    COMPACTION_MAX_FILE_NUM = ConfigOption.int_("compaction.max.file-num", 50, ("compaction.early-max.file-num",))
    # append tables: small files concatenated once this many are in a row
    COMPACTION_MIN_FILE_NUM = ConfigOption.int_("compaction.min.file-num", 5)
    # millis; the JAX package reads this key as a bare int too
    COMPACTION_OPTIMIZATION_INTERVAL = ConfigOption.int_("compaction.optimization-interval", None)
    MANIFEST_TARGET_SIZE = ConfigOption.memory("manifest.target-file-size", "8 mb")
    MANIFEST_MERGE_MIN_COUNT = ConfigOption.int_("manifest.merge-min-count", 30)
    MANIFEST_FULL_COMPACTION_THRESHOLD_SIZE = ConfigOption.memory("manifest.full-compaction-threshold-size", "16 mb")
    CHANGELOG_PRODUCER = ConfigOption.enum("changelog-producer", ChangelogProducer, ChangelogProducer.NONE)
    # drop -U/+U pairs whose values did not change (full-compaction and
    # lookup producers); the JAX package's default, true
    CHANGELOG_PRODUCER_ROW_DEDUPLICATE = ConfigOption.bool_("changelog-producer.row-deduplicate", True)
    # lookup producer: false defers the changelog to the next compaction
    CHANGELOG_PRODUCER_LOOKUP_WAIT = ConfigOption.bool_("changelog-producer.lookup-wait", True)
    # "Row TTL on read/compact." (core/store.py record_expire_predicate)
    RECORD_LEVEL_EXPIRE_TIME = ConfigOption.duration(
        "record-level.expire-time", None, ("record-level.expire-time.ms",)
    )
    # "Row TTL time column."
    RECORD_LEVEL_TIME_FIELD = ConfigOption.string("record-level.time-field")
    # "Row TTL column unit: seconds|millis|micros."
    RECORD_LEVEL_TIME_FIELD_TYPE = ConfigOption.string("record-level.time-field-type", "seconds")
    # "Roll the packed deletion-vector container at this size."
    DELETION_VECTOR_INDEX_FILE_TARGET_SIZE = ConfigOption.memory("deletion-vector.index-file.target-size", "2 mb")
    # "DELETE/UPDATE commands produce input changelog even when
    # changelog-producer=none." (table/delete.py)
    DELETE_FORCE_PRODUCE_CHANGELOG = ConfigOption.bool_("delete.force-produce-changelog", False)
    # commit-time maintenance (table/write.py TableCommit._post_commit)
    SNAPSHOT_NUM_RETAINED_MIN = ConfigOption.int_("snapshot.num-retained.min", 10)
    SNAPSHOT_NUM_RETAINED_MAX = ConfigOption.int_("snapshot.num-retained.max", 2147483647)
    SNAPSHOT_TIME_RETAINED = ConfigOption.duration("snapshot.time-retained", "1 h", ("snapshot.time-retained.ms",))
    SNAPSHOT_EXPIRE_LIMIT = ConfigOption.int_("snapshot.expire.limit", 50)
    SNAPSHOT_EXPIRE_CLEAN_EMPTY_DIRS = ConfigOption.bool_("snapshot.expire.clean-empty-directories", False)
    SNAPSHOT_EXPIRE_EXECUTION_MODE = ConfigOption.string("snapshot.expire.execution-mode", "sync")
    # any of the three set decouples changelog files from snapshot expiry
    CHANGELOG_NUM_RETAINED_MIN = ConfigOption.int_("changelog.num-retained.min", None)
    CHANGELOG_NUM_RETAINED_MAX = ConfigOption.int_("changelog.num-retained.max", None)
    CHANGELOG_TIME_RETAINED = ConfigOption.duration("changelog.time-retained", None)
    CONSUMER_EXPIRATION_TIME = ConfigOption.duration(
        "consumer.expiration-time", None, ("consumer.expiration-time.ms",)
    )
    PARTITION_EXPIRATION_TIME = ConfigOption.duration(
        "partition.expiration-time", None, ("partition.expiration-time.ms",)
    )
    PARTITION_EXPIRATION_CHECK_INTERVAL = ConfigOption.duration("partition.expiration-check-interval", "1 h")
    PARTITION_TIMESTAMP_FORMATTER = ConfigOption.string("partition.timestamp-formatter", None)
    PARTITION_TIMESTAMP_PATTERN = ConfigOption.string("partition.timestamp-pattern", None)
    TAG_AUTOMATIC_CREATION = ConfigOption.string("tag.automatic-creation", "none")
    TAG_CREATION_PERIOD = ConfigOption.string("tag.creation-period", "daily")
    TAG_CREATION_DELAY = ConfigOption.duration("tag.creation-delay", "0 ms")
    TAG_PERIOD_FORMATTER = ConfigOption.string("tag.period-formatter", "with_dashes")
    TAG_NUM_RETAINED_MAX = ConfigOption.int_("tag.num-retained-max", None)
    TAG_DEFAULT_TIME_RETAINED = ConfigOption.duration("tag.default-time-retained", None)
    TAG_CALLBACKS = ConfigOption.string("tag.callbacks", None)
    COMMIT_CALLBACKS = ConfigOption.string("commit.callbacks")
    COMMIT_FORCE_CREATE_SNAPSHOT = ConfigOption.bool_("commit.force-create-snapshot", False)
    # the adaptive background compactor (table/compactor.py
    # AdaptiveCompactorService) and its ingest gate
    COMPACTION_ADAPTIVE_ENABLED = ConfigOption.bool_("compaction.adaptive.enabled", False)
    COMPACTION_ADAPTIVE_INTERVAL = ConfigOption.duration("compaction.adaptive.interval", "200 ms")
    COMPACTION_ADAPTIVE_READ_AMP_CEILING = ConfigOption.int_("compaction.adaptive.read-amp-ceiling", 12)
    COMPACTION_ADAPTIVE_TRIGGER = ConfigOption.int_("compaction.adaptive.trigger", 3)
    COMPACTION_ADAPTIVE_MAX_BUCKETS = ConfigOption.int_("compaction.adaptive.max-buckets-per-round", 2)
    COMPACTION_ADAPTIVE_DEEP_RUNS = ConfigOption.int_("compaction.adaptive.deep-runs", 8)
    COMPACTION_ADAPTIVE_PARALLELISM = ConfigOption.int_("compaction.adaptive.parallelism", 2)
    COMPACTION_ADAPTIVE_INGEST_GATE = ConfigOption.bool_("compaction.adaptive.ingest-gate", True)
    COMPACTION_ADAPTIVE_INGEST_GATE_TIMEOUT = ConfigOption.duration("compaction.adaptive.ingest-gate-timeout", "30 s")
    COMPACTION_ADAPTIVE_STARVATION_TIMEOUT = ConfigOption.duration("compaction.adaptive.starvation-timeout", "10 s")
    # sort-compact (table/sort_compact.py): quantity rolls files by the
    # schema's row width, size by the measured one
    SORT_COMPACTION_RANGE_STRATEGY = ConfigOption.string("sort-compaction.range-strategy", "quantity")
    # bytes a string or bytes column contributes to the z-order interleave
    ZORDER_VAR_LENGTH_CONTRIBUTION = ConfigOption.int_("zorder.var-length-contribution", 8)
    # equi-joins (ops/join.py): the kernel, the backend ('auto' keeps joins
    # below join.device-rows on the host, larger ones on the caller's
    # device in the sort-engine's flavour), and the skew-aware partitioning
    JOIN_ALGORITHM = ConfigOption.string("join.algorithm", "auto")
    JOIN_ENGINE = ConfigOption.string("join.engine", "auto")
    JOIN_DEVICE_ROWS = ConfigOption.int_("join.device-rows", 4096)
    JOIN_CHUNK_ROWS = ConfigOption.int_("join.chunk-rows", 1 << 20)
    JOIN_PARTITIONS = ConfigOption.int_("join.partitions", 0)
    JOIN_SKEW_FACTOR = ConfigOption.float_("join.skew-factor", 0.5)
    # SELECT ... JOIN planning (sql/select.py): up to this many distinct
    # keys on the smaller side prune the bigger side's scan with an IN
    # list, more with a BETWEEN over their range
    JOIN_PUSHDOWN_IN_LIMIT = ConfigOption.int_("join.pushdown-in-limit", 1024)
    # file indexes (format/fileindex.py): per-column blooms, the composite
    # primary-key bloom the batched gets prune by, and where the payload
    # lands (embedded in the manifest entry below the threshold, else a
    # .index sidecar)
    FILE_INDEX_BLOOM_COLUMNS = ConfigOption.string("file-index.bloom-filter.columns", None)
    FILE_INDEX_BLOOM_FPP = ConfigOption.float_("file-index.bloom-filter.fpp", 0.05)
    FILE_INDEX_READ_ENABLED = ConfigOption.bool_("file-index.read.enabled", True)
    FILE_INDEX_BLOOM_KEY_ENABLED = ConfigOption.bool_("file-index.bloom-filter.primary-key.enabled", False)
    FILE_INDEX_BLOOM_KEY_FPP = ConfigOption.float_("file-index.bloom-filter.primary-key.fpp", 0.001)
    FILE_INDEX_IN_MANIFEST_THRESHOLD = ConfigOption.memory("file-index.in-manifest-threshold", "500 b")
    # the process-wide caches (utils/cache.py); '0 b' opts a table out
    CACHE_MANIFEST_MAX_MEMORY = ConfigOption.memory("cache.manifest.max-memory-size", "256 mb")
    CACHE_DATA_FILE_MAX_MEMORY = ConfigOption.memory("cache.data-file.max-memory-size", "128 mb")
    # point lookups (table/query.py, lookup/)
    LOOKUP_CACHE_MAX_MEMORY_SIZE = ConfigOption.memory("lookup.cache-max-memory-size", "256 mb")
    LOOKUP_CACHE_MAX_DISK_SIZE = ConfigOption.memory("lookup.cache-max-disk-size", f"{1 << 50} b")
    LOOKUP_CACHE_FILE_RETENTION = ConfigOption.duration("lookup.cache-file-retention", "1 h")
    LOOKUP_CACHE_BLOOM_FILTER_ENABLED = ConfigOption.bool_("lookup.cache.bloom.filter.enabled", True)
    LOOKUP_CACHE_BLOOM_FILTER_FPP = ConfigOption.float_("lookup.cache.bloom.filter.fpp", 0.05)
    LOOKUP_HASH_LOAD_FACTOR = ConfigOption.float_("lookup.hash-load-factor", 0.75)
    LOOKUP_GET_BLOOM_PRUNE = ConfigOption.bool_("lookup.get.bloom-prune.enabled", True)

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
        spec = self.options.get(CoreOptions.FILE_COMPRESSION_PER_LEVEL)
        out: dict[int, str] = {}
        for part in (spec or "").split(","):
            if not part.strip():
                continue
            level, _, codec = part.strip().partition(":")
            if not codec:
                raise ValueError(f"file.compression.per.level needs 'level:codec' pairs, got {part!r}")
            out[int(level)] = codec.strip()
        return out

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
