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

__all__ = ["ConfigOption", "Options", "MemorySize", "CoreOptions", "MergeEngine", "SortEngine"]


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
    def memory(key: str, default: str):
        return ConfigOption(key, MemorySize.parse(default), MemorySize.parse)

    @staticmethod
    def enum(key: str, enum_cls, default):
        def parse(v):
            return v if isinstance(v, enum_cls) else enum_cls(str(v).lower().replace("_", "-"))

        return ConfigOption(key, default, parse)


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

    def set_key(self, option: ConfigOption) -> str | None:
        """The key under which option is set (its own or a fallback), or
        None when it is left at its default."""
        return next((k for k in (option.key, *option.fallback_keys) if k in self._data), None)


class MergeEngine(str, enum.Enum):
    DEDUPLICATE = "deduplicate"
    PARTIAL_UPDATE = "partial-update"
    AGGREGATE = "aggregation"
    FIRST_ROW = "first-row"


class SortEngine(str, enum.Enum):
    XLA_SEGMENTED = "xla-segmented"  # plain torch ops
    PALLAS = "pallas"  # the hand-written Hopper kernels
    NUMPY = "numpy"  # host oracle


class CoreOptions:
    """The options this slice reads, with the JAX package's keys/defaults."""

    BUCKET = ConfigOption.int_("bucket", -1)
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
    SEQUENCE_FIELD = ConfigOption.string("sequence.field", None)
    PARTIAL_UPDATE_REMOVE_RECORD_ON_DELETE = ConfigOption.bool_("partial-update.remove-record-on-delete", False)
    AGGREGATE_DEFAULT_FUNC = ConfigOption.string("fields.default-aggregate-function", None)
    ROWKIND_FIELD = ConfigOption.string("rowkind.field", None)
    DELETION_VECTORS_ENABLED = ConfigOption.bool_("deletion-vectors.enabled", False)
    BRANCH = ConfigOption.string("branch", "main")
    SCAN_MODE = ConfigOption("scan.mode", "default", str, ("log.scan",))
    SCAN_SNAPSHOT_ID = ConfigOption.int_("scan.snapshot-id", None)
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
    # millis; the JAX package reads this key as a bare int too
    COMPACTION_OPTIMIZATION_INTERVAL = ConfigOption.int_("compaction.optimization-interval", None)
    # keys of features the port does not write yet: tables that are not
    # write-only raise on them (table/write.py), so only their keys are kept
    CHANGELOG_PRODUCER = ConfigOption.string("changelog-producer", "none")
    RECORD_LEVEL_EXPIRE_TIME = ConfigOption("record-level.expire-time", None, str, ("record-level.expire-time.ms",))
    SNAPSHOT_NUM_RETAINED_MAX = ConfigOption.int_("snapshot.num-retained.max", 2147483647)
    SNAPSHOT_TIME_RETAINED = ConfigOption("snapshot.time-retained", "1 h", str, ("snapshot.time-retained.ms",))

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
    def max_size_amplification_percent(self) -> int:
        return self.options.get(CoreOptions.COMPACTION_MAX_SIZE_AMP_PERCENT)

    @property
    def size_ratio(self) -> int:
        return self.options.get(CoreOptions.COMPACTION_SIZE_RATIO)

    @property
    def ignore_delete(self) -> bool:
        return self.options.get(CoreOptions.IGNORE_DELETE)

    @property
    def sequence_field(self) -> list[str]:
        v = self.options.get(CoreOptions.SEQUENCE_FIELD)
        return [s.strip() for s in v.split(",")] if v else []

    def field_option(self, field_name: str, suffix: str) -> str | None:
        """fields.<field_name>.<suffix> (aggregate-function, ignore-retract,
        list-agg-delimiter), or None when unset."""
        return self.options._data.get(f"fields.{field_name}.{suffix}")
