"""CDC source formats (port of paimon_tpu/table/cdc_format.py): parse
change-capture JSON streams into CdcRecords, format changelog events back
into them, and CdcStream, the parse -> schema-evolving sink pipeline.

Parsers: debezium (payload/before/after, op c|r -> +I, u -> -U/+U, d ->
-D; tombstones skipped), canal (data[]/old[], type INSERT|UPDATE|DELETE;
DDL types carry no rows), maxwell (data/old, type insert|update|delete;
bootstrap and table events carry no rows) and plain json (each message one
+I row), under their names and their "-json" aliases. The formatters are
their inverses, so parse(format(events)) == events: a -U immediately
followed by its +U travels as one UPDATE message. Errors are the JAX
package's: an unknown op or type, a -U not followed by +U, a dangling -U,
and plain json refusing retractions, each a ValueError.

CdcStream resumes after the last streaming identifier its commit user
committed. It skips every sentinel identifier of the batch and maintenance
commits, (1 << 63) - 1 down to (1 << 63) - 5 (a batch write, a DELETE, a
sort-compact, a partition-maintenance commit, an ANALYZE), as the port's
commit filter does (core/commit.py SENTINEL_IDENTIFIERS_FROM). The JAX
package skips the batch one alone: after a DELETE by the same user it
resumes from (1 << 63) - 2, so that its next commit takes the batch
sentinel and the one after passes int64 (ROADMAP Queue 3 item 27).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Iterable, Iterator, Mapping

from ..core.commit import SENTINEL_IDENTIFIERS_FROM
from .cdc import CdcRecord, CdcTableWrite

__all__ = [
    "parse_debezium",
    "parse_canal",
    "parse_maxwell",
    "parse_json",
    "get_cdc_parser",
    "format_debezium",
    "format_canal",
    "format_maxwell",
    "format_json",
    "get_cdc_formatter",
    "encode_changelog",
    "CdcStream",
]


def _loads(message: str | bytes | Mapping | None):
    # text first: the Mapping check is an ABC check, slow per message
    if isinstance(message, (str, bytes, bytearray)):
        return json.loads(message)
    if message is None or isinstance(message, Mapping):
        return message
    return json.loads(message)


def parse_debezium(message: str | bytes | Mapping) -> list[CdcRecord]:
    """Debezium JSON (optionally schema-wrapped): op c/r -> +I, u -> -U/+U,
    d -> -D; tombstones (null payload / null message) are skipped
    (reference DebeziumRecordParser ignores null payloads)."""
    node = _loads(message)
    if node is None:
        return []
    if "payload" in node:
        node = node["payload"]
        if node is None:  # kafka compaction tombstone after a delete
            return []
    op = node.get("op")
    before = node.get("before")
    after = node.get("after")
    if op in ("c", "r"):
        return [CdcRecord(after, "+I")] if after else []
    if op == "u":
        out = []
        if before:
            out.append(CdcRecord(before, "-U"))
        if after:
            out.append(CdcRecord(after, "+U"))
        return out
    if op == "d":
        return [CdcRecord(before, "-D")] if before else []
    raise ValueError(f"unknown debezium op {op!r}")


def parse_canal(message: str | bytes | Mapping) -> list[CdcRecord]:
    """Canal JSON: type INSERT/UPDATE/DELETE with data[] rows and old[]
    pre-images (reference CanalRecordParser)."""
    node = _loads(message)
    typ = (node.get("type") or "").upper()
    rows = node.get("data") or []
    olds = node.get("old") or []
    out: list[CdcRecord] = []
    if typ == "INSERT":
        out.extend(CdcRecord(r, "+I") for r in rows)
    elif typ == "UPDATE":
        for i, r in enumerate(rows):
            old = olds[i] if i < len(olds) and olds[i] else {}
            # canal's old[] carries only changed fields: pre-image = row + old
            before = {**r, **old}
            out.append(CdcRecord(before, "-U"))
            out.append(CdcRecord(r, "+U"))
    elif typ == "DELETE":
        out.extend(CdcRecord(r, "-D") for r in rows)
    elif typ in ("CREATE", "ALTER", "QUERY", "TRUNCATE"):
        return []  # DDL events carry no rows; schema evolves from data
    else:
        raise ValueError(f"unknown canal type {typ!r}")
    return out


def parse_maxwell(message: str | bytes | Mapping) -> list[CdcRecord]:
    """Maxwell JSON: type insert/update/delete with data and old
    (reference MaxwellRecordParser)."""
    node = _loads(message)
    typ = node.get("type")
    data = node.get("data") or {}
    old = node.get("old") or {}
    if typ == "insert" or typ == "bootstrap-insert":
        return [CdcRecord(data, "+I")]
    if typ == "update":
        return [CdcRecord({**data, **old}, "-U"), CdcRecord(data, "+U")]
    if typ == "delete":
        return [CdcRecord(data, "-D")]
    if typ in ("bootstrap-start", "bootstrap-complete", "table-create", "table-alter"):
        return []
    raise ValueError(f"unknown maxwell type {typ!r}")


def parse_json(message: str | bytes | Mapping) -> list[CdcRecord]:
    """Plain JSON records: each message is one +I row."""
    return [CdcRecord(_loads(message), "+I")]


# ---------------------------------------------------------------------------
# wire formatters: the encode half of each parser; parse(format(events)) ==
# events, -U/+U pairs folding into one UPDATE message and back
# ---------------------------------------------------------------------------


def _pair_events(events: Iterable[tuple[str, Mapping]]) -> Iterator[tuple[str, Mapping, Mapping | None]]:
    """Group a changelog event stream into wire units: ('+I', row, None),
    ('-D', row, None), or ('U', after, before) for a -U immediately followed
    by its +U (the changelog producers always emit the pair adjacently)."""
    pending_before: Mapping | None = None
    for kind, row in events:
        if pending_before is not None:
            if kind != "+U":
                raise ValueError(f"-U not followed by +U (got {kind!r})")
            yield "U", row, pending_before
            pending_before = None
        elif kind == "-U":
            pending_before = row
        elif kind in ("+I", "+U"):
            # a lone +U (e.g. dedup dropped its -U) wires as an insert-style
            # upsert: the parsers return it as +I, which folds identically
            yield "+I", row, None
        elif kind == "-D":
            yield "-D", row, None
        else:
            raise ValueError(f"unknown row kind {kind!r}")
    if pending_before is not None:
        raise ValueError("dangling -U at end of stream")


def format_debezium(events: Iterable[tuple[str, Mapping]]) -> list[str]:
    """Changelog events -> debezium JSON messages (op c/u/d with
    before/after), the inverse of parse_debezium."""
    out = []
    for unit, after, before in _pair_events(events):
        if unit == "+I":
            node = {"op": "c", "before": None, "after": dict(after)}
        elif unit == "U":
            node = {"op": "u", "before": dict(before), "after": dict(after)}
        else:
            node = {"op": "d", "before": dict(after), "after": None}
        out.append(json.dumps(node))
    return out


def format_canal(events: Iterable[tuple[str, Mapping]]) -> list[str]:
    """Changelog events -> canal JSON (type INSERT/UPDATE/DELETE with data[]
    and old[]). old[] carries the FULL pre-image so parse_canal's
    {**row, **old} reconstruction returns it bit-identically."""
    out = []
    for unit, after, before in _pair_events(events):
        if unit == "+I":
            node = {"type": "INSERT", "data": [dict(after)], "old": None}
        elif unit == "U":
            node = {"type": "UPDATE", "data": [dict(after)], "old": [dict(before)]}
        else:
            node = {"type": "DELETE", "data": [dict(after)], "old": None}
        out.append(json.dumps(node))
    return out


def format_maxwell(events: Iterable[tuple[str, Mapping]]) -> list[str]:
    """Changelog events -> maxwell JSON (type insert/update/delete with
    data/old; old carries the full pre-image for bit-identical roundtrip)."""
    out = []
    for unit, after, before in _pair_events(events):
        if unit == "+I":
            node = {"type": "insert", "data": dict(after)}
        elif unit == "U":
            node = {"type": "update", "data": dict(after), "old": dict(before)}
        else:
            node = {"type": "delete", "data": dict(after)}
        out.append(json.dumps(node))
    return out


def format_json(events: Iterable[tuple[str, Mapping]]) -> list[str]:
    """Insert-only plain JSON: one row per message. Retractions cannot be
    expressed in this format — encoding them is an error, not silent loss."""
    out = []
    for kind, row in events:
        if kind != "+I":
            raise ValueError(f"plain json cannot encode {kind!r} rows")
        out.append(json.dumps(dict(row)))
    return out


def encode_changelog(data, kinds, fmt: str) -> list[str]:
    """ColumnBatch + RowKind vector -> wire messages in `fmt`. Values
    materialize per row via to_pylist (code-backed/dictionary columns expand
    lazily here and nowhere earlier — the decoded batch itself stays in the
    code domain for every other consumer)."""
    from ..types import RowKind

    names = data.schema.field_names
    events = [
        (RowKind(int(k)).short_string, dict(zip(names, row)))
        for row, k in zip(data.to_pylist(), kinds.tolist())
    ]
    return get_cdc_formatter(fmt)(events)


_FORMATTERS: dict[str, Callable[[Iterable[tuple[str, Mapping]]], list[str]]] = {
    "debezium-json": format_debezium,
    "debezium": format_debezium,
    "canal-json": format_canal,
    "canal": format_canal,
    "maxwell-json": format_maxwell,
    "maxwell": format_maxwell,
    "json": format_json,
}


def get_cdc_formatter(fmt: str) -> Callable[[Iterable[tuple[str, Mapping]]], list[str]]:
    if fmt not in _FORMATTERS:
        raise ValueError(f"unknown cdc format {fmt!r}; known: {sorted(_FORMATTERS)}")
    return _FORMATTERS[fmt]


_PARSERS: dict[str, Callable[[Any], list[CdcRecord]]] = {
    "debezium-json": parse_debezium,
    "debezium": parse_debezium,
    "canal-json": parse_canal,
    "canal": parse_canal,
    "maxwell-json": parse_maxwell,
    "maxwell": parse_maxwell,
    "json": parse_json,
}


def get_cdc_parser(fmt: str) -> Callable[[Any], list[CdcRecord]]:
    if fmt not in _PARSERS:
        raise ValueError(f"unknown cdc format {fmt!r}; known: {sorted(_PARSERS)}")
    return _PARSERS[fmt]


class CdcStream:
    """The source->sink pipeline: parse raw messages with a format parser and
    feed the schema-evolving sink, committing per batch (the engine-neutral
    SyncTableAction analog — reference SynchronizationActionBase)."""

    def __init__(self, table, fmt: str = "debezium-json"):
        self.parser = get_cdc_parser(fmt)
        self.write = CdcTableWrite(table)
        # resume after the table's last streaming commit by THIS user: a
        # reused identifier would be filtered as a replay, and a sentinel
        # one would push the next identifiers onto the batch sentinel
        self._commit_id = 0
        sm = table.store.snapshot_manager
        for snap in sm.snapshots_of_user(table.store.commit_user):
            if snap.commit_identifier < SENTINEL_IDENTIFIERS_FROM:
                self._commit_id = snap.commit_identifier
                break

    def ingest(self, messages: Iterable[str | bytes | Mapping]) -> int:
        """Parse + buffer one batch of raw messages, then flush as one
        commit. Returns the number of records applied (0 when the batch was
        a replay the commit filter dropped). Parsing completes for the WHOLE
        batch before anything is buffered, so a malformed message cannot
        leave half a batch behind to ride along with a later commit."""
        records = [record for m in messages for record in self.parser(m)]
        for record in records:
            self.write.write(record)
        self._commit_id += 1
        return self.write.flush(self._commit_id)

    @property
    def table(self):
        return self.write.table
