"""Consumers: durable reader progress that pins snapshots (port of
paimon_tpu/table/consumer.py).

table/consumer/consumer-<id> holds {"nextSnapshot": n}, the next snapshot
the reader will read; snapshot expiry keeps every snapshot from the
smallest such n to the latest.
"""

from __future__ import annotations

from ..fs import LocalFileIO
from ..utils import dumps, loads, now_millis

__all__ = ["ConsumerManager"]


class ConsumerManager:
    def __init__(self, file_io: LocalFileIO, table_path: str):
        self.file_io = file_io
        self.consumer_dir = f"{table_path}/consumer"

    def _path(self, consumer_id: str) -> str:
        return f"{self.consumer_dir}/consumer-{consumer_id}"

    def consumer(self, consumer_id: str) -> int | None:
        """The consumer's next snapshot, or None when it has no file. Only a
        missing file reads as no consumer: any other IO error propagates,
        since reading it as none would unpin a live reader's snapshots."""
        try:
            raw = self.file_io.read_bytes(self._path(consumer_id))
        except FileNotFoundError:
            return None
        return loads(raw)["nextSnapshot"]

    def record(self, consumer_id: str, next_snapshot: int) -> None:
        self.file_io.try_overwrite(self._path(consumer_id), dumps({"nextSnapshot": next_snapshot}).encode())

    def delete(self, consumer_id: str) -> None:
        self.file_io.delete(self._path(consumer_id))

    def list_consumers(self) -> dict[str, int]:
        out = {}
        for st in self.file_io.list_files(self.consumer_dir):
            base = st.path.rsplit("/", 1)[-1]
            if base.startswith("consumer-"):
                cid = base[len("consumer-") :]
                nxt = self.consumer(cid)
                if nxt is not None:
                    out[cid] = nxt
        return out

    def min_next_snapshot(self) -> int | None:
        vals = list(self.list_consumers().values())
        return min(vals) if vals else None

    def expire_stale(self, expiration_millis: int) -> list[str]:
        """Delete the consumers whose file was not updated within
        consumer.expiration-time (by its mtime), so that an abandoned reader
        stops pinning snapshots; returns their ids."""
        cutoff = now_millis() - expiration_millis
        removed = []
        for st in self.file_io.list_files(self.consumer_dir):
            base = st.path.rsplit("/", 1)[-1]
            if base.startswith("consumer-") and st.mtime_millis < cutoff:
                removed.append(base[len("consumer-") :])
                self.file_io.delete(st.path)
        return removed
