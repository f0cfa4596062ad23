"""Versioned eta-model registry: content-addressed storage for cost models.

Every :class:`~repro_torch.calibration.fit.EtaModel` has a content hash
(``version_string()``, ``eta-<sha256 prefix>``) computed over its serialized
trees — identical models share a version no matter how they were trained, and
any refit that changes a single split gets a new one. The registry maps that
version to the model's JSON plus metadata (accuracy report, refit lineage),
so a :class:`~repro_torch.core.api.SearchReport` stamped with ``eta_model_version``
can always be traced back to the exact trees that ranked it.

Backends mirror :mod:`repro_torch.serve.store`:

* :class:`MemoryModelRegistry` — in-process dict, insertion-ordered so
  ``latest()`` is the most recent registration.
* :class:`SqliteModelRegistry` — durable single-file registry (WAL,
  ``PRAGMA user_version`` schema with disposable reset on mismatch,
  checksummed rows deleted on corruption, monotonic ``created_seq`` so
  ``latest()`` survives restarts).

Unlike the report cache, registered models are never evicted or expired:
a stamped report must stay resolvable for as long as the registry file
lives, and models are small (a few hundred KB of trees).
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from collections import OrderedDict
from typing import Optional

from repro_torch.calibration.fit import EtaModel
from repro_torch.core.wire import text_checksum

REGISTRY_SCHEMA_VERSION = 1


class RegistryError(RuntimeError):
    """A model registry failed an operation (I/O, schema, integrity)."""


class EtaModelRegistry:
    """Interface + shared counters for content-addressed eta-model storage."""

    kind = "abstract"

    def __init__(self):
        self.corruptions = 0  # integrity drops (checksum / undecodable row)

    def register(self, model: EtaModel, *, meta: Optional[dict] = None) -> str:
        """Store ``model`` under its content hash; idempotent (re-registering
        an identical model keeps the original row and returns its version)."""
        raise NotImplementedError

    def get(self, version: str) -> Optional[EtaModel]:
        raise NotImplementedError

    def meta(self, version: str) -> Optional[dict]:
        raise NotImplementedError

    def latest(self) -> Optional[str]:
        """Version of the most recently registered model, or None."""
        raise NotImplementedError

    def versions(self) -> list[str]:
        """All versions in registration order (oldest first)."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def counters(self) -> dict:
        return {"corruptions": self.corruptions}


class MemoryModelRegistry(EtaModelRegistry):
    kind = "memory"

    def __init__(self):
        super().__init__()
        self._items: "OrderedDict[str, tuple[str, dict]]" = OrderedDict()
        self._lock = threading.Lock()

    def register(self, model: EtaModel, *, meta: Optional[dict] = None) -> str:
        version = model.version_string()
        text = json.dumps(model.to_dict(), sort_keys=True)
        with self._lock:
            if version not in self._items:
                self._items[version] = (text, dict(meta or {}))
        return version

    def get(self, version: str) -> Optional[EtaModel]:
        with self._lock:
            item = self._items.get(version)
        if item is None:
            return None
        try:
            return EtaModel.from_dict(json.loads(item[0]))
        except (ValueError, KeyError, TypeError):
            # structurally invalid node table (out-of-range child, cycle,
            # leaf with children): drop + count like any other corrupt row
            with self._lock:
                self._items.pop(version, None)
            self.corruptions += 1
            return None

    def meta(self, version: str) -> Optional[dict]:
        with self._lock:
            item = self._items.get(version)
        return dict(item[1]) if item is not None else None

    def latest(self) -> Optional[str]:
        with self._lock:
            return next(reversed(self._items)) if self._items else None

    def versions(self) -> list[str]:
        with self._lock:
            return list(self._items)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class SqliteModelRegistry(EtaModelRegistry):
    """Durable registry on a single sqlite file (same discipline as
    :class:`repro_torch.serve.store.SqliteStore`: WAL, versioned schema with
    disposable reset, checksummed rows, DDL-race retry on open)."""

    kind = "sqlite"

    def __init__(self, path: str, *, busy_timeout_s: float = 5.0):
        super().__init__()
        self.path = path
        self._lock = threading.Lock()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        try:
            self._conn = sqlite3.connect(
                path, timeout=busy_timeout_s, check_same_thread=False
            )
        except sqlite3.Error as e:
            raise RegistryError(f"cannot open model registry at {path}: {e}") from e
        last: Optional[Exception] = None
        for attempt in range(10):
            try:
                self._conn.execute("PRAGMA journal_mode=WAL")
                self._conn.execute("PRAGMA synchronous=NORMAL")
                self._init_schema()
                last = None
                break
            except sqlite3.Error as e:
                last = e
                retriable = (
                    isinstance(e, sqlite3.OperationalError)
                    and "locked" in str(e).lower()
                )
                if not retriable:
                    break
                time.sleep(0.02 * (attempt + 1))
        if last is not None and not self._schema_ready():
            self._conn.close()
            raise RegistryError(
                f"cannot open model registry at {path}: {last}"
            ) from last

    def _schema_ready(self) -> bool:
        try:
            (version,) = self._conn.execute("PRAGMA user_version").fetchone()
            have = self._conn.execute(
                "SELECT name FROM sqlite_master"
                " WHERE type='table' AND name='eta_models'"
            ).fetchone()
            return bool(have) and version == REGISTRY_SCHEMA_VERSION
        except sqlite3.Error:
            return False

    def _init_schema(self) -> None:
        self._conn.execute("BEGIN IMMEDIATE")
        try:
            (version,) = self._conn.execute("PRAGMA user_version").fetchone()
            have_table = self._conn.execute(
                "SELECT name FROM sqlite_master"
                " WHERE type='table' AND name='eta_models'"
            ).fetchone()
            if have_table and version != REGISTRY_SCHEMA_VERSION:
                # a registry reset orphans stamped reports' version pointers,
                # but an unreadable schema would orphan them anyway — reset
                # like the report cache does rather than guess at a migration
                self._conn.execute("DROP TABLE IF EXISTS eta_models")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS eta_models ("
                " version TEXT PRIMARY KEY,"
                " model TEXT NOT NULL,"
                " meta TEXT NOT NULL,"
                " checksum TEXT NOT NULL,"
                " created_seq INTEGER NOT NULL)"
            )
            self._conn.execute(
                f"PRAGMA user_version = {REGISTRY_SCHEMA_VERSION:d}"
            )
            self._conn.execute("COMMIT")
        except BaseException:
            try:
                self._conn.execute("ROLLBACK")
            except sqlite3.Error:
                pass
            raise

    def register(self, model: EtaModel, *, meta: Optional[dict] = None) -> str:
        version = model.version_string()
        text = json.dumps(model.to_dict(), sort_keys=True)
        meta_text = json.dumps(dict(meta or {}), sort_keys=True)
        with self._lock:
            with self._conn:
                (next_seq,) = self._conn.execute(
                    "SELECT COALESCE(MAX(created_seq), 0) + 1 FROM eta_models"
                ).fetchone()
                # idempotent: an identical model keeps its original row/seq
                self._conn.execute(
                    "INSERT INTO eta_models"
                    " (version, model, meta, checksum, created_seq)"
                    " VALUES (?, ?, ?, ?, ?)"
                    " ON CONFLICT(version) DO NOTHING",
                    (version, text, meta_text, text_checksum(text), next_seq),
                )
        return version

    def _row(self, version: str) -> Optional[tuple[str, str]]:
        with self._lock:
            row = self._conn.execute(
                "SELECT model, meta, checksum FROM eta_models"
                " WHERE version = ?", (version,)
            ).fetchone()
            if row is None:
                return None
            text, meta_text, checksum = row
            if text_checksum(text) != checksum:
                with self._conn:
                    self._conn.execute(
                        "DELETE FROM eta_models WHERE version = ?", (version,)
                    )
                self.corruptions += 1
                return None
            return text, meta_text

    def get(self, version: str) -> Optional[EtaModel]:
        row = self._row(version)
        if row is None:
            return None
        try:
            return EtaModel.from_dict(json.loads(row[0]))
        except (ValueError, KeyError, TypeError):
            # checksum-valid bytes can still encode a structurally invalid
            # node table (e.g. written by a buggy producer): delete + count
            # rather than hand predict a cyclic tree
            with self._lock:
                with self._conn:
                    self._conn.execute(
                        "DELETE FROM eta_models WHERE version = ?", (version,)
                    )
            self.corruptions += 1
            return None

    def meta(self, version: str) -> Optional[dict]:
        row = self._row(version)
        return json.loads(row[1]) if row is not None else None

    def latest(self) -> Optional[str]:
        with self._lock:
            row = self._conn.execute(
                "SELECT version FROM eta_models"
                " ORDER BY created_seq DESC LIMIT 1"
            ).fetchone()
        return row[0] if row is not None else None

    def versions(self) -> list[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT version FROM eta_models ORDER BY created_seq ASC"
            ).fetchall()
        return [r[0] for r in rows]

    def __len__(self) -> int:
        with self._lock:
            (count,) = self._conn.execute(
                "SELECT COUNT(*) FROM eta_models"
            ).fetchone()
            return count

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def parse_registry_url(url: str) -> EtaModelRegistry:
    """``memory`` — in-process; ``sqlite:PATH`` — durable file at PATH."""
    if url == "memory":
        return MemoryModelRegistry()
    scheme, sep, path = url.partition(":")
    if sep and path and scheme == "sqlite":
        return SqliteModelRegistry(path)
    raise ValueError(
        f"bad registry url {url!r}; expected 'memory' or 'sqlite:PATH'"
    )
