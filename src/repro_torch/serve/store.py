"""Pluggable report stores for the spec-keyed search service.

The paper's economics — a search costs ~1.27 s to ~1.35 min once, and its
result is reused fleet-wide — only hold if a cached
:class:`~repro_torch.core.api.SearchReport` outlives the process that ran the
search. A :class:`ReportStore` is the persistence seam behind
:class:`~repro_torch.serve.search_service.SearchService`: it maps
``SearchSpec.cache_key()`` to report JSON text with TTL expiry and
size-bounded eviction. Three implementations:

* :class:`MemoryStore` — the original in-process LRU+TTL ``OrderedDict``
  (behavior-preserving: one service over a ``MemoryStore`` is exactly the
  pre-store ``SearchService``).
* :class:`SqliteStore` — durable single-file store (WAL mode, so replicas
  on one host read concurrently while one writes), schema-versioned with a
  disposable-cache reset on mismatch, checksum-verified rows (a corrupt
  row reads as a miss and is deleted, never served), lazy TTL sweep and
  least-recently-accessed eviction.
* :class:`TieredStore` — memory front / durable back, write-through on
  put, read-through with promotion on a front miss. The service keeps its
  single-flight dedup above the store, so one search fills both tiers.

``parse_store_url`` lowers the CLI syntax (``memory``, ``sqlite:PATH``,
``tiered:PATH``) onto these classes.

Every store takes an injectable ``clock`` so TTL and eviction are testable
without sleeping; expiry timestamps are *stored* in the clock's timebase,
which means a durable store's TTL horizon is only meaningful across
restarts when the clock is wall time (the default) — tests that restart
against one sqlite file share one fake clock for the same reason.
"""
from __future__ import annotations

import os
import sqlite3
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from repro_torch.core.wire import text_checksum

SQLITE_SCHEMA_VERSION = 1


class StoreError(RuntimeError):
    """A report store failed an operation (I/O, schema, integrity)."""


class ReportStore:
    """Interface + shared counters for spec-keyed report-JSON stores.

    ``get``/``put``/``delete`` are the contract; ``evictions``,
    ``expirations`` and ``corruptions`` are monotonic counters the service
    surfaces under ``/v1/stats``. Implementations must be safe to call
    from multiple threads.
    """

    kind = "abstract"

    def __init__(self):
        self.evictions = 0  # capacity drops
        self.expirations = 0  # TTL drops
        self.corruptions = 0  # integrity drops (checksum / undecodable row)

    def get(self, key: str) -> Optional[str]:
        """Report JSON for ``key``, or None on miss/expiry/corruption."""
        raise NotImplementedError

    def put(self, key: str, text: str) -> None:
        raise NotImplementedError

    # entry-level variants carry the absolute expiry so a tiering layer can
    # move an entry between stores without restamping its TTL horizon
    def get_entry(self, key: str) -> tuple[Optional[str], Optional[float]]:
        return self.get(key), None

    def put_entry(self, key: str, text: str,
                  expires_at: Optional[float]) -> None:
        self.put(key, text)

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def close(self) -> None:  # durable stores release their handles
        pass

    def counters(self) -> dict:
        return {
            "evictions": self.evictions,
            "expirations": self.expirations,
            "corruptions": self.corruptions,
        }


class MemoryStore(ReportStore):
    """The original LRU+TTL cache: ``OrderedDict`` in insertion/use order."""

    kind = "memory"

    def __init__(
        self,
        *,
        max_entries: int = 128,
        ttl_seconds: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        super().__init__()
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.ttl_seconds = ttl_seconds
        self.clock = clock
        self._items: "OrderedDict[str, tuple[Optional[float], str]]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: str) -> Optional[str]:
        return self.get_entry(key)[0]

    def get_entry(self, key: str) -> tuple[Optional[str], Optional[float]]:
        with self._lock:
            item = self._items.get(key)
            if item is None:
                return None, None
            expires, text = item
            if expires is not None and self.clock() >= expires:
                del self._items[key]
                self.expirations += 1
                return None, None
            self._items.move_to_end(key)
            return text, expires

    def put(self, key: str, text: str) -> None:
        expires = (
            self.clock() + self.ttl_seconds
            if self.ttl_seconds is not None else None
        )
        self.put_entry(key, text, expires)

    def put_entry(self, key: str, text: str,
                  expires_at: Optional[float]) -> None:
        with self._lock:
            self._items[key] = (expires_at, text)
            self._items.move_to_end(key)
            while len(self._items) > self.max_entries:
                self._items.popitem(last=False)
                self.evictions += 1

    def delete(self, key: str) -> None:
        with self._lock:
            self._items.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class SqliteStore(ReportStore):
    """Durable spec-keyed report store on a single sqlite file.

    * WAL journal mode: concurrent readers (other service replicas on the
      same host) don't block the writer.
    * ``PRAGMA user_version`` carries the schema version; a mismatched
      file is reset (cached reports are disposable derived data — a reset
      costs re-searches, never correctness).
    * Every row stores a sha-256 checksum of the report text; a mismatch
      on read (bit rot, torn write, hostile edit) counts a corruption,
      deletes the row, and reads as a miss.
    * TTL is enforced lazily on ``get`` plus a sweep on ``put``;
      ``max_entries`` evicts least-recently-accessed rows.

    One ``SqliteStore`` instance serializes its own statements under a
    lock; *separate* instances (replicas) coordinate through sqlite's own
    locking, with a busy timeout so short write contention spins instead
    of failing.
    """

    kind = "sqlite"

    def __init__(
        self,
        path: str,
        *,
        max_entries: int = 4096,
        ttl_seconds: Optional[float] = None,
        clock: Callable[[], float] = time.time,
        busy_timeout_s: float = 5.0,
    ):
        super().__init__()
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.path = path
        self.max_entries = max_entries
        self.ttl_seconds = ttl_seconds
        self.clock = clock
        self._lock = threading.Lock()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        try:
            self._conn = sqlite3.connect(
                path, timeout=busy_timeout_s, check_same_thread=False
            )
        except sqlite3.Error as e:
            raise StoreError(f"cannot open sqlite store at {path}: {e}") from e
        # the WAL switch and first-time DDL contend when several replicas
        # open a fresh file at once, and sqlite reports that as an
        # immediate SQLITE_BUSY (bypassing the busy timeout) — retry with
        # backoff instead of failing the boot
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
        # a losing replica may have been beaten to the DDL by the winner —
        # that's success as long as the schema is in place now
        if last is not None and not self._schema_ready():
            self._conn.close()
            raise StoreError(
                f"cannot open sqlite store at {path}: {last}"
            ) from last

    def _schema_ready(self) -> bool:
        try:
            (version,) = self._conn.execute("PRAGMA user_version").fetchone()
            have = self._conn.execute(
                "SELECT name FROM sqlite_master"
                " WHERE type='table' AND name='reports'"
            ).fetchone()
            return bool(have) and version == SQLITE_SCHEMA_VERSION
        except sqlite3.Error:
            return False

    def _init_schema(self) -> None:
        # BEGIN IMMEDIATE takes the write lock up front so two replicas
        # opening a fresh (or stale) file concurrently serialize here
        # instead of racing the DDL; IF-EXISTS guards make the loser's
        # pass a no-op either way
        self._conn.execute("BEGIN IMMEDIATE")
        try:
            (version,) = self._conn.execute("PRAGMA user_version").fetchone()
            have_table = self._conn.execute(
                "SELECT name FROM sqlite_master"
                " WHERE type='table' AND name='reports'"
            ).fetchone()
            if have_table and version != SQLITE_SCHEMA_VERSION:
                # stale schema: the cache is derived data, so reset rather
                # than guess at a migration
                self._conn.execute("DROP TABLE IF EXISTS reports")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS reports ("
                " key TEXT PRIMARY KEY,"
                " report TEXT NOT NULL,"
                " checksum TEXT NOT NULL,"
                " expires_at REAL,"
                " last_access REAL NOT NULL)"
            )
            self._conn.execute(
                f"PRAGMA user_version = {SQLITE_SCHEMA_VERSION:d}"
            )
            self._conn.execute("COMMIT")
        except BaseException:
            try:
                self._conn.execute("ROLLBACK")
            except sqlite3.Error:
                pass  # BEGIN itself failed: nothing to roll back
            raise

    def get(self, key: str) -> Optional[str]:
        return self.get_entry(key)[0]

    def get_entry(self, key: str) -> tuple[Optional[str], Optional[float]]:
        now = self.clock()
        with self._lock:
            row = self._conn.execute(
                "SELECT report, checksum, expires_at FROM reports"
                " WHERE key = ?", (key,)
            ).fetchone()
            if row is None:
                return None, None
            text, checksum, expires_at = row
            if expires_at is not None and now >= expires_at:
                with self._conn:
                    self._conn.execute(
                        "DELETE FROM reports WHERE key = ?", (key,)
                    )
                self.expirations += 1
                return None, None
            if text_checksum(text) != checksum:
                with self._conn:
                    self._conn.execute(
                        "DELETE FROM reports WHERE key = ?", (key,)
                    )
                self.corruptions += 1
                return None, None
            try:
                with self._conn:
                    self._conn.execute(
                        "UPDATE reports SET last_access = ? WHERE key = ?",
                        (now, key),
                    )
            except sqlite3.Error:
                pass  # the touch only feeds LRA eviction — never turn a
                # verified read into a miss because the touch lost a lock
            return text, expires_at

    def put(self, key: str, text: str) -> None:
        now = self.clock()
        expires = now + self.ttl_seconds if self.ttl_seconds is not None else None
        self.put_entry(key, text, expires)

    def put_entry(self, key: str, text: str,
                  expires_at: Optional[float]) -> None:
        now = self.clock()
        with self._lock:
            with self._conn:
                self._conn.execute(
                    "INSERT INTO reports"
                    " (key, report, checksum, expires_at, last_access)"
                    " VALUES (?, ?, ?, ?, ?)"
                    " ON CONFLICT(key) DO UPDATE SET report=excluded.report,"
                    "  checksum=excluded.checksum,"
                    "  expires_at=excluded.expires_at,"
                    "  last_access=excluded.last_access",
                    (key, text, text_checksum(text), expires_at, now),
                )
                self._sweep_locked(now)

    def _sweep_locked(self, now: float) -> None:
        """TTL sweep + LRA eviction; call inside the statement lock and an
        open transaction."""
        cur = self._conn.execute(
            "DELETE FROM reports WHERE expires_at IS NOT NULL"
            " AND expires_at <= ?", (now,)
        )
        self.expirations += cur.rowcount
        (count,) = self._conn.execute(
            "SELECT COUNT(*) FROM reports"
        ).fetchone()
        excess = count - self.max_entries
        if excess > 0:
            cur = self._conn.execute(
                "DELETE FROM reports WHERE key IN ("
                " SELECT key FROM reports ORDER BY last_access ASC LIMIT ?)",
                (excess,),
            )
            self.evictions += cur.rowcount

    def delete(self, key: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM reports WHERE key = ?", (key,))

    def __len__(self) -> int:
        with self._lock:
            (count,) = self._conn.execute(
                "SELECT COUNT(*) FROM reports"
            ).fetchone()
            return count

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class TieredStore(ReportStore):
    """Memory front + durable back: write-through, read-through-promote.

    ``get`` serves the front when it can; a front miss falls back to the
    back tier and promotes the hit into the front (so a restart refills
    hot entries on first touch). ``put`` writes both tiers. Counters
    aggregate both tiers.
    """

    kind = "tiered"

    def __init__(self, front: ReportStore, back: ReportStore):
        super().__init__()
        # promotion moves *absolute* expiries between tiers, so any tier
        # that stamps TTLs must read the same clock — the classes' natural
        # defaults differ (monotonic vs wall), which would make promoted
        # entries immortal or instantly dead
        front_clock = getattr(front, "clock", None)
        back_clock = getattr(back, "clock", None)
        has_ttl = (getattr(front, "ttl_seconds", None) is not None
                   or getattr(back, "ttl_seconds", None) is not None)
        if has_ttl and front_clock is not back_clock:
            raise ValueError(
                "TieredStore tiers with a TTL must share one clock "
                "instance (pass the same clock= to both stores, or build "
                "via parse_store_url which aligns them)"
            )
        self.front = front
        self.back = back

    # the durable tier defines the fleet-wide bounds operators see in stats
    @property
    def max_entries(self):
        return getattr(self.back, "max_entries", None)

    @property
    def ttl_seconds(self):
        return getattr(self.back, "ttl_seconds", None)

    def get(self, key: str) -> Optional[str]:
        text = self.front.get(key)
        if text is not None:
            return text
        # promotion carries the back entry's absolute expiry: a promoted
        # entry must not outlive the fleet-wide TTL horizon of the write.
        # A back entry with no expiry defers to the front's own TTL policy
        # (plain put) so a TTL-bearing front never gains immortal entries.
        text, expires_at = self.back.get_entry(key)
        if text is not None:
            if expires_at is None:
                self.front.put(key, text)
            else:
                self.front.put_entry(key, text, expires_at)
        return text

    def put(self, key: str, text: str) -> None:
        self.back.put(key, text)  # durable tier first: crash-safe ordering
        self.front.put(key, text)

    def delete(self, key: str) -> None:
        self.front.delete(key)
        self.back.delete(key)

    def __len__(self) -> int:
        return len(self.back)

    def close(self) -> None:
        self.front.close()
        self.back.close()

    def counters(self) -> dict:
        keys = ("evictions", "expirations", "corruptions")
        f, b = self.front.counters(), self.back.counters()
        return {k: f[k] + b[k] for k in keys}


def parse_store_url(
    url: str,
    *,
    max_entries: int = 128,
    ttl_seconds: Optional[float] = None,
    clock: Optional[Callable[[], float]] = None,
) -> ReportStore:
    """Lower the CLI store syntax onto a :class:`ReportStore`.

    ``memory``        — in-process LRU+TTL (the default service behavior)
    ``sqlite:PATH``   — durable sqlite file at PATH
    ``tiered:PATH``   — memory front over a sqlite back at PATH

    ``clock=None`` picks each store's natural default (monotonic for
    memory, wall time for sqlite — durable timestamps must survive
    restarts). A tiered store's tiers always share one clock (wall time
    unless injected): promoted entries carry absolute expiries between
    tiers, so the timebases must agree.
    """
    mem_kw = dict(max_entries=max_entries, ttl_seconds=ttl_seconds)
    sql_kw = dict(max_entries=max_entries, ttl_seconds=ttl_seconds)
    if clock is not None:
        mem_kw["clock"] = clock
        sql_kw["clock"] = clock
    if url == "memory":
        return MemoryStore(**mem_kw)
    scheme, sep, path = url.partition(":")
    if sep and path and scheme == "sqlite":
        return SqliteStore(path, **sql_kw)
    if sep and path and scheme == "tiered":
        shared = clock if clock is not None else time.time
        return TieredStore(
            MemoryStore(**dict(mem_kw, clock=shared)),
            SqliteStore(path, **dict(sql_kw, clock=shared)),
        )
    raise ValueError(
        f"bad store url {url!r}; expected 'memory', 'sqlite:PATH',"
        f" or 'tiered:PATH'"
    )
