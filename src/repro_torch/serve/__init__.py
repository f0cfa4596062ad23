"""Serving layer: batched generation + the spec-keyed search service."""
from repro_torch.serve.engine import GenerateResult, ServeEngine

__all__ = ["ServeEngine", "GenerateResult", "SearchService", "ServiceStats",
           "AuthQuota", "TokenInfo", "make_server", "metrics_text",
           "ReportStore", "MemoryStore", "SqliteStore", "TieredStore",
           "parse_store_url"]

_SERVICE_EXPORTS = ("SearchService", "ServiceStats", "AuthQuota", "TokenInfo",
                    "make_server", "metrics_text")
_STORE_EXPORTS = ("ReportStore", "MemoryStore", "SqliteStore", "TieredStore",
                  "parse_store_url")


def __getattr__(name):
    # lazy so `python -m repro_torch.serve.search_service` doesn't double-import
    # the module it is executing
    if name in _SERVICE_EXPORTS:
        from repro_torch.serve import search_service

        return getattr(search_service, name)
    if name in _STORE_EXPORTS:
        from repro_torch.serve import store

        return getattr(store, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
