"""Hardened stdlib HTTP/JSON client shared by every remote caller.

Every path that talks to a search service over the network — the service
CLI (``search`` / ``stats``), ``examples/serve_batched.py --search-url``,
and the :class:`~repro_torch.core.backend.FleetBackend` shard client — goes
through :func:`http_json`, which fixes the two failure modes the bare
``urllib.request.urlopen`` call had:

* **a dead or unreachable server hangs the caller forever** — every
  request now carries a connect/read ``timeout`` (one budget covers both:
  stdlib urllib exposes a single socket timeout);
* **one transient transport fault kills the call** — connection refused,
  reset, or timed-out requests are retried with bounded exponential
  backoff (``retries`` more attempts after the first).

Only *transport* faults retry. A server that answers — any HTTP status,
including 4xx/5xx — is a live server; the status and parsed payload are
returned to the caller, never retried (retrying a 429 would fight the
quota, retrying a 500 would re-run a failed search). Retrying a POST is
safe against our endpoints by construction: ``/v1/search`` single-flights
identical specs and ``/v1/shard`` is a pure function of its body.

A request that exhausts its attempts raises :class:`TransportError`
carrying the url, the attempt count, and the last underlying error.
"""
from __future__ import annotations

import http.client
import json
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

#: default connect/read budget per attempt. Callers with known-long
#: requests (a cold search POST) pass their own; see DEFAULT_SEARCH_TIMEOUT.
DEFAULT_TIMEOUT = 10.0
#: a synchronous /v1/search blocks for the whole cold search, so its read
#: budget must cover a big sweep — callers that can't wait should use the
#: async endpoint and poll with the short default instead
DEFAULT_SEARCH_TIMEOUT = 600.0
DEFAULT_RETRIES = 2


class TransportError(OSError):
    """The server never produced an HTTP response within the retry budget."""


def http_json(
    url: str,
    data: Optional[bytes] = None,
    *,
    token: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT,
    retries: int = DEFAULT_RETRIES,
    backoff: float = 0.25,
    sleep: Callable[[float], None] = time.sleep,
) -> tuple[int, dict]:
    """One JSON request (POST when ``data`` else GET) -> ``(status, payload)``.

    ``retries`` is the number of *additional* attempts after the first;
    attempt ``k`` waits ``backoff * 2**(k-1)`` seconds first (``sleep`` is
    injectable so tests stay sleep-free). HTTP error statuses come back as
    ``(status, payload)`` without retrying; transport faults retry and
    finally raise :class:`TransportError`. A 2xx body that is not JSON
    raises ``TransportError`` immediately (a protocol violation, not a
    transient fault — retrying would not help).
    """
    headers = {"Content-Type": "application/json"} if data else {}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    last: Optional[BaseException] = None
    for attempt in range(max(retries, 0) + 1):
        if attempt and backoff > 0:
            sleep(backoff * (2 ** (attempt - 1)))
        req = urllib.request.Request(url, data=data, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                status, body = resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:  # a live server answered
            try:
                return e.code, json.loads(e.read().decode() or "{}")
            except ValueError:
                return e.code, {}
        except (urllib.error.URLError, http.client.HTTPException,
                TimeoutError, OSError) as e:
            last = e  # transport fault (refused / reset / timed out): retry
            continue
        try:
            return status, json.loads(body) if body else {}
        except ValueError as e:
            raise TransportError(
                f"non-JSON response from {url}: {e}"
            ) from e
    raise TransportError(
        f"{url}: no response after {max(retries, 0) + 1} attempt(s); "
        f"last error: {type(last).__name__}: {last}"
    ) from last
