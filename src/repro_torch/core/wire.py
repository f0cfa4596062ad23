"""Wire-format helpers shared by the serializable search types.

Astra's result-side objects (:class:`~repro_torch.core.api.SearchReport` and
everything it nests) round-trip through JSON so a search can leave the
process: shipped from a search service to a serving fleet, cached keyed on
:meth:`~repro_torch.core.spec.SearchSpec.cache_key`, or replayed in tests.

Floats that feed the Eq. 30-33 rankings (throughputs, money costs, step
times) are encoded with ``float.hex`` so deserialization is bit-exact —
``repr``/decimal round-trips can perturb the last ulp, which is enough to
flip a ranking tie and make the served report disagree with the in-process
one. Decoders accept plain JSON numbers too, so hand-written payloads work.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Union

WIRE_VERSION = 1

JsonFloat = Union[str, int, float]


def dump_float(x: float) -> str:
    """Bit-exact JSON encoding of a float (``float.hex``; handles inf)."""
    return float(x).hex()


def load_float(v: JsonFloat) -> float:
    """Decode :func:`dump_float` output; plain JSON numbers pass through."""
    if isinstance(v, str):
        return float.fromhex(v)
    return float(v)


def dump_floats(xs: Iterable[float]) -> list[str]:
    return [dump_float(x) for x in xs]


def load_floats(vs: Iterable[JsonFloat]) -> list[float]:
    return [load_float(v) for v in vs]


def text_checksum(text: str) -> str:
    """Content checksum for wire text at rest (sha-256 hex).

    Durable report stores (:mod:`repro_torch.serve.store`) record this next to
    the serialized report so a corrupted row is detected on read and
    treated as a miss instead of being served."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def check_envelope(d: dict, kind: str) -> None:
    """Validate the versioned envelope of a wire dict."""
    version = d.get("version", WIRE_VERSION)
    if version != WIRE_VERSION:
        raise ValueError(f"unsupported {kind} wire version {version!r}")
    got = d.get("kind", kind)
    if got != kind:
        raise ValueError(f"expected wire kind {kind!r}, got {got!r}")
