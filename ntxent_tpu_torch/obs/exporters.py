"""Metric format negotiation, counterpart of the negotiation half of
``ntxent_tpu/obs/exporters.py`` (the training-side ``MetricsServer``
waits for ROADMAP.md Queue A 11(b)).

The serving stack's ``/metrics`` answers three views of one registry:
the JSON wire shape (the default), Prometheus text and the raw
``dump_state`` federation view. An explicit ``format=`` query wins, then
the Accept header, then the endpoint's default.
"""

from __future__ import annotations

from urllib.parse import parse_qs, urlparse

__all__ = ["PROMETHEUS_CONTENT_TYPE", "choose_format"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def choose_format(path: str, accept: str | None,
                  default: str = "json") -> str:
    """'json', 'prometheus' or 'state' for a /metrics request.

    Priority: ``?format=prometheus|json|state``, then the Accept header
    (``application/json`` against ``text/plain`` or ``openmetrics``),
    then ``default``. Unknown values fall back to the default (a scrape
    endpoint never answers 400 over a header); ``state`` is reachable
    only by the explicit query.
    """
    query = parse_qs(urlparse(path).query)
    explicit = (query.get("format") or [None])[0]
    if explicit in ("prometheus", "json", "state"):
        return explicit
    accept = (accept or "").lower()
    if "application/json" in accept:
        return "json"
    if "openmetrics" in accept or "text/plain" in accept:
        return "prometheus"
    return default
