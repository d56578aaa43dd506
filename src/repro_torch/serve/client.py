"""Thin stdlib HTTP client for the v1 query-service API.

One class, no dependencies beyond ``urllib``: benches, tests and the
``VariabilityPipeline`` facade all talk to a running service through
:class:`QueryClient` instead of hand-rolling request plumbing. Every
non-2xx answer raises :class:`ServiceError` carrying the service's
shared error envelope (``{"error": {"code", "message", "detail"}}``) as
structured fields, so callers branch on ``err.code`` ("budget_exceeded",
"tick_timeout", "no_ingest_plane", ...) rather than parsing strings.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.query import Query

__all__ = ["QueryClient", "ServiceError"]


class ServiceError(RuntimeError):
    """A v1 error envelope, raised: HTTP status + machine-readable code."""

    def __init__(self, status: int, code: str, message: str,
                 detail=None) -> None:
        super().__init__(f"[{status}/{code}] {message}")
        self.status = int(status)
        self.code = str(code)
        self.message = str(message)
        self.detail = detail


class QueryClient:
    """Client for one query service (``http://host:port``).

    Accepts :class:`~repro_torch.core.query.Query` objects or raw spec dicts
    interchangeably — specs go over the wire either way (the service
    mints the cache key from the canonical form, so both spellings hit
    the same cache entries)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8321,
                 timeout_s: float = 60.0) -> None:
        self.base = f"http://{host}:{int(port)}"
        self.timeout_s = float(timeout_s)

    # -- plumbing ----------------------------------------------------------
    def _call(self, method: str, path: str, body=None,
              timeout_s: Optional[float] = None) -> Dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout_s or self.timeout_s) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                env = json.loads(e.read()).get("error", {})
            except (ValueError, OSError):
                env = {}
            raise ServiceError(
                e.code, env.get("code", "http_error"),
                env.get("message", str(e)),
                env.get("detail")) from None

    @staticmethod
    def _specs(queries) -> List[Dict]:
        if isinstance(queries, (Query, dict)):
            queries = [queries]
        return [q.to_spec() if isinstance(q, Query) else dict(q)
                for q in queries]

    # -- the v1 surface ----------------------------------------------------
    def query_raw(self, queries) -> Dict:
        """``POST /v1/query`` -> the full ``{"results", "tick"}`` body."""
        return self._call("POST", "/v1/query", self._specs(queries))

    def query(self, queries: Union[Query, Dict,
                                   Sequence[Union[Query, Dict]]]):
        """Rendered per-query results; a single query (or spec dict)
        returns its one result dict, a sequence returns the list."""
        single = isinstance(queries, (Query, dict))
        results = self.query_raw(queries)["results"]
        return results[0] if single else results

    def healthz(self) -> Dict:
        return self._call("GET", "/v1/healthz")

    def stats(self) -> Dict:
        return self._call("GET", "/v1/stats")

    def attach(self, db_paths: Sequence[str]) -> Dict:
        """``POST /v1/ingest/attach`` — start tailing rank DBs (creates
        the ingest plane on first use)."""
        return self._call("POST", "/v1/ingest/attach",
                          {"db_paths": list(db_paths)})

    def detach(self, db_paths: Sequence[str]) -> Dict:
        return self._call("POST", "/v1/ingest/detach",
                          {"db_paths": list(db_paths)})

    def fences(self, since: int = 0, timeout_s: float = 30.0) -> Dict:
        """One long-poll leg: ``{"events", "next_since"}``. Loop with
        ``since=body["next_since"]`` to consume the stream."""
        return self._call(
            "GET", f"/v1/stream/fences?since={int(since)}"
                   f"&timeout_s={float(timeout_s)}",
            timeout_s=float(timeout_s) + self.timeout_s)

    def wait_healthy(self, timeout_s: float = 10.0) -> bool:
        """Poll ``/v1/healthz`` until it answers (service warm-up)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                if self.healthz().get("ok"):
                    return True
            except (ServiceError, OSError):
                pass
            time.sleep(0.05)
        return False
