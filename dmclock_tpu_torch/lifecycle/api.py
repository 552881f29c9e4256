"""Admin control API: the lifecycle plane over HTTP.

Counterpart of ``dmclock_tpu/lifecycle/api.py``.  A small JSON API
mounted on the scrape endpoint (``obs.registry.MetricsHTTPServer.
mount``), so one port serves Prometheus scrape, health and client
control:

- ``POST /clients``            register ``{"id", "reservation",
  "weight", "limit", "apply_at"?}``
- ``PUT /clients/{id}/qos``    live ClientInfo update (same body,
  minus ``id``)
- ``DELETE /clients/{id}``     evict (waits for the client's queue to
  drain; the slot is recycled at the boundary that finds it drained)
- ``GET /clients``             population summary + lifecycle counters
- ``GET /clients/{id}``        one client's QoS / slot / ledger row
- ``GET /clients/{id}/conformance``  its windowed conformance view
  (with an SLO plane)

Acceptance is journaled, not immediate: a 202 means the op is in the
pending journal (fsynced to the WAL when the plane has a workdir) and
applies at its epoch boundary -- ``apply_at`` pins a boundary,
``null``/absent means the next one.  Invalid QoS triples are rejected
at accept time with 400 carrying the same client-naming ValueError
message init-time construction raises (``core.qos.
validate_client_info``).  Handlers run on the server's threads and
touch no tensor.
"""

from __future__ import annotations

import json
import re
from typing import Optional, Tuple

import numpy as np

from .plane import LifecyclePlane

_ID_RE = re.compile(r"^/clients/(\d+)(/qos|/conformance)?$")
_JSON = "application/json"


def _resp(status: int, obj) -> Tuple[int, str, bytes]:
    return status, _JSON, json.dumps(obj).encode()


class AdminAPI:
    """``handler(method, path, body)`` for ``MetricsHTTPServer.mount``
    over one :class:`~.plane.LifecyclePlane`."""

    def __init__(self, plane: LifecyclePlane, *, ledger_rows=None,
                 slo=None):
        self.plane = plane
        # optional callable () -> {cid: int64[5] LED_* row} supplying
        # live conformance rows for GET /clients/{id}
        self.ledger_rows = ledger_rows
        # optional obs.slo.SloPlane: serves the windowed per-contract-
        # epoch conformance view (GET /clients/{id}/conformance)
        self.slo = slo

    # -- mountable entry point ----------------------------------------
    def handler(self, method: str, path: str,
                body: bytes) -> Tuple[int, str, bytes]:
        try:
            return self._route(method, path, body)
        except ValueError as e:
            # validation failures are client errors, with the same
            # client-naming message init-time construction raises
            return _resp(400, {"error": str(e)})

    def _route(self, method, path, body):
        if path.rstrip("/") == "/clients":
            if method == "GET":
                return _resp(200, self.plane.snapshot())
            if method == "POST":
                return self._register(_body_json(body))
            return _resp(405, {"error": f"{method} not allowed"})
        m = _ID_RE.match(path)
        if not m:
            return _resp(404, {"error": f"no route {path!r}"})
        cid = int(m.group(1))
        if m.group(2) == "/conformance":
            if method != "GET":
                return _resp(405, {"error": f"{method} not allowed"})
            return self._conformance(cid)
        if m.group(2):                       # /clients/{id}/qos
            if method != "PUT":
                return _resp(405, {"error": f"{method} not allowed"})
            return self._update(cid, _body_json(body))
        if method == "GET":
            return self._get(cid)
        if method == "DELETE":
            return self._evict(cid)
        return _resp(405, {"error": f"{method} not allowed"})

    # -- verbs ---------------------------------------------------------
    def _register(self, obj: dict):
        cid = int(obj["id"])
        with self.plane.lock:
            if cid in self.plane.slots.slot_of or any(
                    p["cid"] == cid and p["op"] == "register"
                    for p in self.plane.pending_view()):
                return _resp(409, {"error": f"client {cid} already "
                                            "registered"})
            seq = self.plane.accept(
                {"op": "register", "cid": cid,
                 "r": obj.get("reservation", 0.0),
                 "w": obj.get("weight", 1.0),
                 "l": obj.get("limit", 0.0),
                 "apply_at": obj.get("apply_at")})
        return _resp(202, {"accepted": True, "seq": seq,
                           "apply_at": obj.get("apply_at")})

    def _update(self, cid: int, obj: dict):
        with self.plane.lock:
            if cid not in self.plane.slots.slot_of and not any(
                    p["cid"] == cid and p["op"] == "register"
                    for p in self.plane.pending_view()):
                return _resp(404, {"error": f"no client {cid}"})
            seq = self.plane.accept(
                {"op": "update", "cid": cid,
                 "r": obj.get("reservation", 0.0),
                 "w": obj.get("weight", 1.0),
                 "l": obj.get("limit", 0.0),
                 "apply_at": obj.get("apply_at")})
        return _resp(202, {"accepted": True, "seq": seq,
                           "apply_at": obj.get("apply_at")})

    def _evict(self, cid: int):
        with self.plane.lock:
            if cid not in self.plane.slots.slot_of:
                return _resp(404, {"error": f"no client {cid}"})
            seq = self.plane.accept({"op": "evict", "cid": cid,
                                     "apply_at": None})
        return _resp(202, {"accepted": True, "seq": seq})

    def _conformance(self, cid: int):
        """The windowed conformance view (obs.slo): the client's
        closed-window ring judged per window against its OWN contract
        version, plus the live contract epoch.  404s without an
        attached SLO plane (the run was started with it off)."""
        if self.slo is None:
            return _resp(404, {"error": "SLO plane not enabled "
                                        "(run with with_slo/--slo)"})
        with self.plane.lock:
            known = cid in self.plane.slots.slot_of or \
                cid in self.plane.qos
        view = self.slo.client_view(cid)
        if not known and not view["windows"] \
                and view["contract_epoch"] == 0:
            return _resp(404, {"error": f"no client {cid}"})
        return _resp(200, view)

    def _get(self, cid: int):
        with self.plane.lock:
            slot = self.plane.slots.slot_of.get(cid)
            qos = self.plane.qos.get(cid)
            pending = [p["op"] for p in self.plane.pending_view()
                       if p["cid"] == cid]
        if slot is None and qos is None and not pending:
            return _resp(404, {"error": f"no client {cid}"})
        out = {"id": cid, "slot": slot,
               "registered": slot is not None,
               "pending": pending}
        if qos is not None:
            out["qos"] = {"reservation": qos[0], "weight": qos[1],
                          "limit": qos[2]}
        if self.ledger_rows is not None and slot is not None:
            rows = self.ledger_rows()
            row = rows.get(cid) if rows else None
            if row is not None:
                out["ledger"] = np.asarray(row).tolist()
        return _resp(200, out)


def _body_json(body: bytes) -> dict:
    if not body:
        return {}
    try:
        obj = json.loads(body.decode())
    except Exception:
        raise ValueError("request body is not valid JSON")
    if not isinstance(obj, dict):
        raise ValueError("request body must be a JSON object")
    return obj


def mount_admin_api(server, plane: LifecyclePlane, *,
                    ledger_rows=None, slo=None) -> Optional[AdminAPI]:
    """Mount the control API on a (possibly None, fail-soft)
    ``MetricsHTTPServer`` and publish the lifecycle counters into its
    registry.  ``slo`` (an ``obs.slo.SloPlane``) additionally serves
    ``GET /clients/{id}/conformance``.  Returns the API object, or
    None when there is no server."""
    if server is None:
        return None
    api = AdminAPI(plane, ledger_rows=ledger_rows, slo=slo)
    server.mount("/clients", api.handler)
    plane.publish(server.registry)
    return api
