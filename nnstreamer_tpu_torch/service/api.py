"""Service control-plane surface: HTTP JSON endpoint + client (L7).

Reference analog: the ML-Service C API's out-of-process control calls
(``ml_service_*``, reached over D-Bus on the reference platform). TPU
redesign: a stdlib ``http.server`` JSON endpoint — no daemon framework,
no dependency — that exposes the :class:`~.manager.ServiceManager` verbs,
plus a matching ``urllib`` client the CLI uses, so ``python -m
nnstreamer_tpu service <verb>`` works against any running ``serve``
process.

Routes (JSON unless noted):

    GET    /healthz                       liveness of the control plane
    GET    /metrics                       Prometheus text exposition of the
                                          unified obs registry (serving,
                                          service, fabric, fused segments;
                                          docs/observability.md)
    GET    /flight                        flight-recorder tail
                                          (?last=N&pipeline=NAME
                                          &category=KIND&after=SEQ —
                                          ``after`` is the tail-follow /
                                          fleet-scrape cursor)
    GET    /profile                       continuous-profiler snapshot +
                                          SLO status (obs profile / top);
                                          ?raw=1 adds the raw digest
                                          export the fleet scraper merges
                                          (obs/fleet.py)
    GET    /spans                         wall-clock-annotated span export
                                          for cross-process trace
                                          stitching (?trace=ID&last=N)
    GET    /fleet                         fleet-view snapshots (merged
                                          replica planes — obs/fleet.py)
    GET    /fleet/flight                  the fleet-MERGED flight stream
                                          (?after=SEQ&last=N&name=FLEET)
    GET    /memory                        device-memory accounting plane
                                          (stage estimates, device
                                          watermarks, queue/serving
                                          bytes — obs/memory.py)
    GET    /quality                       data-plane quality snapshot
                                          (per-edge tensor health,
                                          baseline stages, drift scores
                                          — obs/quality.py); ?raw=1 adds
                                          the serialized health cells the
                                          fleet merge folds additively
    GET    /services                      list (name/state/ready/restarts)
    GET    /services/<name>               full health snapshot
    POST   /services                      register {name, launch, ...}
    POST   /services/<name>/start         {"wait": bool}
    POST   /services/<name>/stop
    POST   /services/<name>/drain         {"timeout_s": float}
    DELETE /services/<name>               unregister (stops first)
    GET    /models                        slot table
    POST   /models/<slot>/swap            {"version": v}
    POST   /models/<slot>/canary          {"version": v, "fraction": f,
                                           "quality_gate": true | {...}}
    POST   /models/<slot>/promote         (409 QualityGateError when the
                                          armed quality gate refuses)
    POST   /models/<slot>/cancel

Errors return ``{"error": "..."}`` with 4xx/5xx.
"""
from __future__ import annotations

import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..utils.log import logger
from .manager import AdmissionRejected, ServiceError, ServiceManager
from .models import SwapError
from .supervisor import RestartPolicy


# -- server ------------------------------------------------------------------

class ControlServer:
    """Threaded HTTP control endpoint bound to a manager."""

    def __init__(self, manager: ServiceManager, host: str = "127.0.0.1",
                 port: int = 0):
        self.manager = manager
        handler = _make_handler(manager)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ControlServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=f"svc-http:{self.port}",
                                        daemon=True)
        self._thread.start()
        logger.info("service control endpoint listening on %s",
                    self.endpoint)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def _make_handler(manager: ServiceManager):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            logger.debug("control-http: " + fmt, *args)

        # -- plumbing --------------------------------------------------------
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length") or 0)
            if n == 0:
                return {}
            return json.loads(self.rfile.read(n).decode() or "{}")

        def _reply_metrics(self) -> None:
            """GET /metrics: Prometheus text, not JSON — scrapers
            (tools/bench_fabric.py, a real Prometheus) read it as-is."""
            try:
                body = obs_metrics.render().encode()
            except Exception as e:  # noqa: BLE001 - endpoint must answer
                logger.exception("control-http: /metrics render failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _query_params(self) -> dict:
            from urllib.parse import parse_qsl

            _, _, q = self.path.partition("?")
            return dict(parse_qsl(q))

        def _dispatch(self, method: str) -> None:
            try:
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                handled = self._route(method, parts)
            except (ServiceError, SwapError, KeyError, ValueError) as e:
                # typed mapping (message text only breaks the 404 tie for
                # lookup-style ServiceErrors): bad input 400, rejected
                # registration 422, missing thing 404, bad state 409
                if isinstance(e, AdmissionRejected):
                    code = 422
                elif isinstance(e, ValueError):
                    code = 400
                elif isinstance(e, KeyError) or (
                        isinstance(e, ServiceError)
                        and not isinstance(e, SwapError)
                        and "unknown" in str(e).lower()):
                    code = 404
                else:
                    code = 409
                self._reply(code, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - endpoint must answer
                logger.exception("control-http: %s %s failed", method,
                                 self.path)
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if handled is None:
                self._reply(404, {"error": f"no route {method} {self.path}"})
            else:
                self._reply(200, handled)

        # -- routing ---------------------------------------------------------
        def _route(self, method: str, parts) -> Optional[dict]:
            m = manager
            if parts == ["healthz"] and method == "GET":
                return {"ok": True, "services": len(m.services())}
            if parts == ["flight"] and method == "GET":
                params = self._query_params()
                try:
                    last = int(params.get("last", 256))
                except ValueError:
                    raise ValueError(f"last={params['last']!r} not an int")
                after = params.get("after")
                try:
                    after = None if after is None else int(after)
                except ValueError:
                    raise ValueError(f"after={after!r} not an int")
                # pid identifies THIS process's recorder epoch: a fleet
                # scraper that sees it change knows the seq space (and
                # its cursor) restarted with a respawned replica
                return {"pid": os.getpid(),
                        "events": obs_flight.dump(
                            last=last, pipeline=params.get("pipeline"),
                            category=params.get("category"), after=after)}
            if parts == ["profile"] and method == "GET":
                from .. import aot
                from ..obs import profile as obs_profile
                from ..obs import slo as obs_slo
                from ..runtime import placement
                from . import autoscaler as svc_autoscaler

                out = {"profile": obs_profile.snapshot(),
                       "slo": obs_slo.status_all(),
                       "placement": placement.snapshot_all(),
                       "autoscale": svc_autoscaler.snapshot_all(),
                       # AOT compile-cache counters + artifact inventory
                       "aot": aot.snapshot()}
                if self._query_params().get("raw") in ("1", "true"):
                    # the fleet-scrape contract: raw digest buckets +
                    # windowed cells + the mono→wall clock offset, so a
                    # DIFFERENT process can merge exactly (obs/fleet.py)
                    out["raw"] = obs_profile.export_state()
                return out
            if parts == ["spans"] and method == "GET":
                from ..obs import context as obs_context

                params = self._query_params()
                last = params.get("last")
                try:
                    last = None if last is None else int(last)
                except ValueError:
                    raise ValueError(f"last={last!r} not an int")
                return obs_context.export_spans(
                    trace_id=params.get("trace"), last=last)
            if parts == ["fleet"] and method == "GET":
                from ..obs import fleet as obs_fleet

                return {"fleet": obs_fleet.snapshot_all()}
            if parts == ["fleet", "flight"] and method == "GET":
                from ..obs import fleet as obs_fleet

                params = self._query_params()
                v = obs_fleet.view(params.get("name"))
                if v is None:
                    raise KeyError(
                        f"no live fleet view"
                        + (f" named '{params['name']}'"
                           if params.get("name") else ""))
                try:
                    last = int(params.get("last", 256))
                    after = params.get("after")
                    after = None if after is None else int(after)
                except ValueError as e:
                    raise ValueError(f"bad fleet/flight params: {e}")
                return {"fleet": v.name,
                        "events": v.flight(
                            last=last, after=after,
                            category=params.get("category"),
                            pipeline=params.get("pipeline"))}
            if parts == ["memory"] and method == "GET":
                from ..obs import memory as obs_memory

                return {"memory": obs_memory.snapshot()}
            if parts == ["transport"] and method == "GET":
                from ..transport import stats as wire_stats

                # the data-plane block: negotiated wire formats, frame/
                # byte tallies, shm ring traffic (docs/transport.md)
                return {"transport": wire_stats.snapshot()}
            if parts == ["quality"] and method == "GET":
                from ..obs import quality as obs_quality

                out = {"quality": obs_quality.snapshot()}
                if self._query_params().get("raw") in ("1", "true"):
                    out.update(obs_quality.export_state())
                return out
            if parts == ["services"]:
                if method == "GET":
                    return {"services": m.list()}
                if method == "POST":
                    return self._register(self._body())
            if len(parts) == 2 and parts[0] == "services":
                name = parts[1]
                if method == "GET":
                    return m.status(name)
                if method == "DELETE":
                    m.unregister(name)
                    return {"unregistered": name}
            if len(parts) == 3 and parts[0] == "services":
                name, verb = parts[1], parts[2]
                if method == "POST" and verb == "start":
                    svc = m.start(name, wait=bool(
                        self._body().get("wait", True)))
                    return {"name": name, "state": svc.state.value}
                if method == "POST" and verb == "stop":
                    return {"name": name, "state": m.stop(name).state.value}
                if method == "POST" and verb == "drain":
                    timeout = float(self._body().get("timeout_s", 30.0))
                    svc = m.drain(name, timeout_s=timeout)
                    return {"name": name, "state": svc.state.value}
            if parts == ["models"] and method == "GET":
                return {"slots": {n: m.models.info(n)
                                  for n in m.models.names()}}
            if len(parts) == 3 and parts[0] == "models" and method == "POST":
                slot, verb = parts[1], parts[2]
                body = self._body()
                if verb == "swap":
                    return m.models.swap(slot, str(body["version"]))
                if verb == "canary":
                    return m.models.canary(
                        slot, str(body["version"]),
                        float(body["fraction"]),
                        quality_gate=body.get("quality_gate"))
                if verb == "promote":
                    return m.models.promote_canary(slot)
                if verb == "cancel":
                    return m.models.cancel_canary(slot)
            return None

        def _register(self, body: dict) -> dict:
            policy = None
            if "restart" in body:
                policy = RestartPolicy.from_config(body["restart"])
            svc = manager.register(
                body["name"], body.get("launch"),
                pbtxt=body.get("pbtxt"),
                restart=policy,
                watchdog_s=float(body.get("watchdog_s", 0.0)),
                warmup=body.get("warmup", "first-buffer"),
                warmup_timeout_s=float(body.get("warmup_timeout_s", 30.0)),
                lint=body.get("lint", "error"),
                description=body.get("description", ""),
                autostart=bool(body.get("autostart", False)))
            return {"name": svc.name, "state": svc.state.value}

        def do_GET(self):     # noqa: N802 - BaseHTTPRequestHandler API
            if self.path.split("?")[0] == "/metrics":
                self._reply_metrics()
                return
            self._dispatch("GET")

        def do_POST(self):    # noqa: N802
            self._dispatch("POST")

        def do_DELETE(self):  # noqa: N802
            self._dispatch("DELETE")

    return Handler


# -- client ------------------------------------------------------------------

class ControlClient:
    """Thin urllib client for the endpoint (used by the CLI verbs).

    GET routes retry: a control endpoint restarting with its replica
    (subprocess replicas — docs/autoscaling.md) can reset a connection
    mid-read, and a health/metrics poll must ride that window out
    instead of reporting a live replica dead. Retries are BOUNDED
    (``retries``, default 2 re-attempts with a short doubling pause) and
    idempotent-only: POST/DELETE never retry — a verb that may have
    executed must not run twice."""

    #: transient transport failures a GET may retry through: connection
    #: refused/reset (URLError wraps ConnectionError/OSError) and an
    #: HTTP response that died mid-read (IncompleteRead,
    #: RemoteDisconnected — http.client exceptions)
    _RETRY_PAUSE_S = 0.1

    def __init__(self, endpoint: str, timeout: float = 60.0,
                 retries: int = 2):
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout
        self.retries = max(0, int(retries))

    def _call(self, method: str, path: str, body: Optional[dict] = None,
              timeout: Optional[float] = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        attempts = 1 + (self.retries if method == "GET" else 0)
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            if attempt:
                time.sleep(self._RETRY_PAUSE_S * (2 ** (attempt - 1)))
            req = urllib.request.Request(
                self.endpoint + path, data=data, method=method,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=timeout or self.timeout) as resp:
                    return json.loads(resp.read().decode() or "{}")
            except urllib.error.HTTPError as e:
                # the server ANSWERED: a definitive verdict, never retried
                try:
                    payload = json.loads(e.read().decode() or "{}")
                except Exception:  # noqa: BLE001
                    payload = {}
                raise ServiceError(
                    payload.get("error", f"HTTP {e.code} from {path}")) from e
            except (urllib.error.URLError, OSError,
                    http.client.HTTPException) as e:
                last = e
                continue
        # connection refused / reset / socket timeout beyond the retry
        # budget: typed, so the CLI reports it instead of a traceback
        raise ServiceError(
            f"control endpoint unreachable ({method} {path}"
            f"{f', {attempts} attempts' if attempts > 1 else ''}): "
            f"{getattr(last, 'reason', last)}") from last

    # verbs
    def healthz(self) -> dict:
        return self._call("GET", "/healthz")

    def metrics_text(self) -> str:
        """GET /metrics — raw Prometheus text (not JSON). Retries like
        every other GET: a scrape must survive a replica restart window."""
        last: Optional[BaseException] = None
        for attempt in range(1 + self.retries):
            if attempt:
                time.sleep(self._RETRY_PAUSE_S * (2 ** (attempt - 1)))
            req = urllib.request.Request(self.endpoint + "/metrics")
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as resp:
                    return resp.read().decode()
            except urllib.error.HTTPError as e:
                # the server ANSWERED (HTTPError is a URLError subclass
                # — catch it FIRST): definitive, never retried
                raise ServiceError(
                    f"HTTP {e.code} from /metrics") from e
            except (urllib.error.URLError, OSError,
                    http.client.HTTPException) as e:
                last = e
                continue
        raise ServiceError(
            f"control endpoint unreachable (GET /metrics): "
            f"{getattr(last, 'reason', last)}") from last

    def flight(self, last: int = 256,
               pipeline: Optional[str] = None,
               category: Optional[str] = None,
               after: Optional[int] = None) -> dict:
        """Flight-recorder tail; ``pipeline`` filters on the event's
        pipeline tag, ``category`` on the event kind, ``after`` keeps
        only events past a seq cursor (parity with
        ``flight.dump(pipeline=, category=, after=)`` — the
        ``obs flight --follow`` / fleet-scrape cursor)."""
        from urllib.parse import quote

        path = f"/flight?last={int(last)}"
        if pipeline is not None:
            path += f"&pipeline={quote(pipeline)}"
        if category is not None:
            path += f"&category={quote(category)}"
        if after is not None:
            path += f"&after={int(after)}"
        return self._call("GET", path)

    def profile(self, raw: bool = False) -> dict:
        """GET /profile — profiler snapshot + SLO status; ``raw=True``
        adds the raw digest export the fleet scraper merges."""
        return self._call("GET", "/profile?raw=1" if raw else "/profile")

    def spans(self, trace: Optional[str] = None,
              last: Optional[int] = None) -> dict:
        """GET /spans — the process's finished spans, wall-clock
        annotated for cross-process stitching (obs/fleet.py)."""
        from urllib.parse import quote

        params = []
        if trace is not None:
            params.append(f"trace={quote(trace)}")
        if last is not None:
            params.append(f"last={int(last)}")
        return self._call("GET",
                          "/spans" + ("?" + "&".join(params)
                                      if params else ""))

    def fleet(self) -> dict:
        """GET /fleet — snapshots of every live fleet view."""
        return self._call("GET", "/fleet")

    def fleet_flight(self, last: int = 256,
                     after: Optional[int] = None,
                     name: Optional[str] = None,
                     category: Optional[str] = None,
                     pipeline: Optional[str] = None) -> dict:
        """GET /fleet/flight — the fleet-MERGED event stream with its
        own cursor (``obs flight --follow --fleet``)."""
        from urllib.parse import quote

        path = f"/fleet/flight?last={int(last)}"
        if after is not None:
            path += f"&after={int(after)}"
        if name is not None:
            path += f"&name={quote(name)}"
        if category is not None:
            path += f"&category={quote(category)}"
        if pipeline is not None:
            path += f"&pipeline={quote(pipeline)}"
        return self._call("GET", path)

    def memory(self) -> dict:
        """GET /memory — the device-memory accounting snapshot."""
        return self._call("GET", "/memory")

    def transport(self) -> dict:
        """GET /transport — the data-plane snapshot: negotiated wire
        formats, per-format frame/byte tallies, shm ring traffic."""
        return self._call("GET", "/transport")

    def quality(self, raw: bool = False) -> dict:
        """GET /quality — the data-plane quality snapshot (per-edge
        tensor health, baseline stages, drift scores); ``raw=True``
        adds the serialized cells the fleet merge folds additively."""
        return self._call("GET", "/quality?raw=1" if raw else "/quality")

    def list(self) -> dict:
        return self._call("GET", "/services")

    def status(self, name: str) -> dict:
        return self._call("GET", f"/services/{name}")

    def register(self, **body) -> dict:
        return self._call("POST", "/services", body)

    def start(self, name: str, wait: bool = True) -> dict:
        return self._call("POST", f"/services/{name}/start", {"wait": wait})

    def stop(self, name: str) -> dict:
        return self._call("POST", f"/services/{name}/stop", {})

    def drain(self, name: str, timeout_s: float = 30.0) -> dict:
        # the server blocks until the drain finishes — the HTTP read must
        # outlive the server-side timeout it asked for
        return self._call("POST", f"/services/{name}/drain",
                          {"timeout_s": timeout_s},
                          timeout=max(self.timeout, timeout_s + 15.0))

    def unregister(self, name: str) -> dict:
        return self._call("DELETE", f"/services/{name}")

    def models(self) -> dict:
        return self._call("GET", "/models")

    def swap(self, slot: str, version: str) -> dict:
        return self._call("POST", f"/models/{slot}/swap",
                          {"version": version})

    def canary(self, slot: str, version: str, fraction: float,
               quality_gate=None) -> dict:
        body = {"version": version, "fraction": fraction}
        if quality_gate is not None:
            body["quality_gate"] = quality_gate
        return self._call("POST", f"/models/{slot}/canary", body)

    def promote(self, slot: str) -> dict:
        return self._call("POST", f"/models/{slot}/promote", {})

    def cancel_canary(self, slot: str) -> dict:
        return self._call("POST", f"/models/{slot}/cancel", {})
